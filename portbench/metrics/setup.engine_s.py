"""setup.engine_s: the program's span ``engine.init``
(``PlacementEngine.__init__``: the table's layout, conversion and
upload, the kernel library's load) in set-up, in seconds; read in a
traced run, where the spans are on."""


def read(run: dict):
    s = run.get("setup_spans", {}).get("engine.init")
    return s["total_s"] if s else None
