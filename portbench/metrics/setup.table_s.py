"""setup.table_s: the program's span ``engine.table`` (the engine's
tables built on the device, closed by a synchronise) in set-up, in
seconds; read in a traced run, where the spans are on."""


def read(run: dict):
    s = run.get("setup_spans", {}).get("engine.table")
    return s["total_s"] if s else None
