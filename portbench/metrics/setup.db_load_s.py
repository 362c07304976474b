"""setup.db_load_s: the program's span ``db.load`` (``PhyloKmerDB.load``)
in set-up, in seconds; read in a traced run, where the spans are on."""


def read(run: dict):
    s = run.get("setup_spans", {}).get("db.load")
    return s["total_s"] if s else None
