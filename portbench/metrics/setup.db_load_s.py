"""setup.db_load_s: the harness's clock around ``PhyloKmerDB.load``."""


def read(run: dict):
    return run.get("db_load_s")
