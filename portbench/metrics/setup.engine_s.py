"""setup.engine_s: the harness's clock around ``cli._make_engine``,
ended by a synchronise of every card."""


def read(run: dict):
    return run.get("engine_s")
