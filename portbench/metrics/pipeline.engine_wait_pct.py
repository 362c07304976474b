"""pipeline.engine_wait_pct: the share of the window that the pipeline's
main thread spends blocked in the engine handles' ``result()``.  Low
means the pipeline's own host work sets the pace."""


def read(run: dict):
    if not run.get("window_s"):
        return None
    return 100.0 * run["wait_s"] / run["window_s"]
