"""pipeline.engine_wait_pct: the share of the window that the pipeline's
main thread spends in the program's span ``place.result_wait`` (blocked
in the engine handles' ``result()``, the device's sync and the unpack
included).  Low means the pipeline's own host work sets the pace."""


def read(run: dict):
    s = run.get("spans", {}).get("place.result_wait")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["total_s"] / run["window_s"]
