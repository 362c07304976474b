"""pipeline.device_wait_pct: the share of the window in ``engine.sync``:
the main thread blocked on a batch's CUDA event, the device's work and
the D2H copy not yet done."""


def read(run: dict):
    s = run.get("spans", {}).get("engine.sync")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["total_s"] / run["window_s"]
