"""pipeline.prep_wait_pct: the share of the window that the main thread
spends in ``place.prep_wait``, waiting on the prep thread's future (the
engine's ``score_async`` of a batch)."""


def read(run: dict):
    s = run.get("spans", {}).get("place.prep_wait")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["total_s"] / run["window_s"]
