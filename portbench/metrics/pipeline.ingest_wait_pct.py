"""pipeline.ingest_wait_pct: the share of the window that the main thread
spends in ``place.ingest_wait``, waiting for the reader thread's next
parsed and hashed block."""


def read(run: dict):
    s = run.get("spans", {}).get("place.ingest_wait")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["total_s"] / run["window_s"]
