"""pipeline.dedup_pct: the share of the window in ``place.dedup``'s self
time: each block's dedup, its duplicates' paths and the batching, less
the ``place.prep_wait`` and ``place.fold`` of the batches it drains."""


def read(run: dict):
    s = run.get("spans", {}).get("place.dedup")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["self_s"] / run["window_s"]
