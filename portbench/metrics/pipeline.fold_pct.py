"""pipeline.fold_pct: the share of the window in ``place.fold``'s self
time: folding each scored batch into the writer, the not-placed log and
the TSV, the per-read loop over queued duplicates included, less
``place.result_wait``."""


def read(run: dict):
    s = run.get("spans", {}).get("place.fold")
    if s is None or not run.get("window_s"):
        return None
    return 100.0 * s["self_s"] / run["window_s"]
