"""pipeline.call_edges_pct: the share of the window in the self time of
``place.start`` and ``place.finish``: each call's writer, batcher,
threads and files made, the threads joined and the jplace written."""


def read(run: dict):
    spans = run.get("spans", {})
    parts = [spans[n]["self_s"] for n in ("place.start", "place.finish")
             if n in spans]
    if not parts or not run.get("window_s"):
        return None
    return 100.0 * sum(parts) / run["window_s"]
