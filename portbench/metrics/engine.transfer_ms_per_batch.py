"""engine.transfer_ms_per_batch: the self time of ``engine.stage`` (the
pinned staging buffer filled, the H2D copy started) and ``engine.fetch``
(the D2H copy started) per batch (counter ``engine.batches``), in
milliseconds."""


def read(run: dict):
    spans = run.get("spans", {})
    n = run.get("counters", {}).get("engine.batches")
    parts = [spans[s]["self_s"] for s in ("engine.stage", "engine.fetch")
             if s in spans]
    if not parts or not n:
        return None
    return 1000.0 * sum(parts) / n
