"""engine.host_ms_per_batch: mean wall time inside the engine's
``score_async`` per batch (the pipeline's prep thread)."""


def read(run: dict):
    if not run.get("batches"):
        return None
    return 1000.0 * run["score_async_s"] / run["batches"]
