"""engine.host_ms_per_batch: the program's span ``engine.score_async``
(the pipeline's prep thread: encode, inputs, staging, launch, D2H
start), its window total over its count, in milliseconds."""


def read(run: dict):
    s = run.get("spans", {}).get("engine.score_async")
    return 1000.0 * s["total_s"] / s["count"] if s else None
