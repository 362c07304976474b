"""engine.scratch_read_pct: of the reads P3 scored in the window, the
share whose postings it sorted in the global scratch because they pass
one block's shared memory (the program's counter
``engine.p3_reads_scratch`` over it plus ``engine.p3_reads_warp`` and
``engine.p3_reads_block``, made from P3's plan at each launch)."""

PATHS = ("engine.p3_reads_warp", "engine.p3_reads_block",
         "engine.p3_reads_scratch")


def read(run: dict):
    c = run.get("counters") or {}
    total = sum(c.get(n, 0) for n in PATHS)
    if not total:
        return None
    return 100.0 * c.get("engine.p3_reads_scratch", 0) / total
