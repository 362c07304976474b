"""kernel.postings_roofline_pct: the least time P3's work in the window
could take over P3's device time in the window's trace
(``finalize_postings_kernel`` and ``finalize_postings_warp_kernel``), as
a percentage.  The least time is the larger of the bytes over 3.35 TB/s
and the operations over 67 TFLOP/s (``portbench.roofline``'s peaks).

The work is counted from the program's counters of P3's launches
(traced runs): the bytes by :func:`p3_bytes`, the operations by
:func:`p3_ops`."""

import math

from portbench import cell, roofline

#: P3's device operations (``csrc/postings.cu``): the block path and the
#: warp path
P3_OPS = ("finalize_postings_kernel", "finalize_postings_warp_kernel")
#: candidates a read sends back: the CLI's ``--keep-at-most`` default,
#: with which every cell places
KEEP_AT_MOST = 7
#: the edge slots from which a light row's edge ids and the wire's are
#: int32 (``rappas_tpu_torch.db.WIDE_EDGES``); u16 below
WIDE_EDGES = 65535
PATHS = ("engine.p3_reads_warp", "engine.p3_reads_block",
         "engine.p3_reads_scratch")


def edge_id_bytes(n_edge_slots: int) -> int:
    return 2 if n_edge_slots < WIDE_EDGES else 4


def p3_bytes(counters: dict, edge_bytes: int) -> int:
    """Each distinct light row a batch reads, once, at its real postings
    (an edge id and an f32 delta each: ``engine.p3_row_postings``), each
    read's row list in (int32 row ids, ``engine.p3_row_slots``), and the
    wire out (``KEEP_AT_MOST`` f32 scores and edge ids a read)."""
    reads = sum(counters.get(n, 0) for n in PATHS)
    return (counters["engine.p3_row_postings"] * (edge_bytes + 4) +
            counters.get("engine.p3_row_slots", 0) * 4 +
            reads * KEEP_AT_MOST * (4 + edge_bytes))


def p3_ops(counters: dict) -> float:
    """The sort's n log2 n over the reads, bounded below from the totals:
    P log2(P / reads) for P real light postings (``engine.p3_postings``)
    over the reads (x log x is convex); 0 where no read has two."""
    P = counters.get("engine.p3_postings", 0)
    reads = sum(counters.get(n, 0) for n in PATHS)
    if not reads or P <= reads:
        return 0.0
    return P * math.log2(P / reads)


def p3_seconds(trace: dict) -> float:
    return sum(s for name, s in trace["device_ops"]
               if any(op in name for op in P3_OPS))


def read(run: dict):
    t = run.get("trace")
    c = run.get("counters") or {}
    if not t or "engine.p3_row_postings" not in c:
        return None
    s = p3_seconds(t)
    if s <= 0:
        return None
    config = cell.load_spec(run["cell"])["config"]
    least = roofline.least_seconds(
        p3_bytes(c, edge_id_bytes(config["n_edge_slots"])), p3_ops(c))
    return 100.0 * least / s
