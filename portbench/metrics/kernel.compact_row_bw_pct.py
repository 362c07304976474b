"""kernel.compact_row_bw_pct: the bytes of the distinct compact-table
rows that each batch's C1 launch reads (the program's counter
``engine.c1_row_bytes``, counted in a traced run) over the summed device
time of C1's kernels in the window's trace (``accumulate_kernel`` and its
resolve pass ``resolve_rows_kernel``), as a share of the card's HBM
bandwidth (3.35 TB/s)."""

from portbench import roofline

#: C1's device operations (``csrc/accumulate.cu``)
C1_OPS = ("accumulate_kernel", "resolve_rows_kernel")


def read(run: dict):
    t = run.get("trace")
    n = run.get("counters", {}).get("engine.c1_row_bytes")
    if not t or not n:
        return None
    s = sum(sec for name, sec in t["device_ops"]
            if any(op in name for op in C1_OPS))
    if s <= 0:
        return None
    return 100.0 * n / s / roofline.HBM_BYTES_PER_S
