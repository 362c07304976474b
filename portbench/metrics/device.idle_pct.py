"""device.idle_pct: 1 - the union of kernel, memcpy and memset intervals
over the profiled window (the measured window only), as a percentage;
the mean over the cards the cell uses."""


def read(run: dict):
    t = run.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * t["idle_share"]
