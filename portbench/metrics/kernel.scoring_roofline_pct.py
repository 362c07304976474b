"""kernel.scoring_roofline_pct: the least time the card could take for
the window's scoring work (``portbench.roofline``: the larger of bytes
over 3.35 TB/s and operations over 67 TFLOP/s f32) over the summed
device time of the kernels in the window's trace, as a percentage."""

from portbench import roofline


def read(run: dict):
    t = run.get("trace")
    if not t or t["kernel_s"] <= 0 or "work_bytes" not in run:
        return None
    return 100.0 * roofline.least_seconds(
        run["work_bytes"], run["work_ops"]) / t["kernel_s"]
