"""pipeline.reads_per_s: every read of the samples completed in the
window, duplicates and unplaced reads included, over the window's
seconds: the cell's throughput, which the pipeline's host work paces."""


def read(run: dict):
    return run["reads"] / run["window_s"] if run.get("window_s") else None
