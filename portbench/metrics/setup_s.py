"""setup_s: process start to the first timed sample (imports, CUDA
start, kernel library load, DB made, saved and loaded, engine made,
sample files written, one warm-up sample)."""


def read(run: dict):
    return run.get("setup_s")
