#!/usr/bin/env python3
"""What one ``rappas_tpu_torch.utils.span`` costs the thread that opens
it: off (the default), on, and on inside a ``torch.profiler`` session
that records the host and the card, as a window of the benchmark's
traced run does.

    python3 scripts/span_cost.py [--n 200000] [--reps 5]

Each case times ``--reps`` loops of ``--n`` empty spans (one name, as
the program's are fixed) and reports the least and the median µs per
span, with an empty loop's time taken away.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def loop_us(n: int, body) -> float:
    t0 = time.perf_counter()
    body(n)
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    from rappas_tpu_torch import utils
    span = utils.span

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span("place.fold"):
                pass

    def timed(body, n):
        base = [loop_us(n, empty) for _ in range(args.reps)]
        runs = [loop_us(n, body) - statistics.median(base)
                for _ in range(args.reps)]
        return {"min_us": min(runs), "median_us": statistics.median(runs),
                "n": n, "reps": args.reps}

    out = {}
    utils.tracing(False)
    out["off"] = timed(spans, args.n)
    utils.tracing(True)
    out["on"] = timed(spans, args.n // 10)
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        out["device"] = torch.cuda.get_device_name(0)
    with profile(activities=acts, record_shapes=False, with_stack=False):
        out["on_profiled"] = timed(spans, args.n // 10)
    utils.tracing(False)
    utils.trace_reset()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
