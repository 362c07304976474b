"""The ``torch.profiler`` trace of the measured window, and what the
per-layer metrics read from it.

The profiler starts when the window opens and stops when it closes; the
harness marks the window with a ``portbench.window`` span and reads only
what lies inside it.  The arithmetic is ``chip_smoke.read_trace``'s: a
card's busy time is the union of its kernel, memcpy and memset
intervals; a launch record of the runtime (``cudaLaunchKernel``) whose
kernel record the trace lacks is a lost record, and where records were
lost the busy time is a lower bound.
"""

from __future__ import annotations

import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's host spans, the innermost first, by which an idle gap of
#: the card is named
HOST_SPANS = ("portbench.result_wait", "portbench.score_async",
              "portbench.place_queries")


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read_trace(path: Path, n_devices: int) -> dict:
    """The window's device time from an exported chrome trace: per card
    busy seconds, the idle share, the kernels' summed time, lost records,
    the device operations that took most time and the longest idle gaps
    by the host span they fell in."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == "portbench.window"]
    if len(marks) != 1:
        raise ValueError(f"{path}: {len(marks)} window marks")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])

    def clip(e):
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        return (a, b) if b > a else None

    per_dev: dict = {d: [] for d in range(n_devices)}
    ops: dict = {}
    kernel_us = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        iv = clip(e)
        if iv is None:
            continue
        dev = int(e.get("args", {}).get("device", 0))
        per_dev.setdefault(dev, []).append(iv)
        ops[e["name"]] = ops.get(e["name"], 0.0) + iv[1] - iv[0]
        if e["cat"] == "kernel":
            kernel_us += iv[1] - iv[0]
    window_us = t1 - t0
    busy, gaps = {}, []
    for dev, ivs in per_dev.items():
        merged = _merge(ivs)
        busy[dev] = sum(b - a for a, b in merged)
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        gaps += [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                 for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    spans = {n: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("name") == n] for n in HOST_SPANS}

    def host_at(t):
        for n in HOST_SPANS:
            if any(a <= t <= b for a, b in spans[n]):
                return n.split(".", 1)[1]
        return "between_calls"

    gaps.sort(reverse=True)
    idle_gaps = [[host_at((a + b) / 2), g / 1e6] for g, a, b in gaps[:10]]

    def correlations(pred):
        return {e.get("args", {}).get("correlation") for e in events
                if pred(e) and clip(e) is not None}
    launched = correlations(lambda e: e.get("cat") == "cuda_runtime" and
                            "LaunchKernel" in e.get("name", ""))
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "kernel"}
    used = range(n_devices)
    busy_s = sum(busy.get(d, 0.0) for d in used) / n_devices / 1e6
    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_s,
        "busy_s_per_device": [busy.get(d, 0.0) / 1e6 for d in used],
        "idle_share": 1 - busy_s / (window_us / 1e6),
        "kernel_s": kernel_us / 1e6,
        "kernel_events": sum(1 for e in events if e.get("cat") == "kernel"),
        "lost_kernel_records": len(launched - recorded),
        "device_ops": [[n, s / 1e6] for n, s in
                       sorted(ops.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": idle_gaps,
    }
