"""The ``torch.profiler`` trace of the measured window, and what the
per-layer metrics read from it.

The profiler starts when the window opens and stops when it closes; the
harness marks the window with a ``portbench.window`` span and reads only
what lies inside it.  The arithmetic is ``chip_smoke.read_trace``'s: a
card's busy time is the union of its kernel, memcpy and memset
intervals; a launch record of the runtime (``cudaLaunchKernel``) whose
kernel record the trace lacks is a lost record, and where records were
lost the busy time is a lower bound.  The card's idle time is split by
the innermost program span open on ``place.call``'s thread (the
program's spans are on in a traced run; the harness's own,
``portbench.*``, are not counted), and ``harness`` where none is open.
"""

from __future__ import annotations

import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the program's span that the main thread's other spans nest in
CALL_SPAN = "place.call"
#: the name of idle time in which no program span is open
HARNESS = "harness"


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


def innermost(spans) -> list:
    """``[(start, end, name)]`` of one thread's nested spans, cut into
    pieces in time order, each named by the innermost span open over it.
    A child that ends past its parent (clock rounding) is cut at the
    parent's end."""
    pieces, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= a:
            end, n = stack.pop()
            if end > t:
                pieces.append((t, end, n))
                t = end
        if stack:
            if a > t:
                pieces.append((t, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        t = a
        stack.append((b, name))
    while stack:
        end, n = stack.pop()
        if end > t:
            pieces.append((t, end, n))
            t = end
    return pieces


def split_gaps(gaps, pieces) -> list:
    """For each ``(start, end)`` of ``gaps`` (sorted, disjoint), its
    seconds by the name of each of ``pieces`` (sorted, disjoint) that
    overlaps it, the rest under ``HARNESS``."""
    out, j = [], 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        by: dict = {}
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                by[pieces[k][2]] = by.get(pieces[k][2], 0.0) + hi - lo
            k += 1
        rest = (b - a) - sum(by.values())
        if rest > 0:
            by[HARNESS] = by.get(HARNESS, 0.0) + rest
        out.append(by)
    return out


def read_trace(path: Path, n_devices: int) -> dict:
    """The window's device time from an exported chrome trace: per card
    busy seconds, the idle share, the kernels' summed time, lost records,
    the device operations that took most time, the idle seconds by the
    program span they fell in (``idle_by_span``, ten largest, the mean
    over the cards) and the longest idle gaps, each named by the span
    that holds most of it."""
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
    calls = [e for e in events if e.get("name") == CALL_SPAN]
    tid = calls[0].get("tid") if calls else None
    pieces = innermost(
        [iv + (e["name"],) for e in events
         if e.get("cat") == "user_annotation" and e.get("tid") == tid and
         not e["name"].startswith("portbench.") and
         (iv := clip(e)) is not None])
    busy, gaps, idle_by = {}, [], {}
    used = range(n_devices)
    for dev in used:
        merged = _merge(per_dev.get(dev, []))
        busy[dev] = sum(b - a for a, b in merged)
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        for (a, b), by in zip(idle, split_gaps(idle, pieces)):
            gaps.append((b - a, max(by, key=by.get)))
            for n, us in by.items():
                idle_by[n] = idle_by.get(n, 0.0) + us / n_devices
    gaps.sort(key=lambda g: -g[0])
    idle_gaps = [[n, g / 1e6] for g, n in gaps[:10]]

    def correlations(pred):
        return {e.get("args", {}).get("correlation") for e in events
                if pred(e) and clip(e) is not None}
    launched = correlations(lambda e: e.get("cat") == "cuda_runtime" and
                            "LaunchKernel" in e.get("name", ""))
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "kernel"}
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
        "idle_by_span": [[n, us / 1e6] for n, us in
                         sorted(idle_by.items(), key=lambda x: -x[1])[:10]],
        "idle_s": sum(idle_by.values()) / 1e6,
    }
