"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the window is profiled and they are its
per-layer metrics.  Standard output ends with one JSON line (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown`` (with ``idle_by_span`` beside the contract's two lists),
and last ``checks``: each number that decided ``correct``
with its limit); standard error ends with the same numbers.  No CUDA
card, fewer cards than the cell asks for, or JAX or the JAX package
loaded when the window has closed: a message, no result line, and a
non-zero exit.  Every file goes under a directory of ``TMPDIR``, removed
at the end.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: top-level module names that the run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "rappas_tpu", "bench", "chip_smoke",
             "scripts")


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "-i", "0",
                            "--query-gpu=power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metrics_of(entries: list, run: dict) -> dict:
    from portbench.cell import HERE, load_module
    out = {}
    for m in entries:
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "portbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None, engine_wrap=None) -> int:
    """One run; ``engine_wrap`` (``spin.py``) wraps the engine the
    window drives."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)

    from portbench import cell as cellmod
    spec = cellmod.load_spec(args.workload)
    chips = spec["cell"]["chips"]

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    with tempfile.TemporaryDirectory(prefix="portbench_", dir=base) as wd:
        run = cellmod.run(spec, args.seed, args.seconds, bool(args.trace),
                          Path(wd), T_START, engine_wrap=engine_wrap)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct, rows = cellmod.verdict(run["numbers"], spec["limits"],
                                    run["failure"])
    entries = spec["per_layer"] if args.trace else spec["end_to_end"]
    result = {
        "correct": correct,
        "attempted": run["calls"],
        "failed": run["failed"],
        "metrics": metrics_of(entries, run),
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": run["memory_peak_bytes"],
                   "power_limit": power_limit()},
    }
    tr = run.get("trace")
    if tr:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in tr["device_ops"]],
            "idle_gaps": tr["idle_gaps"],
            "idle_by_span": tr["idle_by_span"]}
        print("trace: " + json.dumps({
            "idle_s": tr["idle_s"],
            "lost_kernel_records": tr["lost_kernel_records"],
            "kernel_events": tr["kernel_events"],
            "kernel_s": tr["kernel_s"],
            "busy_s_per_device": tr["busy_s_per_device"]}))
    if "spans" in run:
        print("spans: " + json.dumps({k: run[k] for k in (
            "setup_spans", "spans", "counters")}))
    print("run: " + json.dumps({
        k: run.get(k) for k in ("table", "setup_s", "setup_stages",
                                "window_s", "cpu", "host", "reads",
                                "failure", "work_bytes", "work_ops")}))
    if run["durations"]:
        d = sorted(run["durations"])
        print("durations: " + json.dumps(
            {"n": len(d), "min": d[0], "p50": d[len(d) // 2],
             "p90": d[int(len(d) * 0.9)], "max": d[-1]}))
        print("calls: " + json.dumps(
            {"file": run["call_files"],
             "d": [round(x, 6) for x in run["durations"]]}))
    print("numbers: " + json.dumps(run["numbers"]))
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    print(json.dumps(result))
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
