"""One cell's traffic mix swept over values of its keys: for each value,
a ``portbench`` run of the cell (set-up, warm-up and a traced window, as
``portbench/run.py --trace 1`` makes it) with that one key of the mix
changed and the others at the cell's own, its calls not judged.  Prints
one line a run,

    sweep: {"key": ..., "value": ..., "device_mem_gib": ...,
            "p3_ms_per_batch": ..., "batches": ..., "metrics": {...}}

with every per-layer metric the cell's traced line would report, so that
the metrics a share of the mix moves can be read off.  On the card:

    python3 scripts/traffic_sweep.py --workload <cell> --seed <n> \\
        --seconds 15 --set duplicate_share=0.3,0.5,0.7 \\
        --set reads_per_sample=2000,4000,8000
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--set", action="append", required=True,
                   help="KEY=V1,V2,...: the mix's KEY at each value")
    args = p.parse_args()

    import torch

    from portbench import cell, reference, roofline, run

    # no judge: the reference is neither built nor compared with
    cell.judge_calls = lambda *a: {}
    reference.Reference = lambda *a: None
    roofline.batch_work = lambda *a: (0, 0)
    p3 = cell.load_module(cell.HERE / "metrics" /
                          "kernel.postings_roofline_pct.py", "sweep_p3")
    spec = cell.load_spec(args.workload)
    for item in args.set:
        key, values = item.split("=")
        for v in values.split(","):
            mix = dict(spec["mix"])
            mix[key] = type(mix[key])(float(v))
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory(prefix="sweep_") as wd:
                out = cell.run(dict(spec, mix=mix), args.seed, args.seconds,
                               True, Path(wd), time.time())
            out.pop("work_bytes")       # counted by the reference
            batches = out["spans"].get("engine.inputs", {}).get("count", 0)
            print("sweep: " + json.dumps({
                "key": key, "value": mix[key], "failure": out["failure"],
                "device_mem_gib": out["memory_peak_bytes"] / 2 ** 30,
                "setup_s": out["setup_s"], "window_s": out["window_s"],
                "reads": out["reads"], "batches": batches,
                "p3_ms_per_batch": (1e3 * p3.p3_seconds(out["trace"]) /
                                    batches if batches else None),
                "metrics": {n: v["value"] for n, v in run.metrics_of(
                    spec["per_layer"], out).items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
