"""The readings that a cell's limits are set from, many seeds in one
process (the set-up of a process and of the kernels is paid once):

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 4 --control none|u16|bf16 [--json-out F]

``none``: the program as the configuration states it, a short window at
the cell's own load, judged as a run judges it.  ``u16``: the same with
the program's own lower-precision path (``--precision u16``) switched
on.  ``bf16``: the reference put in the program's place with its deltas
stored in bfloat16, judged against the float64 reference on the same
samples a run would check.  One JSON line per seed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def bf16_numbers(spec: dict, seed: int) -> dict:
    import numpy as np

    from portbench import cell, reference, traffic
    config, mix = spec["config"], spec["mix"]
    recipe = cell.load_module(cell.HERE / "recipes" /
                              f"{config['recipe']}.py", "recipe")
    raw = recipe.make(config, seed)
    args = (config["k"], config["omega"], raw["codes"], raw["edges"],
            raw["scores"], config["n_edge_slots"])
    ref = reference.Reference(*args)
    ctl = reference.Reference(*args, store="bf16")
    pool = traffic.make_pool(mix, seed)
    rng = np.random.default_rng([seed, 3])
    picked = rng.choice(len(pool), min(mix["check_calls"], len(pool)),
                        replace=False)
    parts = [reference.compare(ref, pool[s],
                               *reference.control_outputs(ctl, pool[s]))
             for s in picked.tolist()]
    return reference.merge_numbers(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", choices=["none", "u16", "bf16"],
                   default="none")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    from portbench import cell
    spec = cell.load_spec(args.workload)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        if args.control == "bf16":
            row = {"numbers": bf16_numbers(spec, seed)}
        else:
            base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
            with tempfile.TemporaryDirectory(prefix="portbench_",
                                             dir=base) as wd:
                run = cell.run(spec, seed, args.seconds, False, Path(wd),
                               t0, precision="u16" if args.control == "u16"
                               else None)
            row = {k: run.get(k) for k in ("table", "reads", "window_s",
                                            "failure", "numbers")}
        row.update(workload=args.workload, seed=seed, control=args.control,
                   seconds=time.time() - t0)
        rows.append(row)
        print("reading: " + json.dumps(row), flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json_out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
