"""Cells of BENCHMARK.json cut to a size a CPU test run holds: the same
recipes, mixes, limits and code paths, fewer keys, edges and reads."""

from __future__ import annotations

import time
from pathlib import Path

from portbench import cell

#: per configuration, the sizes a CPU test holds
CONFIG = {
    "c1-16s-k8": {"k": 6, "n_edge_slots": 40},
}
MIX = {"reads_per_sample": 200, "pool": 3, "check_calls": 2}
CELLS = ("c1-16s-k8.miseq240",)
#: the generator's other knobs (reads cut short, one N), which the
#: cells' mixes may leave at 0, so that tests still drive the reference's
#: and the engine's ambiguity paths
HARDER = {"short_share": 0.05, "short_min_share": 0.8,
          "ambiguous_share": 0.05}


def spec(name: str, **mix) -> dict:
    s = cell.load_spec(name)
    s["config"].update(CONFIG[s["cell"]["config"]])
    s["mix"].update(MIX, **mix)
    return s


def run(name: str, tmp: Path, seed: int = 7, mix=None, **kw) -> dict:
    return cell.run(spec(name, **(mix or {})), seed, 0.5, False, tmp,
                    time.time(), device="cpu", **kw)
