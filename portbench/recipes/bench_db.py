"""DB recipe: every k-mer of a share ``occupancy`` of the 4^k present,
each with ``postings_per_key`` postings on uniform edges, scores uniform
in ``(thr, thr + delta_max]``, on a star tree of ``n_edge_slots - 1``
leaves.  The draws are those of ``bench.py:60-84``."""

from __future__ import annotations

import numpy as np

from portbench.reference import rappas_threshold


def make(config: dict, seed: int) -> dict:
    k, E = config["k"], config["n_edge_slots"]
    rng = np.random.default_rng(seed)
    thr = rappas_threshold(k, config["omega"], 4)
    n_keys = int(4 ** k * config["occupancy"])
    codes = rng.choice(4 ** k, size=n_keys, replace=False).astype(np.int64)
    codes = np.repeat(codes, config["postings_per_key"])
    edges = rng.integers(1, E, codes.size).astype(np.int32)
    scores = (thr + rng.random(codes.size) * config["delta_max"]
              ).astype(np.float32)
    return {"codes": codes, "edges": edges, "scores": scores}
