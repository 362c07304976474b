"""Score calibration: a noise floor from random sequences.

The reference ships this feature broken: ``processCalibration`` ends in
``throw new UnsupportedOperationException()``
(``core/algos/PlacementProcess.java:354``, dead since the Guava
Quantiles removal) and is off by default.  This is a working
implementation of the intent: score a large sample of random reads
(gaussian length around the mean read length, seed 1, mirroring
``RandomSeqGenerator.java:43-53``) against the DB and take a high
quantile of their best scores as a lower bound -- placements scoring
below it are indistinguishable from noise and filtered like ``--nsbound``
(``PlacementProcess.java:937``).

The reads come from the same numpy generator, drawn in the same order,
as ``rappas_tpu.build.calibration`` draws them, so both packages score
the same reads (padded past their lengths, which JAX's direct table
ignores, so the bound is JAX's in every layout).  They are clean ACGT
(or amino) reads: on the layout ``table="auto"`` picks for the DB
(compact for the usual DNA DB: C1 then K3; on a direct table the packed
row sum K1, then K3), on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import time

import numpy as np

from rappas_tpu_torch.db import PhyloKmerDB

#: reference protocol (Main_DBBUILD_3.java:174-181): 1M samples, 99th of
#: 100-quantiles; amino runs 10x the samples at length/3
DEFAULT_SAMPLES = 1_000_000
DEFAULT_MEAN_LEN = 150
DEFAULT_QUANTILE = 0.99

#: the last :func:`calibrate`'s reads, seconds (engine set-up, read
#: generation and scoring), table layout and batch size
LAST_RUN: dict = {}


def calibrate(db: PhyloKmerDB, n_samples: int | None = None,
              mean_length: int | None = None,
              quantile: float = DEFAULT_QUANTILE, seed: int = 1,
              batch_size: int = 8192, engine=None,
              device="cuda") -> float:
    """Return the calibrated best-score noise bound (also stored in
    ``db.meta['calibration_ns_bound']``).

    Defaults follow the reference protocol exactly
    (``Main_DBBUILD_3.java:174-181``): 1M random reads of mean length
    150 for DNA; 10M reads of mean length 50 for amino.  Tests pass a
    small ``n_samples`` explicitly.  The reads are scored by ``engine``,
    else by a ``PlacementEngine`` on ``device`` that ignores
    ambiguities.
    """
    from rappas_tpu_torch.place.engine import PlacementEngine

    t0 = time.perf_counter()
    if n_samples is None:
        n_samples = DEFAULT_SAMPLES if db.alphabet.name == "nucl" \
            else DEFAULT_SAMPLES * 10
    if mean_length is None:
        mean_length = DEFAULT_MEAN_LEN if db.alphabet.name == "nucl" \
            else DEFAULT_MEAN_LEN // 3
    engine = engine or PlacementEngine(db, treat_ambiguities=False,
                                       device=device)
    rng = np.random.default_rng(seed)
    best: list[np.ndarray] = []
    n_done = 0
    while n_done < n_samples:
        b = min(batch_size, n_samples - n_done)
        res = engine.score(*calibration_reads(db, rng, b, mean_length))
        placed = res.n_matched > 0
        if placed.any():
            best.append(res.top_scores[placed, 0])
        n_done += b
    if not best:
        bound = float("-inf")
    else:
        bound = float(np.quantile(np.concatenate(best), quantile))
    db.meta["calibration_ns_bound"] = bound
    LAST_RUN.update(reads=n_done, seconds=time.perf_counter() - t0,
                    table=engine.table, batch_size=batch_size)
    return bound


def calibration_reads(db: PhyloKmerDB, rng, n: int, mean_length: int):
    """``n`` random reads of :func:`calibrate`, drawn from ``rng``: ASCII
    ``uint8[n, L_max]`` (``L_max = mean + 5 sd``, sd a tenth of the mean:
    225 letters at the DNA default) and their gaussian lengths, at least
    k.  Past its length a read is padded with 0xFF, as the engine's
    batches are: the letters drawn there are never scored, in any
    layout (the direct table's kernels read a read's length, the compact
    and postings layouts its codes)."""
    sd = mean_length * 0.1
    L_max = int(mean_length + 5 * sd)
    letters = np.frombuffer(db.alphabet.letters.encode(), np.uint8)
    lens = np.clip(np.rint(rng.normal(mean_length, sd, n)),
                   db.k, L_max).astype(np.int32)
    mat = letters[rng.integers(0, db.alphabet.n_states,
                               (n, L_max))].astype(np.uint8)
    mat[np.arange(L_max)[None, :] >= lens[:, None]] = 0xFF
    return mat, lens
