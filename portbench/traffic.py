"""The one generator of sample files: reads drawn from a traffic mix's
parameters (``traffic/<mix>.json``) and the seed.

Each sample holds ``reads_per_sample`` reads, a ``duplicate_share`` of
them copies of an earlier read.  Among the distinct reads every count is
fixed by the mix (the share cut short, or carrying one N) and the lengths
are evenly spaced over their range, so every seed makes the same scoring
work in another order.  The letters are uniform ACGT, as ``chip_smoke.random_reads``
draws them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.reference import Sample


def _spaced(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """``n`` integers evenly spaced over ``[lo, hi]``, shuffled."""
    v = np.rint(np.linspace(lo, hi, n)).astype(np.int64) if n else \
        np.zeros(0, np.int64)
    rng.shuffle(v)
    return v


def make_sample(mix: dict, rng, tag: str) -> Sample:
    n = mix["reads_per_sample"]
    n_dup = int(round(mix.get("duplicate_share", 0.0) * n))
    u = n - n_dup                       # distinct reads
    length = mix["length"]
    lens = (_spaced(length["min"], length["max"], u, rng)
            if "min" in length else np.full(u, length["value"], np.int64))
    n_short = int(round(mix.get("short_share", 0.0) * u))
    if n_short:
        short = rng.choice(u, n_short, replace=False)
        lo = mix["short_min_share"]
        lens[short] = np.floor(lens[short] * _spaced(
            int(lo * 1000), 999, n_short, rng) / 1000).astype(np.int64)
    L = int(lens.max())
    mat = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (u, L))]
    n_amb = int(round(mix.get("ambiguous_share", 0.0) * u))
    amb = rng.choice(u, n_amb, replace=False)
    mat[amb, (rng.random(n_amb) * lens[amb]).astype(np.int64)] = ord("N")
    distinct = [mat[i, :lens[i]].tobytes() for i in range(u)]
    # duplicates at random places after the first read, each a copy of
    # a distinct read placed before it
    is_dup = np.zeros(n, bool)
    is_dup[rng.choice(np.arange(1, n), n_dup, replace=False)] = True
    seen = np.cumsum(~is_dup)           # distinct reads up to each place
    src = (rng.random(n) * np.maximum(seen - is_dup, 1)).astype(np.int64)
    seqs, j = [], 0
    for i in range(n):
        if is_dup[i]:
            seqs.append(distinct[src[i]])
        else:
            seqs.append(distinct[j])
            j += 1
    headers = [f"{tag}_r{i} sample={tag}" for i in range(n)]
    return Sample(headers, seqs)


def make_pool(mix: dict, seed: int) -> list:
    """The ``pool`` samples of one run (seeded apart from the DB's draws)."""
    rng = np.random.default_rng([seed, 1])
    return [make_sample(mix, rng, f"s{i}") for i in range(mix["pool"])]


def write_fasta(sample: Sample, path: Path) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(b">" + h.encode() + b"\n" + s + b"\n"
                         for h, s in zip(sample.headers, sample.seqs)))


def call_order(n_pool: int, seed: int):
    """The pool's samples in the order the window places them: a fresh
    permutation from the seed for each pass."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from rng.permutation(n_pool).tolist()
