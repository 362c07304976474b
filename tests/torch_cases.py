"""Inputs shared by the port's CPU tests (``test_torch_kernels.py``,
``test_torch_merge_gather.py``) and its card tests
(``test_torch_card.py``); numpy and the port only, no JAX, so that the
card's machine, which has no JAX, imports it too."""

import numpy as np
import torch

from rappas_tpu_torch.place import kernels as T


def k3_rows(rng, B, E, qthr_scale):
    """acc f32[B, E] for K3 (``finalize_wire``) at three densities
    (config 1's rows match about 3/4 of their columns), a row with no
    match, a row matched everywhere, and in every third row pairs of the
    row's best values one f32 ulp apart with the larger at the higher
    edge: under |Q * thr| ~ qthr_scale both round to one S, which must go
    to the lower edge first (a ranking by acc would put the higher edge
    first)."""
    fill = rng.choice([0.05, 0.75, 1.0], B)[:, None]
    acc = np.where(rng.random((B, E)) < fill, rng.random((B, E)) * 9 + 1e-3,
                   0).astype(np.float32)
    acc[0] = 0
    acc[1] = rng.random(E).astype(np.float32) + np.float32(0.5)
    ulp = np.spacing(np.float32(qthr_scale))
    for b in range(2, B, 3):
        cols = np.sort(rng.choice(E, min(E, 6), replace=False))
        for j in range(0, len(cols) - 1, 2):
            x = np.float32(20.0 + 2 * ulp * j)
            acc[b, cols[j]] = x
            acc[b, cols[j + 1]] = np.nextafter(x, np.float32(99))
    return acc


def shard_wires(rng, mp, B, K, E, wide=False):
    """M1's input: ``mp`` candidate wires int32[mp, B, words] as P3 writes
    them on edge-range shards -- K scores on a 0.25 grid (exact ties
    across shards and within one), descending with -inf tails; distinct
    global edges of the shard's range (``E // mp >= K``), -1 where the
    score is -inf; |L| per shard.  Where B allows: read 1 has no
    candidate; read 2 ties every candidate; read 3 has a finite score
    whose edge is "none" (shard 0, slot 0, the read's best score); the
    last shard could not sort read 4 (|L| = -1); shard 0's list of read 5
    is ascending (M1 assumes no order)."""
    bounds = np.linspace(0, E, mp + 1).astype(np.int64)
    ts = -np.sort(-(rng.integers(0, 16, (mp, B, K)) * 0.25 - 30.0)
                  .astype(np.float32), axis=2)
    n_valid = rng.integers(0, K + 1, (mp, B))
    ts[np.arange(K) >= n_valid[..., None]] = -np.inf
    # K distinct edges per row: one from each of K strides of the range
    stride = (np.diff(bounds) // K)[:, None, None]
    te = bounds[:-1, None, None] + np.arange(K) * stride + \
        rng.integers(0, 1 << 30, (mp, B, K)) % stride
    te = rng.permuted(te, axis=2)
    nm = n_valid + rng.integers(0, 5, (mp, B))
    if B > 1:
        ts[:, 1] = -np.inf
    if B > 2:
        ts[:, 2] = np.float32(-29.0)
    te = np.where(np.isfinite(ts), te, -1)
    if B > 3:
        ts[0, 3, 0], te[0, 3, 0] = -20.0, -1
    if B > 4:
        nm[-1, 4] = -1
    if B > 5:
        ts[0, 5], te[0, 5] = ts[0, 5, ::-1].copy(), te[0, 5, ::-1].copy()
    return torch.stack([T.pack_wire(
        torch.from_numpy(te[j].astype(np.int32)), torch.from_numpy(ts[j]),
        torch.zeros(B, K), torch.from_numpy(nm[j].astype(np.int32)),
        wide=wide) for j in range(mp)])
