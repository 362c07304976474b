"""Inputs shared by the port's CPU tests (``test_torch_kernels.py``) and
its card tests (``test_torch_card.py``); numpy only, so that the card's
machine, which has no JAX, imports it too."""

import numpy as np


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
