"""On a CUDA card: each kernel of ``rappas_tpu_torch/csrc`` against its
plain PyTorch version.  Skips where no card is present (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it also runs where JAX is not
installed:

    RAPPAS_TPU_DEVICE_TESTS=1 python -m pytest -m cuda tests/test_torch_card.py

(``RAPPAS_TPU_DEVICE_TESTS=1`` keeps ``tests/conftest.py`` from importing
JAX.)  Tolerances as in ``chip_smoke.py``: accumulators within 1e-5
relative (summation order), the wire words exactly, the ambiguity pass
within 2e-4 (atomic add order).
"""

import numpy as np
import pytest
import torch

from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import pack_reads, window_offsets


def _codes(rng, B, L, k, amb=0.0):
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
    codes[rng.random((B, L)) < amb] = -1
    codes[np.arange(L)[None, :] >= lens[:, None]] = -2
    return codes, lens


def _table(rng, n_rows, E, fill):
    D = np.where(rng.random((n_rows, E)) < fill,
                 rng.random((n_rows, E)) * 2.5 + 1e-3, 0).astype(np.float32)
    D[-1] = 0
    return D


def _amb_spec(rng, n_rows, n_win, B, max_w=4):
    W = rng.integers(1, max_w + 1, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    alt_rows = rng.integers(0, n_rows, alt_win.size).astype(np.int32)
    alt_rows[::5] = n_rows - 1
    win_read = np.sort(rng.integers(0, B, n_win)).astype(np.int32)
    return alt_rows, alt_win, win_read, (1.0 / W).astype(np.float32)



@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card):
    rng = np.random.default_rng(21)
    k, E, L, B = 8, 300, 150, 512
    D = torch.from_numpy(_table(rng, 4 ** k + 1, E, 0.02)).to(card)
    codes, lens = _codes(rng, B, L, k, amb=0.002)
    c, ln = torch.from_numpy(codes).to(card), torch.from_numpy(lens).to(card)
    rows = T.kmer_rows(c, k, 4, D.shape[0])
    got = T.accumulate_codes(D, c, k, 4)
    assert torch.allclose(got, T.accumulate(D, rows), rtol=1e-5, atol=1e-5)
    pure, plens = _codes(rng, B, L, k)
    p = torch.from_numpy(pack_reads(pure)).to(card)
    pl = torch.from_numpy(plens).to(card)
    got_p = T.accumulate_packed(D, p, pl, L, k)
    want_p = T.accumulate(D, T.kmer_rows_packed(p, pl, k, 4, D.shape[0], L))
    assert torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    thr = float(np.float32(-4.1))
    wire = T.finalize_wire(got_p, pl, thr, k, 7)
    assert torch.equal(wire, T.pack_wire(*T.finalize(
        got_p, pl, torch.tensor(np.float32(thr)), k, 7)))
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, D.shape[0], 40, B)
    is_mean = (rng.random(40) < 0.5)
    spec = [torch.from_numpy(x).to(card) for x in (
        alt_rows, window_offsets(alt_win, 40), win_read, inv_w,
        is_mean.astype(np.uint8))]
    acc = T.ambiguous_pass_(got.clone(), D, 1.0, *spec)
    want = T.ambiguous_pass(T.alt_delta_rows(D, 1.0, spec[0]),
                            torch.from_numpy(alt_win).to(card), spec[2],
                            spec[3], spec[4], got)
    torch.cuda.synchronize()
    assert torch.allclose(acc, want, atol=2e-4, rtol=0)
