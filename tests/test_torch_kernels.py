"""The kernels' plain PyTorch versions against the JAX functions they port
(``rappas_tpu/place/engine.py``), and the wrappers' CPU path against the
plain compositions (``tests/test_torch_card.py`` holds the kernels
against the plain versions on a card).

Tolerances: row ids and the wire words exactly; ``accumulate`` within
1e-5 relative (the summation order differs); ``finalize`` edges and
``|L|`` exactly, scores within 2e-4 and LWR within 1e-4
(``tests/test_engine.py:41-60``); the ambiguity pass within 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rappas_tpu.place import engine as J
from rappas_tpu_torch.db import DELTA_TINY
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import pack_reads, window_offsets


def _codes(rng, B, L, k, n_states=4, amb=0.0, short=True):
    """int8 codes [B, L] with PAD_CODE (-2) past each length, a share
    ``amb`` of AMBIG_CODE (-1) positions, and the lengths."""
    codes = rng.integers(0, n_states, (B, L)).astype(np.int8)
    lens = (rng.integers(max(k - 2, 1), L + 1, B) if short
            else np.full(B, L)).astype(np.int32)
    codes[rng.random((B, L)) < amb] = -1
    codes[np.arange(L)[None, :] >= lens[:, None]] = -2
    return codes, lens


def _table(rng, n_rows, E, fill=0.3):
    D = np.where(rng.random((n_rows, E)) < fill,
                 rng.random((n_rows, E)) * 2.5 + 1e-3, 0).astype(np.float32)
    D[-1] = 0
    return D


@pytest.mark.parametrize("k, n_states, L", [(5, 4, 40), (8, 4, 150),
                                            (3, 20, 25)])
def test_kmer_rows_matches_jax(k, n_states, L):
    rng = np.random.default_rng(k)
    codes, _ = _codes(rng, 37, L, k, n_states, amb=0.02)
    n_rows = n_states ** k + 1
    want = np.asarray(J.kmer_rows(jnp.asarray(codes), k, n_states, n_rows))
    got = T.kmer_rows(torch.from_numpy(codes), k, n_states, n_rows)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k, L", [(5, 40), (8, 150), (8, 33)])
def test_kmer_rows_packed_matches_jax(k, L):
    rng = np.random.default_rng(L)
    codes, lens = _codes(rng, 41, L, k)
    packed = pack_reads(codes)
    n_rows = 4 ** k + 1
    want = np.asarray(J.kmer_rows_packed(jnp.asarray(packed),
                                         jnp.asarray(lens), k, 4, n_rows,
                                         L))
    got = T.kmer_rows_packed(torch.from_numpy(packed),
                             torch.from_numpy(lens), k, 4, n_rows, L)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # pure reads: the packed and the int8 row streams are one stream
    assert np.array_equal(
        got.numpy(), T.kmer_rows(torch.from_numpy(codes), k, 4,
                                 n_rows).numpy())


@pytest.mark.parametrize("E", [6, 300])
def test_accumulate_matches_jax(E):
    rng = np.random.default_rng(E)
    k = 5
    D = _table(rng, 4 ** k + 1, E)
    codes, _ = _codes(rng, 24, 60, k, amb=0.01)
    rows = T.kmer_rows(torch.from_numpy(codes), k, 4, D.shape[0])
    want = np.asarray(J.accumulate(jnp.asarray(D), jnp.asarray(rows.numpy())))
    got = T.accumulate(torch.from_numpy(D), rows).numpy()
    assert np.allclose(got, want, rtol=1e-5, atol=0)
    assert np.array_equal(got > 0, want > 0)


def _acc(rng, B, E, fill=0.4, ties=True):
    acc = np.where(rng.random((B, E)) < fill, rng.random((B, E)) * 9,
                   0).astype(np.float32)
    if ties:      # exact ties: top-K must keep the lower edge first
        acc[:, E // 2] = acc[:, 1] = np.where(acc[:, 1] > 0, acc[:, 1], 3.0)
    acc[0] = 0                      # an unplaced read
    acc[1, :] = 0
    acc[1, 2] = DELTA_TINY          # matched only at threshold
    return acc


@pytest.mark.parametrize("E, keep", [(6, 7), (6, 4), (300, 7), (300, 8)])
def test_finalize_matches_jax(E, keep):
    rng = np.random.default_rng(E + keep)
    B, k = 33, 8
    acc = _acc(rng, B, E)
    lens = rng.integers(k, 150, B).astype(np.int32)
    thr = np.float32(-3.5)
    je, js, jl, jn = (np.asarray(x) for x in J.finalize(
        jnp.asarray(acc), jnp.asarray(lens), jnp.float32(thr), k, keep))
    te, ts, tl, tn = (x.numpy() for x in T.finalize(
        torch.from_numpy(acc), torch.from_numpy(lens),
        torch.tensor(thr), k, keep))
    assert np.array_equal(te, je) and np.array_equal(tn, jn)
    assert te.dtype == np.int32 and tn.dtype == np.int32
    fin = np.isfinite(js)
    assert np.array_equal(np.isfinite(ts), fin)
    assert np.allclose(ts[fin], js[fin], atol=2e-4, rtol=0)
    assert np.allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("K", [1, 4, 7])
def test_pack_wire_matches_jax(K):
    rng = np.random.default_rng(K)
    B = 19
    te = rng.integers(-1, 400, (B, K)).astype(np.int32)
    ts = rng.normal(size=(B, K)).astype(np.float32)
    ts[te < 0] = -np.inf
    lwr = rng.random((B, K)).astype(np.float32)
    nm = rng.integers(0, 400, B).astype(np.int32)
    want = np.asarray(J.pack_wire(*(jnp.asarray(x)
                                    for x in (te, ts, lwr, nm))))
    got = T.pack_wire(*(torch.from_numpy(x) for x in (te, ts, lwr, nm)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _amb_spec(rng, n_rows, n_win, B, max_w=4):
    W = rng.integers(1, max_w + 1, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    alt_rows = rng.integers(0, n_rows, alt_win.size).astype(np.int32)
    alt_rows[::5] = n_rows - 1                  # misses: the zero row
    win_read = np.sort(rng.integers(0, B, n_win)).astype(np.int32)
    inv_w = (1.0 / W).astype(np.float32)
    return alt_rows, alt_win, win_read, inv_w


@pytest.mark.parametrize("mean", [True, False])
def test_ambiguity_plain_versions_match_jax(mean):
    rng = np.random.default_rng(11)
    E, B, n_rows = 30, 9, 200
    D = _table(rng, n_rows, E, fill=0.2)
    D[3, 4] = DELTA_TINY                         # threshold-grade hit
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, n_rows, 25, B)
    alt_rows[0] = 3
    is_mean = np.full(25, mean)
    acc = _acc(rng, B, E, ties=False)
    scale = np.float32(1)
    j_rows = np.asarray(J.alt_delta_rows(jnp.asarray(D), jnp.float32(1),
                                         jnp.asarray(alt_rows)))
    t_rows = T.alt_delta_rows(torch.from_numpy(D), float(scale),
                              torch.from_numpy(alt_rows))
    assert np.array_equal(t_rows.numpy(), j_rows)
    args_t = [torch.from_numpy(x) for x in (alt_win, inv_w, is_mean)]
    jc = np.asarray(J.ambiguous_contrib(
        jnp.asarray(j_rows), *(jnp.asarray(x)
                               for x in (alt_win, inv_w, is_mean))))
    tc = T.ambiguous_contrib(t_rows, *args_t).numpy()
    assert np.allclose(tc, jc, atol=2e-4, rtol=0)
    assert np.array_equal(tc > 0, jc > 0)       # DELTA_TINY floor kept
    assert tc[0, 4] > 0
    jp = np.asarray(J.ambiguous_pass(
        jnp.asarray(j_rows), jnp.asarray(alt_win), jnp.asarray(win_read),
        jnp.asarray(inv_w), jnp.asarray(is_mean), jnp.asarray(acc)))
    tp = T.ambiguous_pass(t_rows, torch.from_numpy(alt_win),
                          torch.from_numpy(win_read), args_t[1],
                          args_t[2], torch.from_numpy(acc)).numpy()
    assert np.allclose(tp, jp, atol=2e-4, rtol=0)
    assert np.array_equal(tp > 0, jp > 0)


# ---------------------------------------------------------------------- #
# fused wrappers on CPU tensors == the plain compositions

def test_accumulate_wrappers_cpu_match_plain():
    rng = np.random.default_rng(5)
    k, E, L, B = 5, 12, 30, 20
    D = torch.from_numpy(_table(rng, 4 ** k + 1, E))
    codes, lens = _codes(rng, B, L, k, amb=0.03)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lens)
    want = T.accumulate(D, T.kmer_rows(c, k, 4, D.shape[0]))
    assert torch.equal(T.accumulate_codes(D, c, k, 4), want)
    pure, plens = _codes(rng, B, L, k)
    p = torch.from_numpy(pack_reads(pure))
    pl = torch.from_numpy(plens)
    want_p = T.accumulate(D, T.kmer_rows_packed(p, pl, k, 4, D.shape[0], L))
    assert torch.equal(T.accumulate_packed(D, p, pl, L, k), want_p)
    # both into one accumulator through their destination rows
    acc = torch.full((2 * B, E), float("nan"))
    dest_p = torch.arange(0, 2 * B, 2, dtype=torch.int32)
    dest_c = torch.arange(1, 2 * B, 2, dtype=torch.int32)
    T.accumulate_packed(D, p, pl, L, k, acc=acc, dest=dest_p)
    T.accumulate_codes(D, c, k, 4, acc=acc, dest=dest_c)
    assert torch.equal(acc[0::2], want_p) and torch.equal(acc[1::2], want)
    assert T.LAUNCHES == {name: 0 for name in T.LAUNCHES}


@pytest.mark.parametrize("keep", [4, 7])
def test_finalize_wire_cpu_round_trip(keep):
    from rappas_tpu_torch.place.engine import unpack_wire
    rng = np.random.default_rng(keep)
    acc = torch.from_numpy(_acc(rng, 17, 40))
    lens = torch.from_numpy(rng.integers(8, 150, 17).astype(np.int32))
    thr = float(np.float32(-3.25))
    wire = T.finalize_wire(acc, lens, thr, 8, keep)
    te, ts, lwr, nm = T.finalize(acc, lens, torch.tensor(np.float32(thr)),
                                 8, keep)
    assert torch.equal(wire, T.pack_wire(te, ts, lwr, nm))
    res = unpack_wire(wire.numpy(), keep)
    assert np.array_equal(res.top_edges, te.numpy())
    assert np.array_equal(res.top_scores.view(np.uint32),
                          ts.numpy().view(np.uint32))
    assert np.array_equal(res.n_matched, nm.numpy())
    assert np.allclose(res.top_lwr, lwr.numpy(), atol=1e-6)


def test_ambiguous_pass_wrapper_cpu_in_place():
    rng = np.random.default_rng(13)
    E, B, n_rows = 16, 7, 90
    D = torch.from_numpy(_table(rng, n_rows, E))
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, n_rows, 12, B)
    is_mean = (rng.random(12) < 0.5)
    acc0 = torch.from_numpy(_acc(rng, B, E, ties=False))
    want = T.ambiguous_pass(
        T.alt_delta_rows(D, 1.0, torch.from_numpy(alt_rows)),
        torch.from_numpy(alt_win), torch.from_numpy(win_read),
        torch.from_numpy(inv_w), torch.from_numpy(is_mean), acc0)
    acc = acc0.clone()
    out = T.ambiguous_pass_(
        acc, D, 1.0, torch.from_numpy(alt_rows),
        torch.from_numpy(window_offsets(alt_win, 12)),
        torch.from_numpy(win_read), torch.from_numpy(inv_w),
        torch.from_numpy(is_mean.astype(np.uint8)))
    assert out is acc
    assert torch.equal(acc, want)


def test_window_offsets():
    assert window_offsets(np.array([0, 0, 1, 3, 3, 3], np.int32),
                          4).tolist() == [0, 2, 3, 3, 6]
    with pytest.raises(ValueError, match="ascending"):
        window_offsets(np.array([0, 1, 0], np.int32), 2)


def test_wrappers_refuse_other_devices():
    D = torch.zeros((5, 3), device="meta")
    codes = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        T.accumulate_codes(D, codes, 2, 2)
    with pytest.raises(ValueError, match="tensors on"):
        T.finalize_wire(torch.zeros((2, 3)),
                        torch.zeros(2, dtype=torch.int32, device="meta"),
                        0.0, 2, 2)
