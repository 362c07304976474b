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
from rappas_tpu_torch import utils
from rappas_tpu_torch.db import DELTA_TINY
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import pack_reads, window_offsets
from torch_cases import LIGHT_OPS, k3_rows, light_case, light_op


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
    assert not any(n.startswith("kernel.launch.")
                   for n in utils.trace_totals()["counters"])


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


# ---------------------------------------------------------------------- #
# postings layout: P1-P3's plain versions against the JAX functions

def _pairs(rng, nl, P, E, fill=0.6, tiny=False):
    """A light table int32[nl + 1, 2P]: sorted distinct edges per row,
    pads (LIGHT_PAD_EDGE, 0.0) past each row's count, last row all pads;
    with ``tiny`` some postings sit exactly at threshold (DELTA_TINY)."""
    pad = int(T.LIGHT_PAD_EDGE)
    edges = np.full((nl + 1, P), pad, np.int32)
    deltas = np.zeros((nl + 1, P), np.float32)
    for r in range(nl):
        n = int(rng.integers(1, P + 1)) if rng.random() < fill else 1
        edges[r, :n] = np.sort(rng.choice(E, n, replace=False))
        deltas[r, :n] = rng.random(n) * 2.5 + 1e-3
    if tiny:
        deltas[:nl:7, 0] = DELTA_TINY
    return np.concatenate([edges, deltas.view(np.int32)], axis=1)


def _dense_sources(rng, B, E, n_src, ties=False):
    """Dense rows [n_src, E] with their reads (ascending) and slots."""
    rows = np.where(rng.random((n_src, E)) < 0.2,
                    rng.random((n_src, E)) * 3, 0).astype(np.float32)
    reads = np.sort(rng.choice(B, n_src)).astype(np.int32)
    uniq = np.unique(reads)
    slots = np.searchsorted(uniq, reads).astype(np.int32)
    if ties and n_src:
        rows[:, 3] = rows[:, 5] = 2.0       # exact dense ties
    return rows, reads, slots, uniq.astype(np.int32)


def _jax_postings(pairs, lrows, rows, reads, slots, uniq, lens, thr, k,
                  keep, v2):
    B = lrows.shape[0]
    if v2:
        n_slots = max(1, uniq.size)
        slot_read = np.full(n_slots, B, np.int32)
        slot_read[:uniq.size] = uniq
        if rows.shape[0] == 0:       # one pad source into the zero slot
            rows = np.zeros((1, rows.shape[1]), np.float32)
            reads = np.zeros(1, np.int32)
            slots = np.full(1, n_slots, np.int32)
        out = J.finalize_postings_v2(
            (jnp.asarray(pairs),), jnp.asarray(lrows), None,
            jnp.asarray(rows), jnp.asarray(reads), jnp.asarray(slots),
            jnp.asarray(slot_read), jnp.asarray(lens), jnp.float32(thr), k,
            keep)
    else:
        if rows.shape[0] == 0:
            rows = np.zeros((1, rows.shape[1]), np.float32)
            reads = np.zeros(1, np.int32)
        out = J.finalize_postings(
            jnp.asarray(pairs), jnp.asarray(lrows), jnp.asarray(rows),
            jnp.asarray(reads), jnp.asarray(lens), jnp.float32(thr), k,
            keep, lowrank=False)
    return tuple(np.asarray(x) for x in out)


def _port_postings(pairs, lrows, rows, slots, uniq, lens, thr, k, keep):
    """P3's plain version on ``pairs``, a light table of :func:`_pairs`'s
    int32 edge ids."""
    B = lrows.shape[0]
    acc_c = T.scatter_slots(torch.from_numpy(rows),
                            torch.from_numpy(slots.astype(np.int64)),
                            uniq.size)
    slot_of = np.full(B, -1, np.int32)
    slot_of[uniq] = np.arange(uniq.size, dtype=np.int32)
    args = (torch.from_numpy(pairs), torch.from_numpy(lrows), acc_c,
            torch.from_numpy(slot_of), torch.from_numpy(lens))
    out = T.finalize_postings(*args, torch.tensor(np.float32(thr)), k, keep,
                              layout=T.LightLayout(pairs.shape[1] // 2,
                                                   False))
    return tuple(x.numpy() for x in out), args


def _same_top(t, j):
    te, ts, tl, tn = t
    je, js, jl, jn = j
    assert np.array_equal(tn, jn)
    assert np.array_equal(te, je)       # edge ORDER too, ties included
    fin = np.isfinite(js)
    assert np.array_equal(np.isfinite(ts), fin)
    assert np.allclose(ts[fin], js[fin], atol=2e-4, rtol=0)
    assert np.allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["dense", "no_dense", "ties", "tiny",
                                  "wide", "keep1"])
@pytest.mark.parametrize("v2", [True, False])
def test_finalize_postings_matches_jax(case, v2):
    """P3's plain version against ``finalize_postings`` (per-read dense
    accumulator) and ``finalize_postings_v2`` (slot dense side), one
    light table: with and without dense sources, exact ties between and
    within the light and dense lists, threshold-grade postings, more
    than 65535 edge slots, K=1."""
    rng = np.random.default_rng(len(case) + 7 * v2)
    B, W, P, k = 24, 9, 8, 8
    E = 65601 if case == "wide" else 60
    keep = 1 if case == "keep1" else 7
    pairs = _pairs(rng, 80, P, E, tiny=case == "tiny")
    lrows = rng.integers(0, 81, (B, W)).astype(np.int32)
    lrows[0] = 80                                   # no light hit at all
    n_src = 0 if case == "no_dense" else 14
    rows, reads, slots, uniq = _dense_sources(rng, B, E, n_src,
                                              ties=case == "ties")
    if case == "ties":    # a light total equal to a dense-only value
        pairs[:, P:] = np.float32(1.0).view(np.int32)
        pairs[-1, P:] = 0
        pairs[:, :P][pairs[:, :P] == 3] = 4
    if case == "tiny":    # read 1: one light row, one DELTA_TINY posting
        pairs[0, 1:P] = int(T.LIGHT_PAD_EDGE)
        pairs[0, P + 1:] = 0
        lrows[1] = 80
        lrows[1, 4] = 0
    lens = rng.integers(k, 150, B).astype(np.int32)
    thr = np.float32(-3.75)
    got, _ = _port_postings(pairs, lrows, rows, slots, uniq, lens, thr, k,
                            keep)
    _same_top(got, _jax_postings(pairs, lrows, rows, reads, slots, uniq,
                                 lens, thr, k, keep, v2))
    if case == "tiny" and 1 not in reads:
        assert got[3][1] == 1 and got[0][1, 0] == pairs[0, 0]


def test_finalize_postings_width0_matches_jax_finalize():
    """Width 0 (everything heavy): no light postings at all; the JAX
    engine takes ``finalize`` on the dense accumulator there."""
    rng = np.random.default_rng(3)
    B, E, k = 20, 40, 8
    pairs = np.zeros((1, 0), np.int32)
    lrows = np.zeros((B, 0), np.int32)
    rows, reads, slots, uniq = _dense_sources(rng, B, E, 16, ties=True)
    lens = rng.integers(k, 150, B).astype(np.int32)
    thr = np.float32(-3.5)
    got, _ = _port_postings(pairs, lrows, rows, slots, uniq, lens, thr, k, 7)
    acc = np.zeros((B, E), np.float32)
    np.add.at(acc, reads, rows)
    want = J.finalize(jnp.asarray(acc), jnp.asarray(lens), jnp.float32(thr),
                      k, 7)
    _same_top(got, tuple(np.asarray(x) for x in want))


def test_gather_scatter_matches_jax():
    """P1's plain version: ``gather_rows`` + the slot scatter."""
    rng = np.random.default_rng(4)
    H = _table(rng, 30, 50)
    hrows = rng.integers(0, 30, 40).astype(np.int32)
    slots = np.sort(rng.integers(0, 12, 40)).astype(np.int32)
    g = J.gather_rows(jnp.asarray(H), jnp.asarray(hrows))
    want = np.asarray(jnp.zeros((13, 50), jnp.float32).at[
        jnp.asarray(slots)].add(g))[:12]
    got = T.scatter_slots(T.gather_rows(torch.from_numpy(H),
                                        torch.from_numpy(hrows)),
                          torch.from_numpy(slots.astype(np.int64)), 12)
    assert np.array_equal(np.asarray(g), T.gather_rows(
        torch.from_numpy(H), torch.from_numpy(hrows)).numpy())
    assert np.allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the wrapper (CSR offsets of the slots) on CPU tensors
    hoff = np.zeros(13, np.int32)
    np.cumsum(np.bincount(slots, minlength=12), out=hoff[1:])
    acc_c = T.dense_side(torch.from_numpy(H), torch.from_numpy(hrows),
                         torch.from_numpy(hoff))
    assert torch.equal(acc_c, got)


@pytest.mark.parametrize("mean", [True, False])
def test_ambiguity_postings_plain_versions_match_jax(mean):
    """P2's plain version: alternative rows bitwise equal to
    ``alt_delta_rows_postings``; contributions summed into slots."""
    rng = np.random.default_rng(12 + mean)
    E, P, nl, nh = 45, 8, 60, 10
    pairs = _pairs(rng, nl, P, E, tiny=True)
    H = _table(rng, nh + 1, E)
    n_win = 15
    W = rng.integers(1, 5, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    n_alt = alt_win.size
    light = rng.random(n_alt) < 0.7     # a k-mer is light or heavy
    alt_lrows = np.where(light, rng.integers(0, nl, n_alt), nl)
    alt_hrows = np.where(light, nh, rng.integers(0, nh, n_alt))
    alt_lrows[::6], alt_hrows[::6] = nl, nh            # misses
    alt_lrows, alt_hrows = (x.astype(np.int32) for x in (alt_lrows,
                                                          alt_hrows))
    j_rows = np.asarray(J.alt_delta_rows_postings(
        (jnp.asarray(pairs),), jnp.asarray(H), jnp.asarray(alt_lrows),
        jnp.asarray(alt_hrows)))
    wide = T.LightLayout(P, False)
    t_rows = T.alt_delta_rows_postings(
        torch.from_numpy(pairs), torch.from_numpy(H),
        torch.from_numpy(alt_lrows), torch.from_numpy(alt_hrows),
        layout=wide)
    assert np.array_equal(t_rows.numpy(), j_rows)
    win_slot = np.sort(rng.integers(0, 6, n_win)).astype(np.int32)
    inv_w = (1.0 / W).astype(np.float32)
    is_mean = np.full(n_win, mean)
    jc = np.asarray(J.ambiguous_contrib(
        jnp.asarray(j_rows), jnp.asarray(alt_win), jnp.asarray(inv_w),
        jnp.asarray(is_mean)))
    want = np.zeros((6, E), np.float32)
    np.add.at(want, win_slot, jc)
    acc_c = torch.zeros((6, E))
    out = T.ambiguous_postings_(
        acc_c, torch.from_numpy(H), torch.from_numpy(pairs),
        torch.from_numpy(alt_lrows), torch.from_numpy(alt_hrows),
        torch.from_numpy(window_offsets(alt_win, n_win)),
        torch.from_numpy(win_slot), torch.from_numpy(inv_w),
        torch.from_numpy(is_mean.astype(np.uint8)), layout=wide)
    assert out is acc_c
    assert np.allclose(acc_c.numpy(), want, atol=2e-4, rtol=0)
    assert np.array_equal(acc_c.numpy() > 0, want > 0)


@pytest.mark.parametrize("E", [60, 65601])
def test_finalize_postings_wire_cpu_round_trip(E):
    from rappas_tpu_torch.place.engine import unpack_wire
    rng = np.random.default_rng(E)
    B, k, keep = 16, 8, 7
    pairs = _pairs(rng, 40, 8, E)
    lrows = rng.integers(0, 41, (B, 6)).astype(np.int32)
    rows, _, slots, uniq = _dense_sources(rng, B, E, 9)
    lens = rng.integers(k, 150, B).astype(np.int32)
    thr = float(np.float32(-3.25))
    top, args = _port_postings(pairs, lrows, rows, slots, uniq, lens, thr,
                               k, keep)
    plan = T.postings_plan(np.full(B, 6 * 8), smem_pairs=16, warp_pairs=0)
    assert plan.scratch_off.device.type == "cpu"
    wire = T.finalize_postings_wire(*args, thr, k, keep, plan,
                                    layout=T.LightLayout(8, False))
    _, wide, n_words = T.wire_format(E, keep)
    assert wide == (E >= T.WIDE_EDGES)
    assert wire.shape == (B, n_words)
    res = unpack_wire(wire.numpy(), keep, wide)
    assert np.array_equal(res.top_edges, top[0])
    assert np.array_equal(res.top_scores.view(np.uint32),
                          top[1].view(np.uint32))
    assert np.array_equal(res.n_matched, top[3])
    assert np.allclose(res.top_lwr, top[2], atol=1e-6)
    assert utils.counter("kernel.launch.finalize_postings_wire") == 0
    bad = wire.numpy().copy()
    bad[2, -1] = -1                     # a read P3 could not sort
    with pytest.raises(RuntimeError, match="read 2"):
        unpack_wire(bad, keep, wide)


@pytest.mark.parametrize("op", LIGHT_OPS)
@pytest.mark.parametrize("narrow", [True, False], ids=["u16", "int32"])
@pytest.mark.parametrize("P", [45, 8])
def test_light_readers_on_narrow_and_wide_rows(P, narrow, op):
    """Every reader of a light row (P3 on one table, R1 routed and
    part-select over 3 parts, P3 on G1's compact table, P2, A1 over 3
    parts), its plain version on rows of u16 or int32 edge ids, odd and
    even P: the wire words or the slot accumulator equal the one-table
    P3's or P2's on int32 rows exactly (quarter deltas: every sum
    exact)."""
    case = light_case(P, seed=P)
    ref = light_op("p2" if op in ("p2", "a1") else "p3", case,
                   T.LightLayout(P, False), "cpu")
    got = light_op(op, case, T.LightLayout(P, narrow), "cpu")
    assert torch.equal(got, ref)
    if op in ("p2", "a1"):
        assert bool((got > torch.from_numpy(case["acc_c"])).any())
    else:
        _, _, n_matched = T.wire_fields(got, 7)
        assert bool((n_matched[1:] > 0).all()) and int(n_matched[0]) >= 0


def test_postings_plan():
    plan = T.postings_plan(np.array([0, 3, 100, 40000, 16384, 16385]))
    assert plan.warp_pairs == 128 and plan.smem_pairs == 16384
    assert plan.scratch_off.tolist() == [0, 0, 0, 0, 40000, 40000, 56385]
    assert plan.n_scratch == 56385
    assert plan.block_reads.tolist() == [3, 4, 5]
    assert plan.block_reads.dtype == torch.int32
    assert plan.paths(6) == {"warp": 3, "block": 1, "scratch": 2}
    small = T.postings_plan(np.array([5, 9, 1]))
    assert small == (16, 0, None, 0, None, 15)
    assert plan.postings == 0 + 3 + 100 + 40000 + 16384 + 16385
    every = T.postings_plan(np.array([5, 9]), smem_pairs=0, warp_pairs=0)
    assert every.smem_pairs == 0 and every.scratch_off.tolist() == [0, 5, 14]
    assert every.scratch_off.dtype == torch.int64
    assert every.to("cpu").scratch_off.tolist() == [0, 5, 14]
    assert every.block_reads.tolist() == [0, 1] and every.warp_pairs == -1
    assert small.to("cpu") is small
    assert T.wire_format(60, 7) == (7, False, 12)
    assert T.wire_format(65535, 7) == (7, True, 15)
    assert T.wire_format(3, 7) == (3, False, 6)


@pytest.mark.parametrize("counts, warp_pairs, want", [
    # config 5's reads (mean ~308, at most 663): every read on the warp path
    ([308, 663, 0, 1, 31, 32, 33], T.WARP_PAIRS, (1024, None, None)),
    # the threshold: 1024 postings stay on the warp path, 1025 leave it
    ([1024, 1025, 7], T.WARP_PAIRS, (1024, [1], None)),
    # a smaller warp region; the block path in shared memory and scratch
    ([100, 200, 20000, 3], 128, (128, [1, 2], [0, 0, 0, 20000, 20000])),
    # no warp path: every read on the block path, none in the scratch
    ([0, 5, 300], 0, (-1, [0, 1, 2], None)),
])
def test_postings_plan_warp_block_scratch(counts, warp_pairs, want):
    """The warp/block/scratch split of P3's plan: a read takes the warp
    path when its power-of-two region fits ``warp_pairs`` slots; the rest
    are listed in ``block_reads`` (the block path), the ones past one
    block's shared memory with their scratch regions."""
    plan = T.postings_plan(np.array(counts), warp_pairs=warp_pairs)
    w_cap, reads, off = want
    assert plan.warp_pairs == w_cap
    assert (plan.block_reads is None if reads is None
            else plan.block_reads.tolist() == reads)
    assert (plan.scratch_off is None if off is None
            else plan.scratch_off.tolist() == off)
    paths = plan.paths(len(counts))
    assert sum(paths.values()) == len(counts)
    assert paths["warp"] == len(counts) - len(reads or [])
    # the engine stages the plan's arrays by name and takes them back
    arrays = {n: t.numpy() for n, t in plan.tensors().items()}
    staged = plan.staged({n: torch.from_numpy(a) for n, a in arrays.items()})
    assert staged.warp_pairs == plan.warp_pairs
    for n, t in plan.tensors().items():
        assert torch.equal(getattr(staged, n), t)
    with pytest.raises(ValueError, match="warp path"):
        T.postings_plan(np.array(counts), warp_pairs=2 * T.WARP_PAIRS)


@pytest.mark.parametrize("E, itemsize, n_rows, n_windows, want", [
    # config 1 f32 (79 MB): 4 slabs of 76 columns, 16-byte loads
    (300, 4, 4 ** 8 + 1, 16384 * 143, (4, 76, 4, 13, True)),
    # config 1 u16 (39 MB): 2 slabs, 8-byte loads (rows 600 B apart)
    (300, 2, 4 ** 8 + 1, 16384 * 143, (4, 152, 2, 6, True)),
    # a table that fits L2: one slab
    (300, 4, 10000, 16384 * 143, (4, 300, 1, 3, True)),
    # config 6's 1.2 GB u16 compact table: slabs would be narrower than a
    # 128 B line, so one slab, and no evict_last priority
    (300, 2, 2010001, 16384 * 143, (4, 300, 1, 3, False)),
    # config 2's 1.26 GB f32 direct table, unsplit: the same
    (300, 4, 4 ** 10 + 1, 16384 * 143, (4, 300, 1, 3, False)),
    # config 4 (E=150): 8-byte f32 loads
    (150, 4, 500001, 16384 * 93, (2, 150, 1, 3, False)),
    # edges: one column, an odd width, E past what one block's threads
    # cover (slabs of whole blocks), no windows
    (1, 4, 100, 100, (1, 1, 1, 256, True)),
    (33, 2, 1000, 5000, (1, 33, 1, 7, True)),
    (7999, 4, 1000, 5000, (1, 250, 32, 1, True)),
    (300, 4, 4 ** 8 + 1, 0, (4, 300, 1, 3, True)),
])
def test_slab_plan(E, itemsize, n_rows, n_windows, want):
    """The row sum's slab chooser on counts and shapes: every slab a
    whole number of loads and at most one block of threads wide, the
    slabs covering E, the staged row ids within the shared-memory budget,
    a slab of the rows a batch can touch within the L2 target, and the
    evict_last priority exactly when that slab fits it."""
    plan = T.slab_plan(E, itemsize, n_rows, n_windows)
    assert (plan.vec, plan.cols, plan.n_slabs, plan.reads_per_block,
            plan.keep) == want
    assert E % plan.vec == 0 and plan.vec * itemsize <= 16
    assert plan.cols % plan.vec == 0 or plan.cols == E
    assert (plan.n_slabs - 1) * plan.cols < E <= plan.n_slabs * plan.cols
    chunks = -(-plan.cols // plan.vec)
    assert chunks * plan.reads_per_block <= T.SUM_THREADS
    assert plan.reads_per_block * (plan.tile + 2) <= T.SUM_STAGE_ROWS
    assert plan.args() == (plan.vec, plan.cols, plan.reads_per_block,
                           plan.tile, int(plan.keep))
    slab = min(n_rows, n_windows) * plan.cols * itemsize
    assert plan.keep == (slab <= T.L2_SLAB_BYTES * 1.05)
    if plan.n_slabs > 1 and plan.cols * itemsize >= T.MIN_SLAB_ROW_BYTES:
        assert slab <= T.L2_SLAB_BYTES * 1.05


def test_slab_plan_alignment():
    """A pointer that is not 16-byte aligned narrows the loads: the table
    pointer to its item's multiple, the f32 output to 4 bytes."""
    assert T.slab_plan(300, 4, 100, 100, ((256, 4), (256, 4))).vec == 4
    assert T.slab_plan(300, 4, 100, 100, ((8, 4), (256, 4))).vec == 2
    assert T.slab_plan(300, 4, 100, 100, ((256, 4), (4, 4))).vec == 1
    assert T.slab_plan(304, 2, 100, 100, ((256, 2), (256, 4))).vec == 8
    assert T.slab_plan(304, 2, 100, 100, ((256, 2), (8, 4))).vec == 2


# ---------------------------------------------------------------------- #
# the sparse per-window scoring of P2 / A1 (csrc/ambiguous.cu)

def _vec_unary(fn, x):
    """``fn`` over ``x`` padded to whole 64-value blocks: ATen evaluates a
    float unary op on whole SIMD blocks one way and on a tail another
    (exp2 differs in the last bit), so a value's result must not depend
    on where it sits; ``ambiguous_contrib``'s operands below are whole
    blocks too."""
    n = x.numel()
    pad = torch.zeros(-n % 64, dtype=x.dtype)
    return fn(torch.cat([x.reshape(-1), pad]))[:n].reshape(x.shape)


def _sparse_contrib(pairs, H, alt_lrows, alt_hrows, win_off, inv_w,
                    is_mean, offset=0):
    """[n_win, E] window contributions as the postings kernel scores them:
    per window only the distinct columns its light postings hit (edge -
    offset in [0, E)), every column when an alternative is heavy; per
    column the alternatives' terms in order -- 10^v for an alternative
    that reaches the column (v its heavy value there plus its postings on
    the column in posting order), 1.0 for one that misses -- summed from
    0, the max over the v (0 for a miss), the mean/max choice and the
    DELTA_TINY floor on a hit."""
    P = pairs.shape[1] // 2
    nh, E = H.shape[0] - 1, H.shape[1]
    edges = (pairs[:, :P].to(torch.int64) - offset).tolist()
    deltas = pairs[:, P:].contiguous().view(torch.float32)
    out = torch.zeros((len(win_off) - 1, E))
    for w in range(len(win_off) - 1):
        alts = range(int(win_off[w]), int(win_off[w + 1]))
        cols = []
        for i in alts:
            cols += [e for e in edges[int(alt_lrows[i])]
                     if 0 <= e < E and e not in cols]
        if any(int(alt_hrows[i]) != nh for i in alts):
            cols += [e for e in range(E) if e not in cols]
        if not cols:
            continue
        at = {e: j for j, e in enumerate(cols)}
        vs, reach = [], []
        for i in alts:
            h, lr = int(alt_hrows[i]), int(alt_lrows[i])
            v = (H[h, cols].clone() if h != nh
                 else torch.zeros(len(cols)))
            r = torch.full((len(cols),), h != nh)
            for p, e in enumerate(edges[lr]):
                if 0 <= e < E:
                    v[at[e]] += deltas[lr, p]
                    r[at[e]] = True
            vs.append(v)
            reach.append(r)
        ten = _vec_unary(torch.exp2, torch.stack(vs) * T.LOG2_10)
        s = torch.zeros(len(cols))
        mx = torch.full((len(cols),), float("-inf"))
        for v, r, t in zip(vs, reach, ten):
            s = s + torch.where(r, t, torch.ones_like(t))
            mx = torch.maximum(mx, v)
        mean = _vec_unary(torch.log2, torch.clamp_min(
            s * inv_w[w], 1e-30)) * T.INV_LOG2_10
        c = mean if bool(is_mean[w]) else mx
        out[w, cols] = torch.where(mx > 0, torch.clamp_min(
            c, float(DELTA_TINY)), torch.zeros_like(c))
    return out


@pytest.mark.parametrize("offset", [0, 24])
def test_sparse_window_scoring(offset):
    """The postings kernel's sparse scoring (``_sparse_contrib``) bitwise
    equal to ``kernels.ambiguous_contrib`` of ``alt_delta_rows_postings``
    on the CPU, and within 2e-4 of JAX's ``alt_delta_rows_postings`` +
    ``ambiguous_contrib`` with the same hit set (XLA's exp2 and log2 round
    differently from ATen's): heavy, light and miss alternatives, pad
    slots, duplicate edges in a light row, and under an edge offset
    postings outside the shard's columns."""
    rng = np.random.default_rng(17 + offset)
    E, P, nl, nh, n_win = 64, 8, 40, 6, 16
    n_edges = E + 2 * offset
    pad = int(T.LIGHT_PAD_EDGE)
    edges = np.full((nl + 1, P), pad, np.int64)
    deltas = np.zeros((nl + 1, P), np.float32)
    for r in range(nl):
        n = int(rng.integers(1, P + 1))
        edges[r, :n] = rng.choice(n_edges, n, replace=False)
        if n > 2 and r % 3 == 0:
            edges[r, n - 1] = edges[r, 0]            # a duplicate edge
        deltas[r, :n] = rng.random(n) * 2.5 + 1e-3
        perm = rng.permutation(P)                    # pads anywhere
        edges[r], deltas[r] = edges[r, perm], deltas[r, perm]
    deltas[5, :] = np.where(edges[5] != pad, DELTA_TINY, 0)
    pairs = np.concatenate([edges.astype(np.int32), deltas.view(np.int32)],
                           axis=1)
    H = _table(rng, nh + 1, E, fill=0.3)
    W = np.where(np.arange(n_win) == 2, 20, 4)       # one protein X window
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    n_alt = alt_win.size
    alt_lrows = rng.integers(0, nl, n_alt).astype(np.int32)
    alt_hrows = np.full(n_alt, nh, np.int32)
    heavy = np.zeros(n_alt, bool)
    heavy[np.flatnonzero(alt_win % 5 == 0)[::4]] = True
    alt_hrows[heavy] = rng.integers(0, nh, int(heavy.sum()))
    alt_lrows[heavy] = nl
    alt_lrows[::7] = nl                              # misses
    alt_lrows[alt_win == 4] = 5                      # threshold-grade hits
    win_off = window_offsets(alt_win, n_win)
    inv_w = (1.0 / W).astype(np.float32)
    is_mean = rng.random(n_win) < 0.6
    t = [torch.from_numpy(x) for x in (pairs, H, alt_lrows, alt_hrows)]
    got = _sparse_contrib(*t, win_off, torch.from_numpy(inv_w), is_mean,
                          offset)
    rows = T.alt_delta_rows_postings(*t, offset,
                                     layout=T.LightLayout(P, False))
    want = T.ambiguous_contrib(rows, torch.from_numpy(alt_win),
                               torch.from_numpy(inv_w),
                               torch.from_numpy(is_mean))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[4] > 0).any()) and bool((got[2] > 0).any())
    # JAX on the shard's own table: its edges local, other postings pads
    e_loc = edges - offset
    out_of_range = (e_loc < 0) | (e_loc >= E) | (edges == pad)
    j_pairs = np.concatenate([
        np.where(out_of_range, pad, e_loc).astype(np.int32),
        np.where(out_of_range, 0, deltas).astype(np.float32).view(np.int32)],
        axis=1)
    if offset:
        assert (out_of_range & (edges != pad)).any()
    j_rows = J.alt_delta_rows_postings(
        (jnp.asarray(j_pairs),), jnp.asarray(H), jnp.asarray(alt_lrows),
        jnp.asarray(alt_hrows))
    assert np.array_equal(np.asarray(j_rows), rows.numpy())
    jc = np.asarray(J.ambiguous_contrib(j_rows, jnp.asarray(alt_win),
                                        jnp.asarray(inv_w),
                                        jnp.asarray(is_mean)))
    assert np.allclose(got.numpy(), jc, atol=2e-4, rtol=0)
    assert np.array_equal(got.numpy() > 0, jc > 0)


# ---- K3's selection (csrc/finalize.cu), modelled in numpy ------------- #

def _k3_model(acc, lens, thr, k, keep):
    """The wire K3 writes with its G = 8 lanes per read, from a numpy
    model of its selection: the row's head up to a 16-byte boundary (rows
    at b * E * 4 bytes from an aligned base) goes one value a lane; after
    it lanes own
    interleaved 16-byte chunks, kBatch = ceil(80 / G) a lane per batch, and
    each batch inserts only the matched values whose S is at or above the
    K-th best of the lanes' batch maxima; then a scalar tail; each lane
    keeps its best kLaneTop = 8 by (S desc, e asc) and K merge rounds over
    the lane heads take the picks.  K past 8 takes the scanning rounds,
    the best K of every matched value.  Returns (wire, survivors per read
    of the batch filter, matched values per read)."""
    B, E = acc.shape
    G = 8
    K, wide, n_words = T.wire_format(E, keep)
    qthr = (lens - (k - 1)).astype(np.float32) * np.float32(thr)
    S = (qthr[:, None] + acc).astype(np.float32)
    kbatch = -(-80 // G)
    wire = np.zeros((B, n_words), np.int32)
    survivors = np.zeros(B, np.int64)
    for b in range(B):
        matched = acc[b] > 0
        order = lambda es: sorted(es, key=lambda e: (-S[b, e], e))
        if K > 8:
            picks = order(np.flatnonzero(matched))[:K]
        else:
            head = min(E, (16 - (b * E * 4) % 16) % 16 // 4)
            n4 = (E - head) // 4
            lanes = [[] for _ in range(G)]
            for e in range(head):
                if matched[e]:
                    lanes[e % G].append(e)
            for f0 in range(0, n4, kbatch * G):
                own = [[head + 4 * f + j
                        for u in range(kbatch)
                        for f in [f0 + G * u + l] if f < n4
                        for j in range(4)] for l in range(G)]
                m = np.array([max([S[b, e] for e in es if matched[e]],
                                  default=-np.inf) for es in own],
                             np.float32)
                bound = np.sort(m)[::-1][K - 1]
                for l, es in enumerate(own):
                    keep_l = [e for e in es if matched[e] and
                              S[b, e] >= bound]
                    survivors[b] += len(keep_l)
                    lanes[l] += keep_l
            for e in range(head + 4 * n4, E):
                if matched[e]:
                    lanes[(e - head - 4 * n4) % G].append(e)
            heads = [order(es)[:8] for es in lanes]
            picks = order([e for es in heads for e in es])[:K]
        te = np.full((1, K), -1, np.int32)
        ts = np.full((1, K), -np.inf, np.float32)
        te[0, :len(picks)] = picks
        ts[0, :len(picks)] = S[b, picks]
        wire[b] = T.pack_wire(torch.from_numpy(te), torch.from_numpy(ts),
                              torch.zeros((1, K)),
                              torch.tensor([matched.sum()], dtype=torch.int32),
                              wide=wide).numpy()[0]
    return wire, survivors, (acc > 0).sum(1)


@pytest.mark.parametrize("E", [1, 31, 300, 301, 7999])
@pytest.mark.parametrize("keep", [1, 7, 8, 9, 20])
def test_k3_selection_model(E, keep):
    """K3's selection (``_k3_model``) bitwise equal to
    ``pack_wire(*finalize(...))`` on the CPU, and within
    ``tests/test_engine.py``'s tolerances of JAX's ``finalize``: rows with
    no match and matched everywhere, heads and tails of every length (E
    odd: rows start at each 16-byte alignment), and exact S ties from
    distinct acc values, where ranking by acc would change the wire."""
    from rappas_tpu_torch.place.engine import unpack_wire
    rng = np.random.default_rng(E * 7 + keep)
    B, k, thr = 13, 8, np.float32(-4.1)
    lens = rng.integers(k, 3000, B).astype(np.int32)
    lens[2::3] = 3000                   # |Q * thr| ~ 12,000: ulp 2^-10
    acc = k3_rows(rng, B, E, 12000.0)
    acc_t, lens_t = torch.from_numpy(acc), torch.from_numpy(lens)
    want = T.pack_wire(*T.finalize(acc_t, lens_t, torch.tensor(thr), k,
                                   keep)).numpy()
    K, wide, _ = T.wire_format(E, keep)
    got, survivors, matched = _k3_model(acc, lens, thr, k, keep)
    assert np.array_equal(got, want)
    if K <= 8 and E >= 300:             # the bound drops most values
        assert survivors[1] < matched[1] // 2
    if E >= 31 and K >= 2:              # the trap: ranking by acc differs
        by_acc = T.pack_wire(*T.finalize(acc_t, torch.full_like(lens_t, k - 1),
                                         torch.tensor(thr), k, keep))
        S = (lens - (k - 1)).astype(np.float32)[:, None] * thr + acc
        tie = [b for b in range(2, B, 3)
               if S[b, acc[b].argmax()] == S[b, np.argsort(-acc[b])[1]]]
        assert tie and not np.array_equal(
            by_acc.numpy()[tie, K:K + (K + 1) // 2],
            want[tie, K:K + (K + 1) // 2])
    # JAX's finalize: |L| exact, scores within 2e-4 or two f32 ulps of the
    # score where that is more (|S| ~ 10,500 here: XLA may fuse Q * thr +
    # acc into one rounding), and the same edge sets, except that an edge
    # at the K-th place may give way to another at a near-tie of it
    je, js, _, jn = (np.asarray(x) for x in J.finalize(
        jnp.asarray(acc), jnp.asarray(lens), jnp.float32(thr), k, keep))
    res = unpack_wire(want, K, wide)
    assert np.array_equal(res.n_matched, jn)
    for b in range(B):
        v = res.top_edges[b] >= 0
        assert np.array_equal(v, je[b] >= 0)
        mine, theirs = np.sort(res.top_scores[b][v]), np.sort(js[b][v])
        tol = np.maximum(2e-4, 2 * np.spacing(np.abs(theirs)))
        assert (np.abs(mine - theirs) <= tol).all()
        ours = dict(zip(res.top_edges[b][v], res.top_scores[b][v]))
        jaxs = dict(zip(je[b][v], js[b][v]))
        if set(ours) != set(jaxs):
            assert v.all() and jn[b] > K   # only a cut at K can differ
            for e in set(ours) ^ set(jaxs):
                x = ours[e] if e in ours else jaxs[e]
                assert abs(x - mine[0]) <= tol[0], (b, e)
                assert abs(x - theirs[0]) <= tol[0], (b, e)


@pytest.mark.parametrize("E, sizes", [
    (5, [0, 1, 3, 0, 2]),
    (50, [2, 0, 0, 7, 1, 0]),
    (301, [0, 40, 1, 1, 0]),
])
def test_dense_side_plain_empty_slots_match_jax(E, sizes):
    """P1's plain version (``dense_side`` on CPU tensors): a slot without
    heavy sources is a zero row, every slot is the in-order f32 sum of its
    rows from zero (bitwise, the sums P1 forms on the card), and the whole
    matches JAX's ``gather_rows`` + the dense ``.at[].add`` scatter of
    ``finalize_postings_local`` on the CPU."""
    rng = np.random.default_rng(E + len(sizes))
    H = _table(rng, 12, E, fill=0.5)
    sizes = np.asarray(sizes)
    hrows = rng.integers(0, 11, int(sizes.sum())).astype(np.int32)
    hoff = np.zeros(sizes.size + 1, np.int32)
    np.cumsum(sizes, out=hoff[1:])
    got = T.dense_side(torch.from_numpy(H), torch.from_numpy(hrows),
                       torch.from_numpy(hoff)).numpy()
    want = np.zeros((sizes.size, E), np.float32)
    for s in range(sizes.size):
        for i in range(hoff[s], hoff[s + 1]):
            want[s] += H[hrows[i]]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[sizes == 0].any()
    slots = np.repeat(np.arange(sizes.size), sizes)
    g = J.gather_rows(jnp.asarray(H), jnp.asarray(hrows))
    j = np.asarray(jnp.zeros((sizes.size + 1, E), jnp.float32).at[
        jnp.asarray(slots)].add(g))[:sizes.size]
    assert np.allclose(got, j, rtol=1e-6, atol=0)
    assert not j[sizes == 0].any()
