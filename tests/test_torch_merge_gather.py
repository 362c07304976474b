"""M1 ``merge_candidates_wire`` and G1 ``gather_compact`` on the CPU: a
numpy model of each kernel's design (M1's rank selection, G1's copy plan)
held bitwise against the JAX package's functions and the wrappers' plain
versions.  The kernels themselves run in ``tests/test_torch_card.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cases import shard_wires

from rappas_tpu.place import engine as J
from rappas_tpu_torch.place import kernels as T

# ---- M1 ---------------------------------------------------------------- #


def m1_model(wires: np.ndarray, K_in: int, keep: int,
             wide: bool) -> np.ndarray:
    """``csrc/merge.cu``'s selection in numpy: every candidate's rank is
    the number of candidates before it in (score desc, c asc); rank r <
    keep is pick r, written with its score bits and its edge ("none"
    where the score is not finite); the odd-K pad half is 0xffff; |L| the
    int32 sum over shards, -1 where a shard's is negative."""
    mp, B, _ = wires.shape
    M = mp * K_in
    v = np.concatenate(list(wires[:, :, :K_in]), axis=1).view(np.float32)
    if wide:
        e = np.concatenate(list(wires[:, :, K_in:2 * K_in]), axis=1)
    else:
        half = wires[:, :, K_in:K_in + (K_in + 1) // 2].copy().view(
            np.uint16)[:, :, :K_in]
        e = np.concatenate(list(half), axis=1).astype(np.int32)
    c = np.arange(M)
    before = (v[:, :, None] > v[:, None, :]) | (
        (v[:, :, None] == v[:, None, :]) & (c[:, None] < c[None, :]))
    rank = before.sum(axis=1)                   # [B, M]: d before c, summed
    assert np.array_equal(np.sort(rank, axis=1),
                          np.broadcast_to(c, (B, M)))
    bb, cc = np.nonzero(rank < keep)
    r = rank[bb, cc]
    none = ~np.isfinite(v[bb, cc])
    n_words = 2 * keep + 1 if wide else keep + (keep + 1) // 2 + 1
    out = np.zeros((B, n_words), np.int32)
    out[bb, r] = v[bb, cc].view(np.int32)
    if wide:
        out[bb, keep + r] = np.where(none, -1, e[bb, cc])
    else:
        halves = np.full((B, 2 * ((keep + 1) // 2)), 0xffff, np.uint16)
        halves[bb, r] = np.where(none, 0xffff, e[bb, cc])
        out[:, keep:n_words - 1] = halves.view(np.int32)
    nm = wires[:, :, -1].astype(np.int64)
    out[:, -1] = np.where((nm < 0).any(axis=0), -1,
                          nm.sum(axis=0)).astype(np.int32)
    return out


def jax_tail(wires: np.ndarray, K_in: int, keep: int, wide: bool):
    """The JAX step's tail (``postings_sharded.py:192-206``) on the decoded
    shards: the tiled all-gather, ``lax.top_k``, edges of non-finite
    picks -1, the psum of |L| -> (edges, scores, psum)."""
    fields = [T.wire_fields(torch.from_numpy(w), K_in, wide) for w in wires]
    te_all = np.concatenate([f[0].numpy() for f in fields], axis=1)
    ts_all = np.concatenate([f[1].numpy() for f in fields], axis=1)
    nm = np.stack([f[2].numpy() for f in fields])
    top_s, ti = jax.lax.top_k(jnp.asarray(ts_all), keep)
    top_e = jnp.take_along_axis(jnp.asarray(te_all), ti, axis=1)
    te = jnp.where(jnp.isfinite(top_s), top_e, -1).astype(jnp.int32)
    return np.array(te), np.array(top_s), nm.sum(axis=0)


@pytest.mark.parametrize("mp, K_in, keep, wide", [
    (2, 7, 7, False),      # the sharded engine's shape: M = 14, K odd
    (2, 7, 6, False),      # K even
    (2, 8, 8, False),      # M = 16, one lane of a 16-lane group each
    (3, 7, 7, False),      # M = 21: two candidates on some lanes
    (4, 8, 8, False),      # M = 32
    (8, 7, 7, False),      # M = 56
    (4, 20, 20, False),    # M = 80, keep 20
    (3, 5, 5, True),       # the wide wire
    (4, 20, 20, True)])
def test_m1_rank_model_matches_jax_tail(mp, K_in, keep, wide):
    """M1's rank selection (numpy model) bitwise against JAX's tail packed
    as a wire, and the wrapper's plain version bitwise against the model:
    ties across shards go to the lower shard, ties within one to the
    lower slot; -inf slots and a finite score whose edge is "none" keep
    their scores; |L| is the psum, or -1 where a shard's is -1 (the port's
    rule: P3 could not sort the read there; JAX's P3 never fails)."""
    rng = np.random.default_rng(900 + 10 * mp + K_in)
    B = 64
    E = 70000 if wide else 40 * mp * K_in
    wires = shard_wires(rng, mp, B, K_in, E, wide).numpy()
    got = m1_model(wires, K_in, keep, wide)
    te, ts, nm = jax_tail(wires, K_in, keep, wide)
    failed = (wires[:, :, -1] < 0).any(axis=0)
    assert failed[4] and (~failed).sum() > 0
    nm = np.where(failed, -1, nm)
    if wide:
        want = T.pack_wire(torch.from_numpy(te), torch.from_numpy(ts),
                           None, torch.from_numpy(nm), wide=True).numpy()
    else:
        want = np.asarray(J.pack_wire(te, ts, None, nm))
    assert np.array_equal(got, want)
    # the cases are present: a finite pick with no edge, a read of -inf
    # picks, exact ties inside the picks
    assert np.isfinite(ts[3, 0]) and te[3, 0] == -1
    assert not np.isfinite(ts[1]).any()
    assert (ts[:, 1:] == ts[:, :-1]).any()
    plain = T.merge_candidates_wire(torch.from_numpy(wires), K_in, keep,
                                    wide)
    assert np.array_equal(plain.numpy(), got)


# ---- G1 ---------------------------------------------------------------- #


def g1_model(parts, uniq: np.ndarray, uniq_off: np.ndarray) -> np.ndarray:
    """``csrc/postings.cu``'s G1 copy plan in numpy: loads of 4 or 2
    words chosen from the row width w = 2P; blocks of (lanes, 256 // lanes)
    threads, 4 rows per thread; row u of block x, slot k, thread row y is
    ``x * rows + k * ry + y``; its part the last whose run starts at or
    before u (a binary search over ``uniq_off[:n]``)."""
    n, w = len(parts), parts[0].shape[1]
    V = 4 if w % 4 == 0 else 2
    lanes = min(w // V, 256)
    ry = 256 // lanes
    rows = 4 * ry
    U = uniq.size
    grid = -(-U // rows)
    x, k, y = np.meshgrid(np.arange(grid), np.arange(4), np.arange(ry),
                          indexing="ij")
    u = (x * rows + k * ry + y).ravel()
    u = u[u < U]
    assert np.array_equal(np.sort(u), np.arange(U))     # every row once
    lo, hi = np.zeros_like(u), np.full_like(u, n - 1)
    while (lo < hi).any():
        mid = (lo + hi + 1) >> 1
        up = uniq_off[np.minimum(mid, n - 1)] <= u
        lo, hi = (np.where((lo < hi) & up, mid, lo),
                  np.where((lo < hi) & ~up, mid - 1, hi))
    out = np.zeros((U, w), np.int32)
    for p in range(n):
        sel = lo == p
        out[u[sel]] = parts[p][uniq[u[sel]]]
    return out


@pytest.mark.parametrize("n_parts, P, runs", [
    (1, 8, "all"), (3, 8, "all"), (3, 8, "empty"), (32, 8, "empty"),
    (3, 7, "all"), (32, 7, "empty"), (3, 8, "none"), (1, 7, "none")])
def test_g1_plan_matches_jax(n_parts, P, runs):
    """G1's copy plan (numpy model) and the wrapper on CPU tensors against
    ``J.gather_compact`` over per-part runs: one, 3 and 32 parts; every
    third part's run empty ("empty"), or every run ("none": U = 0); P = 7
    (rows of 56 bytes, not 16-byte aligned: the 8-byte loads)."""
    rng = np.random.default_rng(1000 + 10 * n_parts + P)
    heights = rng.integers(5, 60, n_parts)
    parts = tuple(rng.integers(-2 ** 31, 2 ** 31, (h, 2 * P))
                  .astype(np.int32) for h in heights)
    uniq = []
    for p, h in enumerate(heights):
        empty = runs == "none" or (runs == "empty" and p % 3 == 1)
        size = 0 if empty else int(rng.integers(1, h + 1))
        uniq.append(np.sort(rng.choice(h, size, replace=False))
                    .astype(np.int32))
    off = np.concatenate([[0], np.cumsum([u.size for u in uniq])]) \
        .astype(np.int32)
    flat = np.concatenate(uniq).astype(np.int32)
    want = np.asarray(J.gather_compact(
        tuple(jnp.asarray(p) for p in parts),
        tuple(jnp.asarray(u) for u in uniq)))
    assert want.shape == (flat.size, 2 * P)
    assert np.array_equal(g1_model(parts, flat, off), want)
    tp = tuple(torch.from_numpy(p) for p in parts)
    got = T.gather_compact_(T.make_parts(tp, heights), torch.from_numpy(flat),
                            torch.from_numpy(off))
    assert np.array_equal(got.numpy(), want)
