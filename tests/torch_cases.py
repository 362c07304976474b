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


#: the light-row readers held on narrow and wide rows: P3 on one table,
#: R1 routed and part-select, P3 on G1's compact table, P2, A1
LIGHT_OPS = ("p3", "r1_routed", "r1_parts", "g1", "p2", "a1")


def light_case(P, seed, B=16, W=6, nl=90, nh=6, E=300):
    """Inputs of every light-row reader: a light table's postings (edge
    ids int32[nl + 1, P], pads ``LIGHT_PAD_EDGE`` past each row's count,
    the last row all pads; quarter deltas, so that every sum is exact in
    f32 whatever its order), ``B`` reads of ``W`` light rows (read 0 all
    misses), dense slots, heavy rows and ambiguity windows (light, heavy
    and miss alternatives)."""
    rng = np.random.default_rng(seed)
    pad = int(T.LIGHT_PAD_EDGE)
    edges = np.full((nl + 1, P), pad, np.int32)
    deltas = np.zeros((nl + 1, P), np.float32)
    for r in range(nl):
        n = int(rng.integers(1, P + 1))
        edges[r, :n] = rng.choice(E, n, replace=False)
        deltas[r, :n] = rng.integers(1, 12, n) * 0.25
    lrows = rng.integers(0, nl + 1, (B, W)).astype(np.int32)
    lrows[0] = nl
    H = np.where(rng.random((nh + 1, E)) < 0.3,
                 rng.integers(1, 12, (nh + 1, E)) * 0.25, 0
                 ).astype(np.float32)
    H[-1] = 0
    slot_reads = np.sort(rng.choice(B, 6, replace=False))
    slot_of = np.full(B, -1, np.int32)
    slot_of[slot_reads] = np.arange(6, dtype=np.int32)
    acc_c = np.where(rng.random((6, E)) < 0.2,
                     rng.integers(1, 12, (6, E)) * 0.25, 0
                     ).astype(np.float32)
    n_win = 10
    n_alt = rng.integers(1, 5, n_win)
    alt_win = np.repeat(np.arange(n_win), n_alt)
    light = rng.random(alt_win.size) < 0.7
    alt_lrows = np.where(light, rng.integers(0, nl, alt_win.size), nl)
    alt_hrows = np.where(light, nh, rng.integers(0, nh, alt_win.size))
    alt_lrows[::5], alt_hrows[::5] = nl, nh            # misses
    win_off = np.concatenate([[0], np.cumsum(n_alt)]).astype(np.int32)
    return dict(
        edges=edges, deltas=deltas, lrows=lrows, H=H, acc_c=acc_c,
        slot_of=slot_of, lens=rng.integers(40, 150, B).astype(np.int32),
        counts=(edges[lrows] != pad).sum(axis=(1, 2)),
        alt_lrows=alt_lrows.astype(np.int32),
        alt_hrows=alt_hrows.astype(np.int32), win_off=win_off,
        win_slot=rng.integers(0, 6, n_win).astype(np.int32),
        win_inv_w=(1.0 / n_alt).astype(np.float32),
        win_is_mean=(rng.random(n_win) < 0.6).astype(np.uint8))


def light_op(op, case, layout, device, k=10, keep=7, thr=-3.25,
             n_parts=3):
    """One light-row reader of :data:`LIGHT_OPS` on ``case``'s table
    packed in ``layout`` (split into ``n_parts`` parts for R1, G1 and A1)
    on ``device``: the wire of a P3 instance, or P2's / A1's slot
    accumulator."""
    from rappas_tpu_torch.convert import light_parts
    from rappas_tpu_torch.place.engine import route_rows

    table = layout.pack(case["edges"], case["deltas"])
    nl = table.shape[0] - 1

    def dev(a):     # a copy: P2 and A1 add into acc_c in place
        return torch.from_numpy(np.array(a)).to(device)
    if op in ("r1_routed", "r1_parts", "g1", "a1"):
        parts, _ = light_parts(table, table.nbytes // n_parts + 1, 32)
        assert len(parts) == n_parts
        heights = [p.shape[0] for p in parts]
        tparts = T.make_parts([dev(p) for p in parts], heights)
        cuts = np.concatenate([[0], np.cumsum(heights)])
    H, acc_c = dev(case["H"]), dev(case["acc_c"])
    if op in ("p2", "a1"):
        spec = [dev(case[n]) for n in ("alt_lrows", "alt_hrows", "win_off",
                                       "win_slot", "win_inv_w",
                                       "win_is_mean")]
        if op == "p2":
            return T.ambiguous_postings_(acc_c, H, dev(table), *spec,
                                         layout=layout)
        return T.ambiguous_postings_parts_(acc_c, H, tparts, *spec,
                                           layout=layout)
    plan = T.postings_plan(case["counts"]).to(device)
    args = (acc_c, dev(case["slot_of"]), dev(case["lens"]), thr, k, keep,
            plan)
    lrows = case["lrows"]
    if op == "p3":
        return T.finalize_postings_wire(dev(table), dev(lrows), *args,
                                        layout=layout)
    if op == "r1_routed":
        return T.finalize_postings_wire_routed(
            tparts, dev(route_rows(lrows, cuts, drop=nl)), *args,
            layout=layout)
    if op == "r1_parts":
        return T.finalize_postings_wire_parts(tparts, dev(lrows), *args,
                                              miss=nl, layout=layout)
    # g1: the batch's unique rows, each part's run from its own part
    u, inv = np.unique(lrows, return_inverse=True)
    part = np.searchsorted(cuts[1:], u, side="right")
    runs = [u[part == i] - cuts[i] for i in range(n_parts)]
    off = np.concatenate([[0], np.cumsum([r.size for r in runs])])
    compact = T.gather_compact_(tparts, dev(np.concatenate(runs).astype(
        np.int32)), dev(off.astype(np.int32)))
    return T.finalize_postings_wire(
        compact, dev(inv.reshape(lrows.shape).astype(np.int32)), *args,
        miss=int(np.searchsorted(u, nl)) if u[-1] == nl else -1,
        layout=layout)
