"""Device kernels of ``-p p`` placement on the direct, compact and
postings tables, on one device or sharded over a mesh.

Two parts:

* the **plain PyTorch versions**, under the names and with the semantics
  of the jitted functions of ``rappas_tpu/place/engine.py`` (direct:
  :func:`kmer_rows_packed`, :func:`kmer_rows`, :func:`accumulate`,
  :func:`finalize`, :func:`pack_wire`, :func:`alt_delta_rows`,
  :func:`ambiguous_contrib`, :func:`ambiguous_pass`; compact:
  :func:`kmer_indices64`, :func:`compact_rows`; postings:
  :func:`gather_rows`, :func:`scatter_slots`, :func:`light_gather`,
  :func:`light_postings` (a light row's postings, u16 or int32 edge ids),
  :func:`alt_delta_rows_postings`, :func:`finalize_postings`; sharded:
  :func:`accumulate_range`, :func:`merge_candidates`; height-split
  tables: :func:`routed_light_gather`, :func:`gather_compact`,
  :func:`routed_accumulate`, :func:`alt_delta_rows_split`, and the
  multi-part forms of :func:`light_gather` and
  :func:`finalize_postings`).  They run on any device; the tests hold
  them against the JAX functions, and ``chip_smoke.py`` holds the
  kernels against them on the card;
* the **wrappers** of the CUDA kernels of ``csrc/`` (direct:
  :func:`accumulate_packed`, :func:`accumulate_codes`,
  :func:`finalize_wire`, :func:`ambiguous_pass_`; compact:
  :func:`accumulate_compact`, :func:`accumulate_rows`; postings:
  :func:`dense_side`, :func:`ambiguous_postings_`,
  :func:`finalize_postings_wire`, the last two also on one edge-range
  shard; sharded: :func:`accumulate_rows_range` on one k-mer-range shard,
  :func:`merge_candidates_wire` over the shards' wires; height-split
  tables, given as :class:`Parts`: :func:`finalize_postings_wire_routed`
  and :func:`finalize_postings_wire_parts` (R1), :func:`gather_compact_`
  (G1), :func:`ambiguous_postings_parts_` and
  :func:`ambiguous_pass_split_` (A1), :func:`routed_accumulate_` (D1)).
  A wrapper
  given CPU tensors computes its plain composition; given CUDA tensors it
  launches its kernel on the current stream or raises -- it never falls
  back.  Each launch adds one to the counter ``kernel.launch.<name>``
  (:func:`rappas_tpu_torch.utils.count`), ``<name>`` the kernel's name
  with ``_u16`` appended for the instance that reads a uint16 table.

The direct and compact tables come in f32 or uint16 (fixed point,
``delta = D * scale``): the sums run in f32 over the raw table values
and the caller's ``scale`` multiplies the result once, as in the JAX
engine; ambiguity rows are scaled per element (``alt_delta_rows``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rappas_tpu_torch.db import (DELTA_TINY, LIGHT_PAD_EDGE, WIDE_EDGES,
                                 LightLayout)
from rappas_tpu_torch.utils import count

LOG2_10 = float(np.float32(np.log2(10.0)))
INV_LOG2_10 = float(np.float32(1.0 / np.log2(10.0)))


# ====================================================================== #
# plain PyTorch versions (rappas_tpu/place/engine.py names)
# ====================================================================== #

def kmer_rows(codes: torch.Tensor, k: int, n_states: int,
              n_rows: int) -> torch.Tensor:
    """[B, L] int8 codes -> [B, Q] int32 row indices into D; windows
    holding a negative code (ambiguity or padding) map to the all-zero
    miss row ``n_rows - 1``."""
    idx = kmer_indices64(codes, k, n_states)
    return idx.masked_fill(idx < 0, n_rows - 1)


def kmer_rows_packed(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                     n_states: int, n_rows: int,
                     length: int) -> torch.Tensor:
    """2-bit packed reads (base i at bits ``2*(i%4)`` of byte ``i//4``)
    -> [B, Q] int32 row indices; windows past ``lengths[b] - k`` map to
    the miss row."""
    B = packed.shape[0]
    Q = length - k + 1
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=packed.device)
    codes = ((packed.to(torch.int32)[:, :, None] >> shifts) & 3)
    codes = codes.reshape(B, -1)[:, :length]
    idx = torch.zeros((B, Q), dtype=torch.int32, device=packed.device)
    for i in range(k):
        idx = idx * n_states + codes[:, i:i + Q]
    pos = torch.arange(Q, device=packed.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    return idx.masked_fill(~valid, n_rows - 1)


def kmer_indices64(codes: torch.Tensor, k: int,
                   n_states: int) -> torch.Tensor:
    """[B, L] int8 codes -> [B, Q] int32 k-mer indices, -1 for a window
    that holds a negative code (ambiguity or padding).  ``S^k`` must fit
    int32; above that the host computes the indices
    (``engine.host_kmer_indices``), as the JAX engine does."""
    if n_states ** k > 2 ** 31 - 1:
        raise ValueError(f"{n_states}^{k} k-mer indices do not fit int32")
    B, L = codes.shape
    Q = L - k + 1
    c = codes.to(torch.int32)
    idx = torch.zeros((B, Q), dtype=torch.int32, device=codes.device)
    valid = torch.ones((B, Q), dtype=torch.bool, device=codes.device)
    for i in range(k):
        w = c[:, i:i + Q]
        valid &= w >= 0
        idx = idx * n_states + w.clamp_min(0)
    return idx.masked_fill(~valid, -1)


def compact_rows(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """k-mer indices -> int32 rows of the compact table ``[n + 1, E]`` by
    binary search in the sorted ``keys[n]``: a hit gives its position, a
    miss and -1 give ``n`` (the all-zero last row); no keys, all 0."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    pos = torch.searchsorted(keys, idx)
    hit = (pos < n) & (keys[pos.clamp_max(n - 1)] == idx) & (idx >= 0)
    return torch.where(hit, pos, torch.full_like(pos, n)).to(torch.int32)


def accumulate(D: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``sum_q D[rows[:, q], :]`` -> f32[B, E] (materialises [B, Q, E]);
    a uint16 table sums its raw values (the caller applies the scale)."""
    B, Q = rows.shape
    g = D.index_select(0, rows.reshape(-1)).reshape(B, Q, D.shape[1])
    return g.to(torch.float32).sum(dim=1)


def accumulate_range(D: torch.Tensor, rows: torch.Tensor, lo: int,
                     per: int) -> torch.Tensor:
    """One k-mer-range shard's partial sums (``rappas_tpu/parallel/
    kmer_sharded.py:76-80``): global rows folded into the shard's range
    ``[lo, lo + per)`` (any other row -> the shard's zero row ``per``),
    then :func:`accumulate` over the shard ``D[per + 1, E]``."""
    local = rows - lo
    hit = (local >= 0) & (local < per)
    return accumulate(D, torch.where(hit, local, torch.full_like(local, per)))


def finalize(acc: torch.Tensor, lengths: torch.Tensor, thr: torch.Tensor,
             k: int, keep_at_most: int):
    """acc [B, E] -> (top edges, top scores, LWR, |L|).

    ``S = Q*thr + acc`` with ``Q = len - k + 1``; unmatched edges
    (``acc == 0``) are excluded; top-K by a stable descending sort, so
    ties go to the lower edge index as ``lax.top_k`` does; LWR over the
    valid rows with the max shift."""
    E = acc.shape[1]
    Q = (lengths - (k - 1)).to(torch.float32)
    matched = acc > 0
    n_matched = matched.sum(dim=1).to(torch.int32)
    scores = Q[:, None] * thr + acc
    masked = torch.where(matched, scores,
                         torch.full_like(scores, float("-inf")))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    K = min(keep_at_most, E)
    top_scores, top_idx = vals[:, :K], idx[:, :K]
    return _top_out(top_scores, top_idx, n_matched)


def _top_out(top_scores, top_idx, n_matched):
    """(edges, scores, LWR, |L|) from the top-K scores: slots with a
    -inf score hold edge -1; LWR over the valid slots with the max
    shift."""
    valid = torch.isfinite(top_scores)
    shift = top_scores[:, :1]
    w = torch.where(valid, torch.exp2((top_scores - shift) * LOG2_10),
                    torch.zeros_like(top_scores))
    lwr = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-30)
    top_edges = torch.where(valid, top_idx,
                            torch.full_like(top_idx, -1)).to(torch.int32)
    return top_edges, top_scores, lwr, n_matched.to(torch.int32)


def pack_wire(te: torch.Tensor, ts: torch.Tensor, lwr: torch.Tensor,
              nm: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """One int32 [B, K + ceil(K/2) + 1] array per batch: scores bit-cast
    from f32, edge ids two u16 per word (low half first, 65535 = no
    edge), |L|.  LWR is dropped; the host recomputes it.  ``wide`` (for
    ``E >= WIDE_EDGES`` edge slots, whose ids do not fit u16): int32
    [B, 2K + 1], the K edge ids as int32 (-1 = no edge)."""
    B, K = te.shape
    if wide:
        return torch.cat([ts.contiguous().view(torch.int32),
                          te.to(torch.int32), nm.to(torch.int32)[:, None]],
                         dim=1)
    edges = torch.where(te < 0, torch.full_like(te, 65535),
                        te).to(torch.int64)
    if K % 2:
        edges = torch.cat([edges, torch.full((B, 1), 65535,
                                             dtype=torch.int64,
                                             device=te.device)], dim=1)
    pairs = edges.reshape(B, -1, 2)
    word = pairs[:, :, 0] | (pairs[:, :, 1] << 16)
    ew = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    sw = ts.contiguous().view(torch.int32)
    return torch.cat([sw, ew, nm.to(torch.int32)[:, None]], dim=1)


def wire_fields(words: torch.Tensor, K: int, wide: bool = False):
    """The inverse of :func:`pack_wire` on tensors: (edges int64 [B, K]
    with -1 = no edge, scores f32 [B, K], |L| int32 [B])."""
    B = words.shape[0]
    ts = words[:, :K].contiguous().view(torch.float32)
    if wide:
        return words[:, K:2 * K].to(torch.int64), ts, words[:, 2 * K]
    w = words[:, K:K + (K + 1) // 2].to(torch.int64) & 0xFFFFFFFF
    te = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(B, -1)[:, :K]
    return (torch.where(te == 65535, torch.full_like(te, -1), te), ts,
            words[:, K + (K + 1) // 2])


def merge_candidates(te_all: torch.Tensor, ts_all: torch.Tensor,
                     nm: torch.Tensor, keep: int):
    """The exact global top-K of edge-range shards' candidates, as the
    tail of ``rappas_tpu/parallel/postings_sharded.py:192-206`` computes
    it: ``te_all``/``ts_all`` [B, mp * K_in] the shards' candidates in
    all-gather order, ``nm`` int [mp, B] their ``|L|``.  The K best by a
    stable descending sort (ties to the lower index, the lower shard, as
    ``lax.top_k``), -inf slots with edge -1, ``|L|`` summed over shards
    (-1 when a shard's is negative) -> (edges, scores, LWR, |L|)."""
    vals, idx = torch.sort(ts_all, dim=1, descending=True, stable=True)
    nm_tot = nm.to(torch.int64).sum(dim=0)
    nm_tot = torch.where((nm < 0).any(dim=0), torch.full_like(nm_tot, -1),
                         nm_tot)
    return _top_out(vals[:, :keep], te_all.gather(1, idx[:, :keep]), nm_tot)


def alt_delta_rows(D: torch.Tensor, scale,
                   alt_rows: torch.Tensor) -> torch.Tensor:
    """[n_alt, E] f32 delta rows of the ambiguity alternatives (a uint16
    table is scaled per element)."""
    return D.index_select(0, alt_rows).to(torch.float32) * scale


def routed_accumulate(parts: tuple, routed) -> torch.Tensor:
    """f32[B, E] from a height-split direct table
    (``rappas_tpu/place/engine.py:915-928``): :func:`accumulate` of each
    part over its routed part-LOCAL rows ``routed[p]`` [B, W] (pads point
    at the part's trailing zero row), the partial sums added in part
    order; the caller applies the scale."""
    acc = None
    for p, r in zip(parts, routed):
        a = accumulate(p, r)
        acc = a if acc is None else acc + a
    return acc


def alt_delta_rows_split(parts: tuple, scale,
                         alt_rows: torch.Tensor) -> torch.Tensor:
    """[n_alt, E] f32 delta rows from a height-split direct table
    (``rappas_tpu/place/engine.py:931-947``): ``alt_rows`` are global body
    rows, each part carries one trailing zero row, and the global miss row
    (the total body height) clips to the last part's zero row."""
    out, off = None, 0
    for p in parts:
        H = p.shape[0] - 1
        g = p.index_select(0, (alt_rows - off).clamp(0, H)).to(torch.float32)
        out = g if out is None else \
            torch.where((alt_rows >= off)[:, None], g, out)
        off += H
    return out * scale


def ambiguous_contrib(rows: torch.Tensor, alt_win: torch.Tensor,
                      win_inv_w: torch.Tensor,
                      win_is_mean: torch.Tensor) -> torch.Tensor:
    """[n_win, E] per-window contributions: mean mode
    ``log10(sum_alt 10^delta / W)``, max mode ``max_alt delta``; an edge
    hit by any alternative is floored at DELTA_TINY, others are 0
    (``PlacementProcess.java:1129-1236``)."""
    n_win = win_is_mean.shape[0]
    E = rows.shape[1]
    ten = torch.exp2(rows * LOG2_10)
    sums = rows.new_zeros((n_win, E)).index_add_(0, alt_win, ten)
    maxs = rows.new_full((n_win, E), float("-inf")).scatter_reduce_(
        0, alt_win.to(torch.int64)[:, None].expand(-1, E), rows,
        reduce="amax")
    mean = torch.log2(torch.clamp_min(sums * win_inv_w[:, None],
                                      1e-30)) * INV_LOG2_10
    contrib = torch.where(win_is_mean.to(torch.bool)[:, None], mean, maxs)
    hit = maxs > 0
    return torch.where(hit, torch.clamp_min(contrib, float(DELTA_TINY)),
                       torch.zeros_like(contrib))


def ambiguous_pass(rows: torch.Tensor, alt_win: torch.Tensor,
                   win_read: torch.Tensor, win_inv_w: torch.Tensor,
                   win_is_mean: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """``acc`` plus the window contributions summed by read (by slot in
    the postings layout: ``win_read`` is then the read's slot)."""
    contrib = ambiguous_contrib(rows, alt_win, win_inv_w, win_is_mean)
    return acc + torch.zeros_like(acc).index_add_(0, win_read, contrib)


# ---- postings layout (large trees) ------------------------------------ #

def gather_rows(H: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain row gather: ``H[rows]``."""
    return H.index_select(0, rows)


def scatter_slots(rows: torch.Tensor, slots: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """The dense side's slot accumulator ``acc_c[n_slots, E]``: row
    ``rows[i]`` added into slot ``slots[i]`` (the scatter of
    ``finalize_postings_local`` :773-780, without its pad row)."""
    return rows.new_zeros((n_slots, rows.shape[1])).index_add_(
        0, slots, rows)


def light_gather(parts, lrows: torch.Tensor) -> torch.Tensor:
    """Row gather from the light table, whole (a tensor: ``pairs[lrows]``)
    or height-split (a tuple of parts, ``rappas_tpu/place/engine.py:
    654-681``): global rows, part ``i`` holding rows ``off_i .. off_i +
    H_i``; every part is gathered for every row (clipped into it) and the
    last part whose first row is ``<= lrows`` is selected."""
    if isinstance(parts, torch.Tensor):
        parts = (parts,)
    if len(parts) == 1:
        return parts[0].index_select(0, lrows.reshape(-1)).reshape(
            *lrows.shape, parts[0].shape[1])
    out, off = None, 0
    for p in parts:
        H = p.shape[0]
        g = light_gather(p, (lrows - off).clamp(0, H - 1))
        out = g if out is None else \
            torch.where((lrows >= off)[..., None], g, out)
        off += H
    return out


def light_postings(g: torch.Tensor, layout: LightLayout):
    """The postings of light rows ``g`` int32[..., words] of ``layout``:
    (edge ids int64[..., P], pads ``LIGHT_PAD_EDGE``; deltas f32[...,
    P])."""
    ew = layout.edge_words
    d = g[..., ew:].contiguous().view(torch.float32)
    if not layout.narrow:
        return g[..., :layout.P].to(torch.int64), d
    w = g[..., :ew].to(torch.int64) & 0xFFFFFFFF
    e = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        *g.shape[:-1], 2 * ew)[..., :layout.P]
    return torch.where(e == 0xFFFF, int(LIGHT_PAD_EDGE), e), d


def routed_light_gather(parts: tuple, routed,
                        layout: LightLayout) -> torch.Tensor:
    """[B, sum(W_p), words] window gather with per-part routing
    (``rappas_tpu/place/engine.py:609-629``): ``routed[p]`` holds part
    ``p``'s part-LOCAL rows [B, W_p], pad slots ``>= H_p``, which become
    rows of pad edges and zero deltas (light rows of ``layout``)."""
    gs = []
    ew = layout.edge_words
    for p, r in zip(parts, routed):
        H = p.shape[0]
        g = light_gather(p, r.clamp_max(H - 1))
        pad = (r >= H)[..., None]
        gs.append(torch.cat([
            torch.where(pad, layout.pad_word, g[..., :ew]),
            torch.where(pad, 0, g[..., ew:])], dim=-1))
    return torch.cat(gs, dim=1)


def gather_compact(parts: tuple, uniq) -> torch.Tensor:
    """The batch-unique compact table (``rappas_tpu/place/engine.py:
    557-570``): with ``uniq`` a tuple of part-LOCAL rows per part, each
    part's rows gathered from that part and concatenated in part order;
    with one tensor of global rows, :func:`light_gather`."""
    if isinstance(uniq, (tuple, list)):
        return torch.cat([light_gather(p, u) for p, u in zip(parts, uniq)])
    return light_gather(parts, uniq)


def alt_delta_rows_postings(pairs, heavy_dense: torch.Tensor,
                            alt_lrows: torch.Tensor, alt_hrows: torch.Tensor,
                            edge_offset: int = 0, *,
                            layout: LightLayout) -> torch.Tensor:
    """[n_alt, E] f32 delta rows of the ambiguity alternatives: the heavy
    dense row plus the scattered light postings (misses take the heavy
    table's zero row and the light table's all-pad row; pad slots drop
    out of the scatter).  ``pairs`` is the light table or a tuple of its
    parts (:func:`light_gather`), rows of ``layout``.  Under
    edge-range sharding the columns are the edges ``edge_offset ..
    edge_offset + E - 1`` (``rappas_tpu/parallel/postings_sharded.py:
    172-177``): a posting adds at column ``edge - edge_offset`` when that
    lies in ``[0, E)``."""
    E = heavy_dense.shape[1]
    dense = heavy_dense.index_select(0, alt_hrows)
    e, d = light_postings(light_gather(pairs, alt_lrows), layout)
    e = e - edge_offset
    keep = (e >= 0) & (e < E)
    r = torch.arange(e.shape[0], device=e.device)[:, None].expand_as(e)
    return dense.index_put_((r[keep], e[keep]), d[keep], accumulate=True)


def finalize_postings(pairs: torch.Tensor | None, lrows: torch.Tensor | None,
                      acc_c: torch.Tensor, slot_of: torch.Tensor,
                      lengths: torch.Tensor, thr: torch.Tensor, k: int,
                      keep_at_most: int, edge_offset: int = 0, *,
                      layout: LightLayout,
                      light_parts: tuple | None = None,
                      uniq_rows=None, compact_table: torch.Tensor | None = None,
                      routed_lrows=None):
    """Postings-mode scoring -> (top edges, top scores, LWR, |L|), as
    ``finalize_postings_local`` (``rappas_tpu/place/engine.py:684-904``)
    computes it with the slot dense side.

    The light rows come from one of JAX's row sources (:767-803): the
    table ``pairs`` (or its height-split ``light_parts``) at ``lrows``;
    ``routed_lrows``, each part's part-local rows
    (:func:`routed_light_gather`); ``compact_table`` at ``lrows``, the
    inverse map into it; or ``uniq_rows``, from which that compact table
    is first gathered (:func:`gather_compact`).  A read's postings are
    then the same whatever the source, in another order on the routed
    one.  Every source holds rows of ``layout``.

    Read ``b``'s light postings (the rows ``lrows[b]`` of ``pairs``: P
    edge ids, then P bit-cast f32 deltas) are sorted by edge and summed
    per edge with the cumsum-at-segment-ends form, run in f64 (pads
    carry ``LIGHT_PAD_EDGE`` and sort to the tail); its dense row is
    ``acc_c[slot_of[b]]`` (zero when ``slot_of[b] < 0``).  A light
    edge's total is its segment sum plus the dense value there; the
    top-K is taken in the union of the K best light totals and the K
    best dense values (a stable sort puts light candidates first on
    exact ties, then the lower edge), later duplicates dropped.  ``|L|``
    counts the dense row's positive entries plus the light edges whose
    dense value is <= 0.

    Under edge-range sharding (``edge_offset``, as
    ``finalize_postings_local``'s, :739-741) ``acc_c``'s columns are the
    edges ``edge_offset .. edge_offset + E - 1``: a light edge's dense
    value is at column ``edge - edge_offset`` and dense picks are returned
    as global ids; K is ``min(keep_at_most, E)`` of the shard's width."""
    parts = light_parts if light_parts is not None else (pairs,)
    if routed_lrows is not None:
        g = routed_light_gather(parts, routed_lrows, layout)
    elif compact_table is not None:
        g = light_gather(compact_table, lrows)
    elif uniq_rows is not None:
        g = light_gather(gather_compact(parts, uniq_rows), lrows)
    else:
        g = light_gather(parts, lrows)
    B, W = g.shape[:2]
    P = layout.P
    n_slots, E = acc_c.shape
    K = min(keep_at_most, E)
    dev = g.device
    e, d = light_postings(g, layout)
    e, d = e.reshape(B, W * P), d.reshape(B, W * P)
    if W * P < K:     # a light list shorter than K: pad it with pads
        e = torch.cat([e, torch.full((B, K - W * P), int(LIGHT_PAD_EDGE),
                                     dtype=e.dtype, device=dev)], dim=1)
        d = torch.cat([d, d.new_zeros((B, K - W * P))], dim=1)
    e_s, order = torch.sort(e, dim=1, stable=True)
    # the running sums in f64: JAX's f32 cumsum gives a segment sum an
    # error of about one ulp of the read's running total (:732-737),
    # which on a long read (thousands of postings) passes 2e-4; the
    # kernel sums each segment directly
    d_s = d.gather(1, order).to(torch.float64)
    cs = torch.cumsum(d_s, dim=1)
    nxt = torch.cat([e_s[:, 1:], e_s.new_full((B, 1), -1)], dim=1)
    is_end = e_s != nxt
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                          e_s[:, 1:] != e_s[:, :-1]], dim=1)
    prev_cs = torch.cat([cs.new_zeros((B, 1)), cs[:, :-1]], dim=1)
    start_cs = torch.cummax(torch.where(
        is_start, prev_cs, torch.full_like(prev_cs, float("-inf"))),
        dim=1).values
    seg = (cs - start_cs).to(torch.float32)
    light_valid = is_end & (e_s != int(LIGHT_PAD_EDGE))
    # dense value at each light edge: a flat gather from acc_c's rows
    # (the read's slot row, or an appended zero row)
    acc_z = torch.cat([acc_c, acc_c.new_zeros((1, E))]).reshape(-1)
    srow = torch.where(slot_of >= 0, slot_of,
                       torch.full_like(slot_of, n_slots)).to(torch.int64)
    e_loc = (e_s.to(torch.int64) - edge_offset).clamp(0, E - 1)
    dense_at = acc_z[srow[:, None] * E + e_loc]
    light_total = seg + dense_at
    l_all, li = torch.sort(torch.where(
        light_valid, light_total,
        torch.full_like(light_total, float("-inf"))),
        dim=1, descending=True, stable=True)
    l_scores, l_edges = l_all[:, :K], e_s.gather(1, li[:, :K])

    h_all, hi = torch.sort(torch.where(
        acc_c > 0, acc_c, torch.full_like(acc_c, float("-inf"))),
        dim=1, descending=True, stable=True)
    has = slot_of >= 0
    sl = slot_of[has].to(torch.int64)
    h_scores = torch.full((B, K), float("-inf"), device=dev)
    h_edges = torch.zeros((B, K), dtype=e_s.dtype, device=dev)
    h_scores[has] = h_all[sl, :K]
    h_edges[has] = (hi[sl, :K] + edge_offset).to(e_s.dtype)

    cedge = torch.cat([l_edges, h_edges], dim=1)
    cscore, order = torch.sort(torch.cat([l_scores, h_scores], dim=1),
                               dim=1, descending=True, stable=True)
    cedge = cedge.gather(1, order)
    M = cedge.shape[1]
    earlier = torch.triu(torch.ones((M, M), dtype=torch.bool, device=dev),
                         1)
    isdup = ((cedge[:, :, None] == cedge[:, None, :]) &
             earlier[None]).any(dim=1)
    cscore = torch.where(isdup, torch.full_like(cscore, float("-inf")),
                         cscore)
    top_acc, ti = torch.sort(cscore, dim=1, descending=True, stable=True)
    top_acc, top_edge = top_acc[:, :K], cedge.gather(1, ti[:, :K])

    n_dense = torch.zeros(B, dtype=torch.int64, device=dev)
    n_dense[has] = (acc_c > 0).sum(dim=1)[sl]
    light_only = light_valid & (dense_at <= 0)
    n_matched = n_dense + light_only.sum(dim=1)
    Qf = (lengths - (k - 1)).to(torch.float32)
    top_scores = torch.where(torch.isfinite(top_acc),
                             Qf[:, None] * thr + top_acc, top_acc)
    return _top_out(top_scores, top_edge, n_matched)


# ====================================================================== #
# kernel wrappers
# ====================================================================== #

def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or \
            not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")


def _table_type(D: torch.Tensor) -> str:
    """The launch-name suffix of a direct or compact table: "" for f32,
    "_u16" for uint16 (whose kernel entries take a flag of 1)."""
    if D.dtype not in (torch.float32, torch.uint16) or \
            not D.is_contiguous() or D.dim() != 2:
        raise ValueError(f"D: want a contiguous f32 or uint16 table, got "
                         f"{D.dtype} {tuple(D.shape)}")
    return "_u16" if D.dtype == torch.uint16 else ""


def _launch(name: str, fn, *args) -> None:
    from rappas_tpu_torch._kernels import lib
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib().rp_error_string(err).decode()})")
    count("kernel.launch." + name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _store(acc, dest, part):
    if dest is None:
        return acc.copy_(part)
    return acc.index_copy_(0, dest.to(torch.int64), part)


def _out(D, acc, dest, B):
    if acc is None:
        if dest is not None:
            raise ValueError("dest needs acc")
        acc = torch.empty((B, D.shape[1]), dtype=torch.float32,
                          device=D.device)
    return acc


# ---- the row-sum template's slabs (csrc/accumulate.cu) ----------------- #

#: bytes of the table's columns that one slab of the row sum keeps in the
#: card's L2 (50 MB on an H100, with room for the inputs and ``acc``)
L2_SLAB_BYTES = 24 << 20
#: a slab row narrower than this does not pay for its pass: the table then
#: takes one slab (its touched rows cannot fit L2 at a useful width)
MIN_SLAB_ROW_BYTES = 128
#: threads per block of the row sum; a thread owns one chunk of one read
SUM_THREADS = 256
#: row ids staged in shared memory per block, at most
SUM_STAGE_ROWS = 4096


class SlabPlan(NamedTuple):
    """How the row-sum kernels (K1, K2, C1, C2, C3; D1 its slabs) cut one
    launch:
    ``vec`` columns per load (16 B when the row pitch and the pointers
    allow), ``cols`` columns per slab (a multiple of ``vec``, or E),
    ``n_slabs`` slabs (the slowest grid index), ``reads_per_block`` reads
    per block of :data:`SUM_THREADS` threads (one chunk of ``vec``
    columns each), ``tile`` row ids per read staged at a time, ``keep``
    whether the table's loads take the L2 ``evict_last`` priority (only
    when a slab of the rows the launch can touch fits
    :data:`L2_SLAB_BYTES`: a larger table would fill the L2 with lines
    that outrank the next kernels' data and gain no hits for it)."""
    vec: int
    cols: int
    n_slabs: int
    reads_per_block: int
    tile: int
    keep: bool

    def args(self) -> tuple:
        """The kernel entries' (vec, cols, rpb, tile, keep) arguments."""
        return (self.vec, self.cols, self.reads_per_block, self.tile,
                int(self.keep))


def slab_plan(E: int, itemsize: int, n_rows: int, n_windows: int,
              ptrs: tuple = ()) -> SlabPlan:
    """The slab plan of a row sum over a table of ``n_rows`` rows of E
    values of ``itemsize`` bytes for ``n_windows`` windows: slabs sized so
    that the columns of the rows the batch can touch (at most
    ``min(n_rows, n_windows)``) fit :data:`L2_SLAB_BYTES`, one slab when
    that would make a slab row narrower than :data:`MIN_SLAB_ROW_BYTES`;
    no slab wider than one block's threads can cover.  ``vec`` is the
    widest load (at most 16 bytes) that divides E and whose byte width
    divides every address in ``ptrs`` (the table's and the f32 output's:
    the output stores ``vec`` floats)."""
    vec = 16 // itemsize
    while vec > 1 and (E % vec or any(p % min(16, vec * s)
                                      for p, s in ptrs)):
        vec //= 2
    touched = min(n_rows, n_windows) * E * itemsize
    n = max(1, -(-touched // L2_SLAB_BYTES))
    fit = -(-(-(-E // n)) // vec) * vec   # the widest slab the budget holds
    cols = E if n == 1 or fit * itemsize < MIN_SLAB_ROW_BYTES else fit
    cols = max(1, min(cols, SUM_THREADS * vec))
    n_slabs = -(-E // cols)
    if n_slabs > 1:                   # even slabs, whole vectors
        cols = -(-(-(-E // n_slabs)) // vec) * vec
        n_slabs = -(-E // cols)
    rpb = SUM_THREADS // -(-cols // vec)
    tile = min(256, SUM_STAGE_ROWS // rpb - 2)
    return SlabPlan(vec, cols, n_slabs, rpb, tile, cols <= fit)


#: the slab plan of each row-sum kernel's last launch, by the name its
#: launches count under
SLABS: dict[str, SlabPlan] = {}


def _slabs(name: str, D: torch.Tensor, acc: torch.Tensor,
           n_windows: int) -> SlabPlan:
    plan = SLABS[name] = slab_plan(
        D.shape[1], D.element_size(), D.shape[0], n_windows,
        ((D.data_ptr(), D.element_size()), (acc.data_ptr(), 4)))
    return plan


def accumulate_packed(D: torch.Tensor, packed: torch.Tensor,
                      lengths: torch.Tensor, length: int, k: int,
                      scale: float = 1.0, acc: torch.Tensor | None = None,
                      dest: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (``csrc/accumulate.cu``): ``kmer_rows_packed`` + ``accumulate``
    (times ``scale``) of 2-bit packed DNA reads of padded length
    ``length`` on an f32 or uint16 table.  Writes row ``dest[b]`` of
    ``acc`` (row ``b`` when ``dest`` is None; a new [B, E] tensor when
    ``acc`` is None)."""
    B = packed.shape[0]
    acc = _out(D, acc, dest, B)
    opt = [t for t in (dest,) if t is not None]
    if not _on_card(D, packed, lengths, acc, *opt):
        rows = kmer_rows_packed(packed, lengths, k, 4, D.shape[0], length)
        return _store(acc, dest, accumulate(D, rows) * scale)
    E = D.shape[1]
    sfx = _table_type(D)
    _check(packed, "packed", torch.uint8, (B, -(-length // 4)))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    if dest is not None:
        _check(dest, "dest", torch.int32, (B,))
    plan = _slabs("accumulate_packed" + sfx, D, acc,
                  B * max(length - k + 1, 0))
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_packed" + sfx, lib().rp_accumulate_packed,
            D.data_ptr(), int(bool(sfx)), E, D.shape[0] - 1,
            packed.data_ptr(), packed.stride(0), lengths.data_ptr(), B,
            length, k, float(scale), _ptr(dest), acc.data_ptr(),
            *plan.args(), _stream(D))
    return acc


def accumulate_codes(D: torch.Tensor, codes: torch.Tensor, k: int,
                     n_states: int, scale: float = 1.0,
                     acc: torch.Tensor | None = None,
                     dest: torch.Tensor | None = None) -> torch.Tensor:
    """K2 (``csrc/accumulate.cu``): ``kmer_rows`` + ``accumulate`` (times
    ``scale``) of int8 state codes [B, L] on an f32 or uint16 table;
    ``acc``/``dest`` as in
    :func:`accumulate_packed`."""
    B, L = codes.shape
    acc = _out(D, acc, dest, B)
    opt = [t for t in (dest,) if t is not None]
    if not _on_card(D, codes, acc, *opt):
        rows = kmer_rows(codes, k, n_states, D.shape[0])
        return _store(acc, dest, accumulate(D, rows) * scale)
    E = D.shape[1]
    sfx = _table_type(D)
    _check(codes, "codes", torch.int8, (B, L))
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    if dest is not None:
        _check(dest, "dest", torch.int32, (B,))
    plan = _slabs("accumulate_codes" + sfx, D, acc, B * max(L - k + 1, 0))
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_codes" + sfx, lib().rp_accumulate_codes,
            D.data_ptr(), int(bool(sfx)), E, D.shape[0] - 1,
            codes.data_ptr(), B, L, k, n_states, float(scale), _ptr(dest),
            acc.data_ptr(), *plan.args(), _stream(D))
    return acc


def accumulate_compact(D: torch.Tensor, keys: torch.Tensor,
                       codes: torch.Tensor, k: int, n_states: int,
                       scale: float = 1.0,
                       rows: torch.Tensor | None = None) -> torch.Tensor:
    """C1 (``csrc/accumulate.cu``): ``accumulate(D, compact_rows(keys,
    kmer_indices64(codes, k, n_states)))`` times ``scale`` -> a new f32
    [B, E], for int8 state codes [B, L] against the compact table
    ``D[n + 1, E]`` (f32 or uint16) and its sorted int32 ``keys[n]``.
    Only for index spaces that fit int32 (``S^k <= 2^31 - 1``); above
    that the host searches the keys and :func:`accumulate_rows` sums.
    ``rows`` (int32 [B, L - k + 1]), when given, receives each window's
    table row (``n`` for a miss): on the card the resolve pass then runs
    whatever the slab plan, as it does anyway past one slab."""
    B, L = codes.shape
    opt = [t for t in (rows,) if t is not None]
    if not _on_card(D, keys, codes, *opt):
        found = compact_rows(keys, kmer_indices64(codes, k, n_states))
        if rows is not None:
            rows.copy_(found)
        return accumulate(D, found) * scale
    n, E = keys.shape[0], D.shape[1]
    sfx = _table_type(D)
    _check(keys, "keys", torch.int32, (D.shape[0] - 1,))
    _check(codes, "codes", torch.int8, (B, L))
    if n_states ** k > 2 ** 31 - 1:
        raise ValueError(f"{n_states}^{k} k-mer indices do not fit int32: "
                         "search the keys on the host (accumulate_rows)")
    acc = torch.empty((B, E), dtype=torch.float32, device=D.device)
    Q = max(L - k + 1, 0)
    plan = _slabs("accumulate_compact" + sfx, D, acc, B * Q)
    # more than one slab: resolve the rows once (int32 [B, Q]), so the
    # key search does not run per slab
    if rows is not None:
        _check(rows, "rows", torch.int32, (B, Q))
    elif plan.n_slabs > 1:
        rows = torch.empty((B, Q), dtype=torch.int32, device=D.device)
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_compact" + sfx, lib().rp_accumulate_compact,
            D.data_ptr(), int(bool(sfx)), E, keys.data_ptr(), n,
            codes.data_ptr(), B, L, k, n_states, float(scale),
            acc.data_ptr(), _ptr(rows), *plan.args(), _stream(D))
    return acc


def accumulate_rows(D: torch.Tensor, rows: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """C2 (``csrc/accumulate.cu``): ``accumulate(D, rows)`` times
    ``scale`` -> a new f32 [B, E], for int32 rows [B, Q] of an f32 or
    uint16 table that the host looked up (a miss is the last row)."""
    B, Q = rows.shape
    if not _on_card(D, rows):
        return accumulate(D, rows) * scale
    E = D.shape[1]
    sfx = _table_type(D)
    _check(rows, "rows", torch.int32, (B, Q))
    acc = torch.empty((B, E), dtype=torch.float32, device=D.device)
    plan = _slabs("accumulate_rows" + sfx, D, acc, B * Q)
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_rows" + sfx, lib().rp_accumulate_rows,
            D.data_ptr(), int(bool(sfx)), E, D.shape[0] - 1,
            rows.data_ptr(), B, Q, float(scale), acc.data_ptr(),
            *plan.args(), _stream(D))
    return acc


def accumulate_rows_range(D: torch.Tensor, rows: torch.Tensor, lo: int,
                          per: int) -> torch.Tensor:
    """C3 (``csrc/accumulate.cu``): :func:`accumulate_range` -> a new f32
    [B, E], one k-mer-range shard's partial sums: int32 global rows [B, Q]
    of the compact table (host-searched; a miss is ``n_kmers``) against the
    f32 shard ``D[per + 1, E]`` that holds global rows ``lo .. lo + per -
    1``."""
    B, Q = rows.shape
    if not _on_card(D, rows):
        return accumulate_range(D, rows, lo, per)
    E = D.shape[1]
    _check(D, "D", torch.float32, (per + 1, E))
    _check(rows, "rows", torch.int32, (B, Q))
    acc = torch.empty((B, E), dtype=torch.float32, device=D.device)
    plan = _slabs("accumulate_rows_range", D, acc, B * Q)
    from rappas_tpu_torch._kernels import lib
    _launch("accumulate_rows_range", lib().rp_accumulate_rows_range,
            D.data_ptr(), E, rows.data_ptr(), B, Q, int(lo), int(per),
            acc.data_ptr(), *plan.args(), _stream(D))
    return acc


def wire_format(n_edges: int, keep_at_most: int,
                n_cols: int | None = None) -> tuple[int, bool, int]:
    """The wire of a DB with ``n_edges`` edge slots, the one place that
    decides it: ``(K, wide, words per read)``.  ``K = min(keep_at_most,
    n_cols)``, where ``n_cols`` (default ``n_edges``) is the width scored,
    one edge-range shard's under sharding; ``wide`` (int32 edge ids) when
    the DB's ids do not fit u16; the row width is :func:`pack_wire`'s.
    The kernels take ``wide`` and the width from here."""
    K = min(keep_at_most, n_edges if n_cols is None else n_cols)
    wide = n_edges >= WIDE_EDGES
    return K, wide, (2 * K + 1 if wide else K + (K + 1) // 2 + 1)


def finalize_wire(acc: torch.Tensor, lengths: torch.Tensor, thr: float,
                  k: int, keep_at_most: int) -> torch.Tensor:
    """K3 (``csrc/finalize.cu``): ``pack_wire(*finalize(...))`` -> int32
    [B, words] in the wire of :func:`wire_format`.  On the card a group of 8
    lanes reads each row once."""
    B, E = acc.shape
    K, wide, n_words = wire_format(E, keep_at_most)
    if not _on_card(acc, lengths):
        thr_t = torch.tensor(thr, dtype=torch.float32)
        return pack_wire(*finalize(acc, lengths, thr_t, k, keep_at_most),
                         wide=wide)
    _check(acc, "acc", torch.float32, (B, E))
    _check(lengths, "lengths", torch.int32, (B,))
    wire = torch.empty((B, n_words), dtype=torch.int32, device=acc.device)
    from rappas_tpu_torch._kernels import lib
    _launch("finalize_wire", lib().rp_finalize_wire, acc.data_ptr(), B, E,
            lengths.data_ptr(), float(thr), k, K, n_words, int(wide),
            wire.data_ptr(), _stream(acc))
    return wire


def _alt_win(win_off: torch.Tensor) -> torch.Tensor:
    """Each alternative's window id, from the windows' CSR offsets."""
    n_win = win_off.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n_win, device=win_off.device),
        (win_off[1:] - win_off[:-1]).to(torch.int64))


#: threads per block of the ambiguity kernels (``csrc/ambiguous.cu``)
AMB_THREADS = 256


def ambiguous_plan(E: int, itemsize: int, ptrs: tuple = ()) -> tuple:
    """How K4 and A1 (split) cut a launch (``csrc/ambiguous.cu``): ``(vec,
    group)`` -- ``vec`` values of ``itemsize`` bytes per load, the widest
    load of at most 16 bytes that divides E and whose byte width divides
    every table address in ``ptrs``; ``group`` threads per window, one
    per load of a row, at most a block (the exp2 of every alternative at a
    column is the work: a window spread over fewer threads runs it in
    sequence, and idle threads in a window's warps waste their issue
    slots)."""
    vec = 16 // itemsize
    while vec > 1 and (E % vec or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    return vec, max(1, min(AMB_THREADS, E // vec))


def _check_windows(acc, E, alt_rows, win_off, win_dest, win_inv_w,
                   win_is_mean) -> None:
    """The argument checks of K4, P2 and their split instances."""
    n_win = win_dest.shape[0]
    _check(acc, "acc", torch.float32, (acc.shape[0], E))
    for name, rows in alt_rows.items():
        _check(rows, name, torch.int32, (rows.shape[0],))
    _check(win_off, "win_off", torch.int32, (n_win + 1,))
    _check(win_dest, "win_dest", torch.int32, (n_win,))
    _check(win_inv_w, "win_inv_w", torch.float32, (n_win,))
    _check(win_is_mean, "win_is_mean", torch.uint8, (n_win,))


def ambiguous_pass_(acc: torch.Tensor, D: torch.Tensor, scale: float,
                    alt_rows: torch.Tensor, win_off: torch.Tensor,
                    win_read: torch.Tensor, win_inv_w: torch.Tensor,
                    win_is_mean: torch.Tensor) -> torch.Tensor:
    """K4 (``csrc/ambiguous.cu``): ``ambiguous_pass(alt_delta_rows(D,
    scale, alt_rows), ...)`` added into ``acc`` IN PLACE; returns ``acc``.
    ``D`` is a direct or compact table, f32 or uint16.

    Window ``w`` owns alternatives ``win_off[w] .. win_off[w + 1]``
    (``alt_win`` as CSR offsets).  On the card the adds are atomic, so
    their order -- and the last bits of a read's sum over several
    windows -- varies from run to run; the loads follow
    :func:`ambiguous_plan`."""
    n_win = win_read.shape[0]
    if not _on_card(acc, D, alt_rows, win_off, win_read, win_inv_w,
                    win_is_mean):
        return acc.copy_(ambiguous_pass(
            alt_delta_rows(D, scale, alt_rows), _alt_win(win_off), win_read,
            win_inv_w, win_is_mean, acc))
    E = D.shape[1]
    sfx = _table_type(D)
    _check_windows(acc, E, {"alt_rows": alt_rows}, win_off, win_read,
                   win_inv_w, win_is_mean)
    vec, group = ambiguous_plan(E, D.element_size(), (D.data_ptr(),))
    from rappas_tpu_torch._kernels import lib
    _launch("ambiguous_pass" + sfx, lib().rp_ambiguous_pass, D.data_ptr(),
            int(bool(sfx)), E, float(scale), alt_rows.data_ptr(),
            win_off.data_ptr(), win_read.data_ptr(), win_inv_w.data_ptr(),
            win_is_mean.data_ptr(), n_win, acc.data_ptr(), vec, group,
            _stream(acc))
    return acc


# ---- height-split tables ---------------------------------------------- #

class Parts(NamedTuple):
    """A table height-split into parts, as the split kernels take it:
    ``tables`` the parts (contiguous 2-D tensors of one dtype and width on
    one device) and ``meta`` int64[3, n] on that device -- each part's
    base address, its height (the rows a global row can select: every row
    of a light part, the body of a direct part without its trailing zero
    row) and its first global row (the heights summed before it)."""
    tables: tuple
    meta: torch.Tensor


def make_parts(tables, heights) -> Parts:
    """:class:`Parts` of ``tables`` with the given heights."""
    heights = [int(h) for h in heights]
    first = np.concatenate([[0], np.cumsum(heights)[:-1]]).astype(np.int64)
    meta = torch.tensor([[t.data_ptr() for t in tables], heights,
                         first.tolist()], dtype=torch.int64)
    return Parts(tuple(tables), meta.to(tables[0].device))


def _check_parts(parts: Parts) -> torch.Tensor:
    """Checks the parts' layout; returns the first part."""
    t0 = parts.tables[0]
    _check(parts.meta, "parts.meta", torch.int64, (3, len(parts.tables)))
    for t in parts.tables:
        if (t.device != parts.meta.device or t.dtype != t0.dtype or
                t.dim() != 2 or t.shape[1] != t0.shape[1] or
                not t.is_contiguous()):
            raise ValueError(f"parts: want contiguous 2-D {t0.dtype} parts "
                             f"of width {t0.shape[1]} on {parts.meta.device}"
                             f", got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return t0


def routed_accumulate_(parts: Parts, routed: torch.Tensor,
                       scale: float = 1.0) -> torch.Tensor:
    """D1 (``csrc/accumulate.cu``): ``routed_accumulate(parts.tables,
    routed)`` times ``scale`` -> a new f32 [B, E], for the parts of a
    split direct table (f32 or uint16, each its body rows plus a trailing
    zero row) and their routed part-LOCAL rows int32[n_parts, B, W] (pads
    ``>=`` the part's height).  On the card one launch: the blocks the
    card holds at once each own a group of reads and walk the parts in
    order, whole rows at a time (:func:`routed_plan`; :data:`SLABS` keeps
    it); per column each part's windows are summed, the part sums added in
    part order, as JAX does, and scaled once."""
    n, B, W = routed.shape
    if not _on_card(parts.meta, routed):
        return routed_accumulate(parts.tables, tuple(routed)) * scale
    t0 = _check_parts(parts)
    sfx = _table_type(t0)
    E = t0.shape[1]
    _check(routed, "routed", torch.int32, (len(parts.tables), B, W))
    acc = torch.empty((B, E), dtype=torch.float32, device=t0.device)
    plan = SLABS["routed_accumulate" + sfx] = routed_plan(
        E, t0.element_size(), tuple(t.data_ptr() for t in parts.tables) +
        (acc.data_ptr(),))
    from rappas_tpu_torch._kernels import lib
    _launch("routed_accumulate" + sfx, lib().rp_routed_accumulate,
            parts.meta.data_ptr(), n, int(bool(sfx)), E, routed.data_ptr(),
            B, W, float(scale), acc.data_ptr(), plan.vec, plan.cols,
            _stream(t0))
    return acc


def routed_plan(E: int, itemsize: int, ptrs: tuple = ()) -> SlabPlan:
    """D1's column plan: whole rows (one slab) up to one block's
    :data:`SUM_THREADS` loads of ``vec`` values, where ``vec`` is
    :func:`slab_plan`'s widest load for the tables' and the output's
    addresses ``ptrs``; the table's loads at the normal L2 priority (a
    split table is past L2 by construction).  Slabs of the part measured
    slower on the card: each re-stages the routed rows, and narrower row
    pieces cost HBM efficiency that the L2 reuse does not repay."""
    vec = slab_plan(E, itemsize, 1, 1, tuple((p, itemsize) for p in ptrs[:-1])
                    + tuple((p, 4) for p in ptrs[-1:])).vec
    cols = min(E, SUM_THREADS * vec)
    n_slabs = -(-E // cols)
    return SlabPlan(vec, cols, n_slabs, 0, 0, False)


def ambiguous_pass_split_(acc: torch.Tensor, parts: Parts, scale: float,
                          alt_rows: torch.Tensor, win_off: torch.Tensor,
                          win_read: torch.Tensor, win_inv_w: torch.Tensor,
                          win_is_mean: torch.Tensor) -> torch.Tensor:
    """A1 (``csrc/ambiguous.cu``, K4's kernel with a split row source):
    ``ambiguous_pass(alt_delta_rows_split(parts.tables, scale, alt_rows),
    ...)`` added into ``acc`` IN PLACE, as :func:`ambiguous_pass_`;
    ``alt_rows`` are global body rows (the miss row is the total body
    height)."""
    n_win = win_read.shape[0]
    if not _on_card(acc, parts.meta, alt_rows, win_off, win_read, win_inv_w,
                    win_is_mean):
        return acc.copy_(ambiguous_pass(
            alt_delta_rows_split(parts.tables, scale, alt_rows),
            _alt_win(win_off), win_read, win_inv_w, win_is_mean, acc))
    t0 = _check_parts(parts)
    sfx = _table_type(t0)
    E = t0.shape[1]
    _check_windows(acc, E, {"alt_rows": alt_rows}, win_off, win_read,
                   win_inv_w, win_is_mean)
    vec, group = ambiguous_plan(E, t0.element_size(),
                                tuple(t.data_ptr() for t in parts.tables))
    from rappas_tpu_torch._kernels import lib
    _launch("ambiguous_pass_split" + sfx, lib().rp_ambiguous_pass_split,
            parts.meta.data_ptr(), len(parts.tables), int(bool(sfx)), E,
            float(scale), alt_rows.data_ptr(), win_off.data_ptr(),
            win_read.data_ptr(), win_inv_w.data_ptr(),
            win_is_mean.data_ptr(), n_win, acc.data_ptr(), vec, group,
            _stream(acc))
    return acc


# ---- postings layout -------------------------------------------------- #

#: sort slots per read that P3 keeps in one block's shared memory at
#: most: 12 bytes each (the 64-bit key and the f32 total), under the 227
#: KB a block can take with room for the candidate lists
SMEM_PAIRS = 16384
#: sort slots per read that P3's warp path takes at most (a power of two:
#: csrc/postings.cu's kWarpMaxPairs); reads with more postings take the
#: block path
WARP_PAIRS = 1024


class PostingsPlan(NamedTuple):
    """Where P3 scores each read: the warp path (a warp per read, its sort
    region ``warp_pairs`` slots of shared memory; -1: no read takes it),
    or the block path for the reads ``block_reads`` (int32, or None: none)
    -- in ``smem_pairs`` slots of one block's shared memory, or, for the
    reads that do not fit, in their regions of a global scratch of
    ``n_scratch`` slots at ``scratch_off`` int64[B + 1] (an empty range:
    shared memory; None: no read in the scratch).  The tensors lie where
    P3 runs.  ``postings``: the real light postings of the batch's reads,
    which P3 gathers."""
    warp_pairs: int
    smem_pairs: int
    scratch_off: torch.Tensor | None
    n_scratch: int
    block_reads: torch.Tensor | None
    postings: int = 0

    #: the plan's tensors, by the names under which the engine stages them
    ARRAYS = ("scratch_off", "block_reads")

    def tensors(self) -> dict:
        """The plan's tensors that are present, by name."""
        return {n: getattr(self, n) for n in self.ARRAYS
                if getattr(self, n) is not None}

    def to(self, device) -> "PostingsPlan":
        moved = {n: t.to(device) for n, t in self.tensors().items()}
        return self._replace(**moved) if moved else self

    def staged(self, dev: dict) -> "PostingsPlan":
        """The plan with its tensors taken from ``dev``, a batch's staged
        arrays (:func:`rappas_tpu_torch.place.engine.stage`)."""
        return self._replace(**{n: dev[n] for n in self.ARRAYS if n in dev})

    def paths(self, B: int, live=None) -> dict:
        """Reads per path of a batch of ``B``: ``warp``, ``block`` (shared
        memory) and ``scratch``; of the reads ``live`` (bool[B]) only, if
        given."""
        block = np.zeros(B, bool)
        if self.block_reads is not None:
            block[self.block_reads.cpu().numpy()] = True
        scratch = np.zeros(B, bool)
        if self.scratch_off is not None:
            so = self.scratch_off.cpu().numpy()
            scratch = so[1:] > so[:-1]
        live = np.ones(B, bool) if live is None else np.asarray(live, bool)
        return {"warp": int(np.count_nonzero(live & ~block)),
                "block": int(np.count_nonzero(live & block & ~scratch)),
                "scratch": int(np.count_nonzero(live & scratch))}


def _pow2(n):
    """Smallest power of two >= n, elementwise (0 stays 0)."""
    n = np.asarray(n, np.int64)
    return np.where(n > 0, 1 << np.ceil(np.log2(np.maximum(n, 1)))
                    .astype(np.int64), 0)


def postings_plan(pairs_per_read, smem_pairs: int = SMEM_PAIRS,
                  warp_pairs: int = WARP_PAIRS) -> PostingsPlan:
    """P3's plan from each read's count of real light postings: a read
    sorts on the warp path when the power of two at least that large fits
    ``warp_pairs`` slots (0: no warp path), else on the block path, in
    shared memory when that power of two fits ``smem_pairs`` slots, else
    in a region of the global scratch that holds its postings and no more
    (the block path never stores the sort's pads; the tensors on the CPU:
    :meth:`PostingsPlan.to` moves them)."""
    if warp_pairs > WARP_PAIRS:
        raise ValueError(f"warp_pairs {warp_pairs} > {WARP_PAIRS}, the "
                         "warp path's largest region")
    pairs = np.asarray(pairs_per_read, np.int64)
    need = _pow2(pairs)
    postings = int(pairs.sum())
    warp = (need <= warp_pairs) & (warp_pairs > 0)
    w_cap = int(need[warp].max()) if warp.any() else -1
    block = ~warp
    small = block & (need <= smem_pairs)
    cap = int(need[small].max()) if small.any() else 0
    reads = (torch.from_numpy(np.flatnonzero(block).astype(np.int32))
             if block.any() else None)
    big = block & ~small
    if not big.any():
        return PostingsPlan(w_cap, cap, None, 0, reads, postings)
    off = np.zeros(need.shape[0] + 1, np.int64)
    np.cumsum(np.where(big, pairs, 0), out=off[1:])
    return PostingsPlan(w_cap, cap, torch.from_numpy(off), int(off[-1]),
                        reads, postings)


def dense_side(heavy_dense: torch.Tensor, hrows: torch.Tensor,
               hoff: torch.Tensor) -> torch.Tensor:
    """P1 (``csrc/postings.cu``): ``scatter_slots(gather_rows(heavy_dense,
    hrows), slots, n_slots)`` -> the slot accumulator f32[n_slots, E],
    where slot ``s`` owns the heavy rows ``hrows[hoff[s] .. hoff[s + 1]]``
    (``hoff`` int32[n_slots + 1], CSR offsets).  On the card a warp per
    column tile of a slot sums its rows in order from 0 (no atomics), so
    the result is the in-order f32 sum and a slot with no rows is zero."""
    n_slots = hoff.shape[0] - 1
    E = heavy_dense.shape[1]
    if not _on_card(heavy_dense, hrows, hoff):
        slots = torch.repeat_interleave(
            torch.arange(n_slots, device=hoff.device),
            (hoff[1:] - hoff[:-1]).to(torch.int64))
        return scatter_slots(gather_rows(heavy_dense, hrows), slots, n_slots)
    _check(heavy_dense, "heavy_dense", torch.float32, tuple(heavy_dense.shape))
    _check(hrows, "hrows", torch.int32, (hrows.shape[0],))
    _check(hoff, "hoff", torch.int32, (n_slots + 1,))
    acc_c = torch.empty((n_slots, E), dtype=torch.float32,
                        device=heavy_dense.device)
    from rappas_tpu_torch._kernels import lib
    _launch("dense_side", lib().rp_dense_side, heavy_dense.data_ptr(), E,
            hrows.data_ptr(), hoff.data_ptr(), n_slots, acc_c.data_ptr(),
            _stream(heavy_dense))
    return acc_c


def ambiguous_postings_(acc_c: torch.Tensor, heavy_dense: torch.Tensor,
                        pairs: torch.Tensor, alt_lrows: torch.Tensor,
                        alt_hrows: torch.Tensor, win_off: torch.Tensor,
                        win_slot: torch.Tensor, win_inv_w: torch.Tensor,
                        win_is_mean: torch.Tensor,
                        edge_offset: int = 0, *,
                        layout: LightLayout) -> torch.Tensor:
    """P2 (``csrc/ambiguous.cu``, the postings kernel):
    ``ambiguous_pass(alt_delta_rows_postings(pairs, heavy_dense,
    alt_lrows, alt_hrows), alt_win, win_slot, ...)`` added into ``acc_c``
    IN PLACE; returns ``acc_c``.  Window ``w`` owns alternatives
    ``win_off[w] .. win_off[w + 1]`` and adds into slot ``win_slot[w]``;
    on the card a window is scored on the columns its light postings hit
    (all columns when an alternative is heavy, the row ``heavy_dense``'s
    last, zero row marking a light one), and the adds are atomic, as in
    K4.  ``edge_offset``: the global id of column 0 on an edge-range
    shard (0 on one device); ``pairs`` holds rows of ``layout``."""
    n_win = win_slot.shape[0]
    if not _on_card(acc_c, heavy_dense, pairs, alt_lrows, alt_hrows,
                    win_off, win_slot, win_inv_w, win_is_mean):
        return acc_c.copy_(ambiguous_pass(
            alt_delta_rows_postings(pairs, heavy_dense, alt_lrows,
                                    alt_hrows, edge_offset, layout=layout),
            _alt_win(win_off), win_slot, win_inv_w, win_is_mean, acc_c))
    E = heavy_dense.shape[1]
    _check(heavy_dense, "heavy_dense", torch.float32, tuple(heavy_dense.shape))
    _check(pairs, "pairs", torch.int32, (pairs.shape[0], layout.words))
    _check_windows(acc_c, E, {"alt_lrows": alt_lrows, "alt_hrows": alt_hrows},
                   win_off, win_slot, win_inv_w, win_is_mean)
    _check(alt_hrows, "alt_hrows", torch.int32, alt_lrows.shape)
    from rappas_tpu_torch._kernels import lib
    _launch("ambiguous_postings", lib().rp_ambiguous_postings,
            heavy_dense.data_ptr(), E, heavy_dense.shape[0] - 1,
            pairs.data_ptr(), layout.P, int(layout.narrow),
            alt_lrows.data_ptr(), alt_hrows.data_ptr(), win_off.data_ptr(),
            win_slot.data_ptr(), win_inv_w.data_ptr(),
            win_is_mean.data_ptr(), n_win, int(edge_offset), acc_c.data_ptr(),
            _stream(acc_c))
    return acc_c


def _check_light_parts(parts: Parts, layout: LightLayout) -> torch.Tensor:
    """Checks a split light table's parts against ``layout``; returns the
    first part."""
    t0 = _check_parts(parts)
    _check(t0, "parts[0]", torch.int32, (t0.shape[0], layout.words))
    return t0


def ambiguous_postings_parts_(acc_c: torch.Tensor, heavy_dense: torch.Tensor,
                              parts: Parts, alt_lrows: torch.Tensor,
                              alt_hrows: torch.Tensor, win_off: torch.Tensor,
                              win_slot: torch.Tensor, win_inv_w: torch.Tensor,
                              win_is_mean: torch.Tensor, *,
                              layout: LightLayout) -> torch.Tensor:
    """A1 (``csrc/ambiguous.cu``, P2 with a split light table):
    :func:`ambiguous_postings_` with the light rows ``alt_lrows`` global
    rows of the height-split light table ``parts``
    (``alt_delta_rows_postings`` over ``light_gather``'s part select,
    ``rappas_tpu/place/engine.py:950-964``; one device, edge offset 0)."""
    n_win = win_slot.shape[0]
    if not _on_card(acc_c, heavy_dense, parts.meta, alt_lrows, alt_hrows,
                    win_off, win_slot, win_inv_w, win_is_mean):
        return acc_c.copy_(ambiguous_pass(
            alt_delta_rows_postings(parts.tables, heavy_dense, alt_lrows,
                                    alt_hrows, layout=layout),
            _alt_win(win_off), win_slot, win_inv_w, win_is_mean, acc_c))
    E = heavy_dense.shape[1]
    _check_light_parts(parts, layout)
    _check(heavy_dense, "heavy_dense", torch.float32, tuple(heavy_dense.shape))
    _check_windows(acc_c, E, {"alt_lrows": alt_lrows, "alt_hrows": alt_hrows},
                   win_off, win_slot, win_inv_w, win_is_mean)
    _check(alt_hrows, "alt_hrows", torch.int32, alt_lrows.shape)
    from rappas_tpu_torch._kernels import lib
    _launch("ambiguous_postings_parts", lib().rp_ambiguous_postings_parts,
            heavy_dense.data_ptr(), E, heavy_dense.shape[0] - 1,
            parts.meta.data_ptr(), len(parts.tables), layout.P,
            int(layout.narrow), alt_lrows.data_ptr(),
            alt_hrows.data_ptr(), win_off.data_ptr(), win_slot.data_ptr(),
            win_inv_w.data_ptr(), win_is_mean.data_ptr(), n_win,
            acc_c.data_ptr(), _stream(acc_c))
    return acc_c


def _p3(name: str, fn, head: tuple, B: int, acc_c, slot_of, lengths, thr,
        k, keep_at_most, plan, edge_offset=0, n_edges=None) -> torch.Tensor:
    """Checks and launches one P3 instance; ``head`` its row-source
    arguments (the layout's P and edge width among them).  Returns the
    wire."""
    n_slots, E = acc_c.shape
    K, wide, n_words = wire_format(E if n_edges is None else n_edges,
                                   keep_at_most, E)
    so, reads = plan.scratch_off, plan.block_reads
    _check(acc_c, "acc_c", torch.float32, (n_slots, E))
    _check(slot_of, "slot_of", torch.int32, (B,))
    _check(lengths, "lengths", torch.int32, (B,))
    if so is not None:
        _check(so, "plan.scratch_off", torch.int64, (B + 1,))
    if reads is not None:
        _check(reads, "plan.block_reads", torch.int32, (reads.shape[0],))
    keys = torch.empty(plan.n_scratch, dtype=torch.int64, device=acc_c.device)
    tot = torch.empty(plan.n_scratch, dtype=torch.float32,
                      device=acc_c.device)
    wire = torch.empty((B, n_words), dtype=torch.int32, device=acc_c.device)
    _launch(name, fn, *head, acc_c.data_ptr(), E, slot_of.data_ptr(),
            lengths.data_ptr(), float(thr), k, K, plan.warp_pairs,
            plan.smem_pairs, _ptr(so), keys.data_ptr(), tot.data_ptr(),
            _ptr(reads), 0 if reads is None else reads.shape[0], n_words,
            int(wide), int(edge_offset), wire.data_ptr(), _stream(acc_c))
    return wire


def _p3_plain(acc_c, slot_of, lengths, thr, k, keep_at_most, edge_offset,
              n_edges, pairs, lrows, **source) -> torch.Tensor:
    E = acc_c.shape[1]
    _, wide, _ = wire_format(E if n_edges is None else n_edges,
                             keep_at_most, E)
    thr_t = torch.tensor(thr, dtype=torch.float32)
    return pack_wire(*finalize_postings(pairs, lrows, acc_c, slot_of,
                                        lengths, thr_t, k, keep_at_most,
                                        edge_offset, **source), wide=wide)


def finalize_postings_wire(pairs: torch.Tensor, lrows: torch.Tensor,
                           acc_c: torch.Tensor, slot_of: torch.Tensor,
                           lengths: torch.Tensor, thr: float, k: int,
                           keep_at_most: int, plan: PostingsPlan,
                           edge_offset: int = 0,
                           n_edges: int | None = None,
                           miss: int | None = None, *,
                           layout: LightLayout) -> torch.Tensor:
    """P3 (``csrc/postings.cu``): ``pack_wire(*finalize_postings(...))``
    -> int32 [B, words] in the wire of :func:`wire_format`.  On an
    edge-range shard ``acc_c`` holds the edges ``edge_offset ..
    edge_offset + E - 1`` of a DB of ``n_edges`` edge slots (default E):
    the wire carries global ids, K of the shard's width, and is wide when
    ``n_edges`` is.  ``pairs`` holds light rows of ``layout``.  ``miss``
    (default: the table's last row) is a row of
    ``pairs`` that holds only pads, which the card skips, or -1 for none;
    on the two-stage path ``pairs`` is the batch's compact table and the
    light miss row sits among its rows, if at all.

    ``plan`` (:func:`postings_plan` of the reads' real light posting
    counts, its tensors on the tensors' device) says where each read
    sorts on the card; the plain version needs none.  A read with more
    postings than its plan gives it makes the kernel write ``|L| = -1``,
    which :func:`unpack_wire` rejects."""
    B, W = lrows.shape
    if not _on_card(pairs, lrows, acc_c, slot_of, lengths,
                    *plan.tensors().values()):
        return _p3_plain(acc_c, slot_of, lengths, thr, k, keep_at_most,
                         edge_offset, n_edges, pairs, lrows, layout=layout)
    _check(pairs, "pairs", torch.int32, (pairs.shape[0], layout.words))
    _check(lrows, "lrows", torch.int32, (B, W))
    from rappas_tpu_torch._kernels import lib
    return _p3("finalize_postings_wire", lib().rp_finalize_postings,
               (pairs.data_ptr(), layout.P, int(layout.narrow),
                pairs.shape[0] - 1 if miss is None else int(miss),
                lrows.data_ptr(), B, W),
               B, acc_c, slot_of, lengths, thr, k, keep_at_most, plan,
               edge_offset, n_edges)


def finalize_postings_wire_routed(parts: Parts, routed: torch.Tensor,
                                  acc_c: torch.Tensor, slot_of: torch.Tensor,
                                  lengths: torch.Tensor, thr: float, k: int,
                                  keep_at_most: int,
                                  plan: PostingsPlan, *,
                                  layout: LightLayout) -> torch.Tensor:
    """R1 (``csrc/postings.cu``, P3 with a routed row source):
    ``finalize_postings_routed`` + ``pack_wire``
    (``rappas_tpu/place/engine.py:609-651``) -> the wire, one device.
    ``routed`` int32[n_parts, B, W]: part ``p``'s part-LOCAL light rows of
    each read, pad slots ``>= H_p`` (no postings).  P3 sorts each read's
    postings by (edge, delta bits), so on the card the wire equals the
    one-table P3's bitwise."""
    n, B, W = routed.shape
    if not _on_card(parts.meta, routed, acc_c, slot_of, lengths,
                    *plan.tensors().values()):
        return _p3_plain(acc_c, slot_of, lengths, thr, k, keep_at_most, 0,
                         None, None, None, layout=layout,
                         light_parts=parts.tables,
                         routed_lrows=tuple(routed))
    _check_light_parts(parts, layout)
    _check(routed, "routed", torch.int32, (len(parts.tables), B, W))
    from rappas_tpu_torch._kernels import lib
    return _p3("finalize_postings_wire_routed",
               lib().rp_finalize_postings_split,
               (1, parts.meta.data_ptr(), n, layout.P, int(layout.narrow), -1,
                routed.data_ptr(), B, W),
               B, acc_c, slot_of, lengths, thr, k, keep_at_most, plan)


def finalize_postings_wire_parts(parts: Parts, lrows: torch.Tensor,
                                 acc_c: torch.Tensor, slot_of: torch.Tensor,
                                 lengths: torch.Tensor, thr: float, k: int,
                                 keep_at_most: int, plan: PostingsPlan,
                                 miss: int = -1, *,
                                 layout: LightLayout) -> torch.Tensor:
    """R1 (``csrc/postings.cu``, P3 with a part-select row source): the
    select fallback, ``light_gather`` over the parts +
    ``finalize_postings_v2`` with ``uniq_rows=None`` + ``pack_wire``
    (``rappas_tpu/place/engine.py:535-554, 654-681``) -> the wire, one
    device.  ``lrows`` int32[B, W] are global rows of the split light
    table; ``miss`` (the global miss row ``nl``, or -1) is skipped on the
    card."""
    B, W = lrows.shape
    if not _on_card(parts.meta, lrows, acc_c, slot_of, lengths,
                    *plan.tensors().values()):
        return _p3_plain(acc_c, slot_of, lengths, thr, k, keep_at_most, 0,
                         None, None, lrows, layout=layout,
                         light_parts=parts.tables)
    _check_light_parts(parts, layout)
    _check(lrows, "lrows", torch.int32, (B, W))
    from rappas_tpu_torch._kernels import lib
    return _p3("finalize_postings_wire_parts",
               lib().rp_finalize_postings_split,
               (0, parts.meta.data_ptr(), len(parts.tables), layout.P,
                int(layout.narrow), int(miss), lrows.data_ptr(), B, W),
               B, acc_c, slot_of, lengths, thr, k, keep_at_most, plan)


def gather_compact_(parts: Parts, uniq: torch.Tensor,
                    uniq_off: torch.Tensor) -> torch.Tensor:
    """G1 (``csrc/postings.cu``): the batch-unique compact table int32[U,
    w] of ``gather_compact`` (``rappas_tpu/place/engine.py:557-570``),
    whole rows of the parts' ``w`` words whatever their layout:
    ``uniq`` int32[U] holds part ``i``'s part-LOCAL rows at ``uniq_off[i]
    .. uniq_off[i + 1]`` (``uniq_off`` int32[n_parts + 1]); each is copied
    from its own part, in order."""
    U = uniq.shape[0]
    if not _on_card(parts.meta, uniq, uniq_off):
        bounds = uniq_off.tolist()
        return gather_compact(parts.tables, tuple(
            uniq[a:b] for a, b in zip(bounds[:-1], bounds[1:])))
    t0 = _check_parts(parts)
    _check(t0, "parts[0]", torch.int32, tuple(t0.shape))
    _check(uniq, "uniq", torch.int32, (U,))
    _check(uniq_off, "uniq_off", torch.int32, (len(parts.tables) + 1,))
    row_bytes = 4 * t0.shape[1]
    load = next(b for b in (16, 8, 4) if row_bytes % b == 0)
    if any(t.data_ptr() % load for t in parts.tables):
        raise ValueError(f"parts: want rows copied in {load}-byte loads, "
                         f"every part on a {load}-byte boundary; got rows "
                         f"of {row_bytes} bytes")
    out = torch.empty((U, t0.shape[1]), dtype=torch.int32, device=t0.device)
    from rappas_tpu_torch._kernels import lib
    _launch("gather_compact", lib().rp_gather_compact, parts.meta.data_ptr(),
            len(parts.tables), t0.shape[1], uniq.data_ptr(),
            uniq_off.data_ptr(), U, out.data_ptr(), _stream(uniq))
    return out


def merge_candidates_wire(wires: torch.Tensor, K_in: int, keep: int,
                          wide: bool) -> torch.Tensor:
    """M1 (``csrc/merge.cu``): the merged wire int32 [B, words] of ``keep``
    candidates from the shards' wires ``wires`` int32 [mp, B, words_in]
    (each of ``K_in`` candidates, :func:`finalize_postings_wire` on one
    edge-range shard, stacked in shard order): ``pack_wire(
    *merge_candidates(...))`` of their decoded fields."""
    mp, B, w_in = wires.shape
    if keep > mp * K_in:
        raise ValueError(f"keep {keep} > {mp} shards x {K_in} candidates")
    n_words = 2 * keep + 1 if wide else keep + (keep + 1) // 2 + 1
    if not _on_card(wires):
        parts = [wire_fields(wires[j], K_in, wide) for j in range(mp)]
        return pack_wire(*merge_candidates(
            torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1),
            torch.stack([p[2] for p in parts]), keep), wide=wide)
    _check(wires, "wires", torch.int32, (mp, B, w_in))
    if w_in != (2 * K_in + 1 if wide else K_in + (K_in + 1) // 2 + 1):
        raise ValueError(f"wires: {w_in} words is not a wire of {K_in}")
    out = torch.empty((B, n_words), dtype=torch.int32, device=wires.device)
    from rappas_tpu_torch._kernels import lib
    _launch("merge_candidates_wire", lib().rp_merge_candidates,
            wires.data_ptr(), mp, B, K_in, w_in, keep, n_words, int(wide),
            out.data_ptr(), _stream(wires))
    return out
