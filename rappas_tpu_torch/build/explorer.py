"""Phylo-kmer enumeration: all k-mers whose posterior product passes the
threshold, per ghost node.

Reference algorithm: ``WordExplorer_v3.exploreWords``
(``core/algos/WordExplorer_v3.java:98-199``), a
branch-and-bound recursion over (site, state) with f32 log10 accumulation,
registering a word when the full sum is ``>= log10((omega/S)^k)``.

Two interchangeable implementations:

* :func:`explore_node` -- **vectorized frontier expansion** (numpy): all
  start positions advance depth-by-depth simultaneously; at each depth the
  frontier (start, prefix-sum, packed-prefix) is expanded by every state of
  the next site and pruned against the threshold.  Because log10
  posteriors are <= 0, partial-sum pruning is exact: the produced word
  *set and scores* equal the recursion's (f32 sums are accumulated
  left-to-right in both).  No gap jumps.

* :func:`explore_node_exact` -- literal sequential port of the recursion,
  with the reference's shared mutable state: the running f32 sum, the
  ``boundReached``/``boundReachingK`` sibling-pruning flags, and the
  ``limitTo1Jump`` quirk where ``idxOfFirstJump`` is reset only on
  re-entering depth 0, so the first executed jump anywhere in a
  (pos, state) exploration disables all later jumps of that exploration
  (``WordExplorer_v3.java:112-115,161-190``).  The plain version of the
  native explorer (``rappas_tpu_torch.native.explore_node_exact_native``),
  which the build runs whenever gap jumps are active; the tests hold the
  two against each other.

Both return raw (codes int64, sums float32); (kmer, edge) max-merge happens
downstream (``rappas_tpu_torch.db.build_csr``).

Float-parity note: the reference never restores its running f32 sum -- it
only applies ``+=``/``-=`` increments, so (a+b)-b rounding residue from an
explored sibling subtree leaks into later words' registered scores
(at the ~1e-6 level).  :func:`explore_node_exact` reproduces this drift
bit-for-bit; :func:`explore_node` computes the mathematically clean
left-to-right f32 sum instead.  Comparisons against reference DBs are
therefore tolerance-based (see SURVEY.md "Float parity").
"""

from __future__ import annotations

import sys

import numpy as np


def explore_node(P: np.ndarray, k: int, thr: np.float32):
    """All (kmer_code, log10 sum) with sum >= thr for one node.

    P: float32[n_sites, n_states] log10 posteriors for the node.
    Returns (codes int64[m], sums float32[m]); codes big-endian base-S.
    """
    P = np.asarray(P, np.float32)
    L, S = P.shape
    n_starts = L - k + 1
    if n_starts <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)

    starts = np.arange(n_starts, dtype=np.int32)
    first = P[:n_starts, :]                      # [n_starts, S]
    keep = (first >= thr).ravel()                # NaN drops out
    f_start = np.repeat(starts, S)[keep]
    f_sum = first.ravel()[keep]
    f_code = np.tile(np.arange(S, dtype=np.int64), n_starts)[keep]

    for d in range(1, k):
        if f_start.size == 0:
            break
        cand = f_sum[:, None] + P[f_start + d, :]   # f32, same order as ref
        rows, cols = np.nonzero(cand >= thr)
        f_start = f_start[rows]
        f_sum = cand[rows, cols]
        f_code = f_code[rows] * S + cols
    return f_code, f_sum


def explore_node_exact(P_sorted_states: np.ndarray,
                       P_sorted_pp: np.ndarray, k: int, thr,
                       gap_intervals: dict | None = None,
                       do_gap_jumps: bool = False,
                       limit_to_1_jump: bool = True):
    """Literal port of ``WordExplorer_v3`` (the native explorer's plain
    version).

    P_sorted_states: int[n_sites, n_states] state codes sorted by
        descending posterior per site (stable; ties keep the AR program's
        column order, ``PHYMLWrapper.java:226``).
    P_sorted_pp: float32[n_sites, n_states] matching log10 posteriors.
    gap_intervals: map(start col) -> list of '-' run lengths
        (``Alignment.gapIntervals``).

    Returns (codes int64[m], sums float32[m]) in reference emission order
    (duplicates included, downstream max-merge handles them).
    """
    L, S = P_sorted_pp.shape
    thr = np.float32(thr)
    pp = np.asarray(P_sorted_pp, np.float32)
    st_codes = np.asarray(P_sorted_states, np.int64)
    gap_intervals = gap_intervals or {}
    codes: list[int] = []
    sums: list[float] = []

    word = [0] * k

    class St:
        cur = np.float32(0.0)
        bound = False
        bound_k = -1
        first_jump = -1

    def explore(i: int, j: int, depth: int):
        # WordExplorer_v3.java:109-111
        if i > L - 1:
            return
        if depth == 0:
            St.first_jump = -1
        word[depth] = int(st_codes[i, j])
        St.cur = np.float32(St.cur + pp[i, j])
        St.bound = bool(St.cur < thr)
        if St.bound:
            St.bound_k = depth
        if depth == k - 1:
            if not St.bound:
                code = 0
                for d in range(k):
                    code = code * S + word[d]
                codes.append(code)
                sums.append(float(St.cur))
            St.cur = np.float32(St.cur - pp[i, j])
            return
        for j2 in range(S):
            if St.bound and St.bound_k == depth + 1:
                break
            explore(i + 1, j2, depth + 1)
            if do_gap_jumps and i < L - 1 and (i + 1) in gap_intervals:
                if not limit_to_1_jump:
                    for length in gap_intervals[i + 1]:
                        explore(i + 1 + length, j2, depth + 1)
                elif St.first_jump == -1:
                    St.first_jump = i
                    for length in gap_intervals[i + 1]:
                        explore(i + 1 + length, j2, depth + 1)
        St.cur = np.float32(St.cur - pp[i, j])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100 * k + 1000))
    try:
        # pos upper bound is L-k+2: the extra start only completes words
        # through gap jumps (Main_DBBUILD_3.java:692).  A fresh explorer
        # object is created per pos (Main_DBBUILD_3.java:707-714), so the
        # running sum / bound flags / jump marker reset per pos but
        # persist across the j loop -- including the f32 +=/-= residuals
        # the recursion leaves behind (faithfully reproduced here).
        for pos in range(0, L - k + 2):
            St.cur = np.float32(0.0)
            St.bound = False
            St.bound_k = -1
            St.first_jump = -1
            for j in range(S):
                explore(pos, j, 0)
    finally:
        sys.setrecursionlimit(old)
    return np.array(codes, np.int64), np.array(sums, np.float32)


def sort_probas_desc(P: np.ndarray):
    """Per-site descending sort of posteriors with stable tie-break on the
    state column order, reproducing ``Collections.sort`` over
    ``SiteProba`` (``PHYMLWrapper.java:207-229``, ``SiteProba.java:20-35``).

    P: float32[n_sites, n_states] (canonical state order).
    Returns (states int8[n_sites, n_states], pp float32[n_sites, n_states]).
    """
    order = np.argsort(-P, axis=1, kind="stable")
    pp = np.take_along_axis(P, order, axis=1)
    return order.astype(np.int8), pp.astype(np.float32)
