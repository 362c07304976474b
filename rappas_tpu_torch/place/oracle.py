"""Serial reference-semantics placement oracle (host, slow, exact).

Port of ``rappas_tpu/place/oracle.py``: a direct re-expression of
``PlacementProcess.processQueries`` (``PlacementProcess.java:471-1118``)
and its ambiguity handlers (``:1129-1236``), in float32 arithmetic in the
same order as the Java code, so :func:`place_read` is the JAX package's
oracle bit for bit.  :func:`exact_scores` runs the same sums in float64:
the yardstick that two f32 summation orders (an engine's and Java's) are
both held against.  Used by the tests and ``chip_smoke.py``; never on the
hot path.
"""

from __future__ import annotations

import math

import numpy as np

from rappas_tpu_torch.db import PhyloKmerDB

f32 = np.float32


def _sums(db: PhyloKmerDB, seq: str, t, treat_ambiguities: bool,
          ambiguities_with_max: bool):
    """(S, L): each edge's score in the float type ``t`` (an array over the
    edge slots) and the candidates in the order of their first hit;
    (None, []) for a read shorter than k.  A clean window's postings name
    distinct edges, so their updates run as one array step: each edge's
    sum takes the same f32 operations in the same order as one posting at
    a time (``rappas_tpu/place/oracle.py:55-64``)."""
    a = db.alphabet
    k = db.k
    S_states = a.n_states
    thr = t(db.thr_log10)
    thr_lin = t(db.thr_linear)
    codes = a.encode(seq)
    L_len = codes.shape[0]
    Q = L_len - k + 1
    if Q <= 0:
        return None, []
    max_ambig = int(math.floor(k ** (1.0 / S_states)))

    S = np.zeros(db.n_edge_slots, t)
    C = np.zeros(db.n_edge_slots, np.int64)
    L: list[int] = []
    weights = S_states ** np.arange(k - 1, -1, -1, dtype=np.int64)
    start = t(t(Q) * thr)

    def hit(x: int, delta_from_thr):
        if C[x] == 0:
            L.append(x)
            S[x] = start
        C[x] += 1
        S[x] = t(S[x] + delta_from_thr)

    for q in range(Q):
        window = codes[q:q + k]
        amb = window < 0
        n_amb = int(amb.sum())
        if n_amb == 0:
            idx = int(window.astype(np.int64) @ weights)
            pairs = db.lookup(idx)
            if pairs is None:
                continue
            xs, pp = pairs
            new = xs[C[xs] == 0]
            L.extend(new.tolist())
            S[new] = start
            C[xs] += 1
            S[xs] = S[xs] + (pp.astype(t) - thr)
        elif treat_ambiguities and n_amb <= max_ambig:
            # expansion: reference cycling scheme
            # (AmbigSequenceKnife.java:240-258)
            amb_pos = np.flatnonzero(amb)
            alts = [a.ambiguity_codes(seq[q + p]) for p in amb_pos]
            W = int(np.prod([len(x) for x in alts]))
            S_amb: dict = {}
            C_amb: dict[int, int] = {}
            L_amb: list[int] = []
            for j in range(W):
                w2 = window.copy()
                for p, al in zip(amb_pos, alts):
                    w2[p] = al[j % len(al)]
                idx = int(w2.astype(np.int64) @ weights)
                pairs = db.lookup(idx)
                if pairs is None:
                    continue
                for x, pp in zip(*pairs):
                    x = int(x)
                    pp = t(pp)
                    if ambiguities_with_max:
                        if C_amb.get(x, 0) == 0:
                            L_amb.append(x)
                            S_amb[x] = pp
                        elif pp > S_amb[x]:
                            S_amb[x] = pp
                        C_amb[x] = C_amb.get(x, 0) + 1
                    else:
                        if C_amb.get(x, 0) == 0:
                            L_amb.append(x)
                        C_amb[x] = C_amb.get(x, 0) + 1
                        # linear-space accumulation
                        # (PlacementProcess.java:1154)
                        S_amb[x] = t(S_amb.get(x, t(0.0)) +
                                     t(10.0 ** float(pp)))
            for x in L_amb:
                if ambiguities_with_max:
                    hit(x, t(S_amb[x] - thr))
                else:
                    avg = t((S_amb[x] + t(
                        t(W - C_amb[x]) * thr_lin)) / t(W))
                    hit(x, t(t(math.log10(float(avg))) - thr))
        # too many ambiguities: skipped, Q unchanged
        # (AmbigSequenceKnife.java:230-232)
    return S, L


def place_read(db: PhyloKmerDB, seq: str, keep_at_most: int = 7,
               treat_ambiguities: bool = True,
               ambiguities_with_max: bool = False):
    """Score one read.

    Returns (rows, n_matched) where rows is a list of
    (edge_node_id, score f32, lwr float) sorted best-first over the top
    ``min(|L|, keep_at_most)`` candidates, or ([], 0) when no k-mer
    matched (read unplaced).
    """
    S, L = _sums(db, seq, f32, treat_ambiguities, ambiguities_with_max)
    if not L:
        return [], 0

    num_best = min(len(L), keep_at_most)
    # top-k selection + ascending sort (fillBestScoreList,
    # PlacementProcess.java:396-451)
    ranked = sorted(L, key=lambda x: float(S[x]), reverse=True)[:num_best]
    scores = [float(S[x]) for x in ranked]
    best, lowest = scores[0], scores[-1]
    shift = best if lowest <= -308.0 else 0.0
    all_sums = sum(10.0 ** (s - shift) for s in scores)
    rows = [(x, f32(S[x]), (10.0 ** (float(S[x]) - shift)) / all_sums)
            for x in ranked]
    return rows, len(L)


def exact_scores(db: PhyloKmerDB, seq: str, treat_ambiguities: bool = True,
                 ambiguities_with_max: bool = False) -> dict[int, float]:
    """Every candidate edge's score ``Q * thr + sum(score - thr)`` over the
    read's postings (the DB's f32 scores, ``db.lookup``), summed in
    float64: Java's semantics without its f32 rounding.  ``{}`` when no
    k-mer matched."""
    S, L = _sums(db, seq, np.float64, treat_ambiguities,
                 ambiguities_with_max)
    return {x: float(S[x]) for x in L}
