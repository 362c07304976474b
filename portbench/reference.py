"""Plain NumPy reference of phylo-kmer placement, and the judge that holds
the program's output files to it.

It imports nothing of the program: it works from the raw ``(code, edge,
score)`` postings a recipe drew and from the reads the harness wrote,
with the semantics of RAPPAS's ``PlacementProcess`` (each edge's score is
``Q * thr + sum(score - thr)`` over the read's windows whose k-mer has a
posting on the edge, ``Q`` the read's window count; a window with one
ambiguous base takes the mean of its alternatives in linear space,
``PlacementProcess.java:1129-1236``; the best ``keep_at_most`` edges, the
likelihood weight ratios over them, the keep-factor cut), summed in
float64.  The DBs are star trees: leaf ``L_i`` is node ``i + 1`` and
jplace edge ``i`` (post-order numbering, ``PhyloTree.java:408-439``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

LETTERS = b"ACGT"
#: ASCII -> code: ACGT 0-3, N -1 (ambiguous), anything else -2 (padding)
_LUT = np.full(256, -2, np.int8)
for _i, _c in enumerate(LETTERS):
    _LUT[_c] = _i
_LUT[ord("N")] = -1

#: reads per block of the vectorised scoring (bounds its memory)
_BLOCK_WINDOWS = 1 << 21


def rappas_threshold(k: int, omega: float, n_states: int) -> np.float32:
    """log10((omega / S)^k) with RAPPAS's float widening: f32 division,
    f64 power, f32 cast, f64 log10, f32 cast
    (``Main_DBBUILD_3.java:165-166``)."""
    return np.float32(np.log10(np.float64(
        rappas_threshold_linear(k, omega, n_states))))


def rappas_threshold_linear(k: int, omega: float,
                            n_states: int) -> np.float32:
    ratio = np.float32(omega) / np.float32(n_states)
    return np.float32(np.power(np.float64(ratio), k))


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & \
        np.uint32(0xFFFF0000)
    return r.view(np.float32)


@dataclass
class Scored:
    """Every candidate edge of each read, best first: read ``i``'s are
    ``edge[off[i]:off[i + 1]]`` (node ids) with ``score`` (float64)."""
    off: np.ndarray
    edge: np.ndarray
    score: np.ndarray

    def candidates(self, i: int):
        lo, hi = int(self.off[i]), int(self.off[i + 1])
        return self.edge[lo:hi], self.score[lo:hi]


class Reference:
    """The placement of reads against raw postings, in float64.

    ``store`` sets how the table holds each delta (``score - thr``):
    ``"f64"`` exactly (the reference), ``"bf16"`` rounded to bfloat16
    (the control: the reference in the precision below float32)."""

    def __init__(self, k: int, omega: float, codes: np.ndarray,
                 edges: np.ndarray, scores: np.ndarray, n_edge_slots: int,
                 keep_at_most: int = 7, keep_factor: float = 0.01,
                 store: str = "f64"):
        self.k, self.E = k, int(n_edge_slots)
        self.keep_at_most, self.keep_factor = keep_at_most, keep_factor
        self.thr = np.float64(rappas_threshold(k, omega, 4))
        self.thr_lin = np.float64(rappas_threshold_linear(k, omega, 4))
        # the max score of each (k-mer, edge) pair (RAPPAS keeps the max
        # at insertion, CustomHash_v4_FastUtil81.java:73-102)
        pair = codes.astype(np.int64) * self.E + edges.astype(np.int64)
        order = np.argsort(pair, kind="stable")
        pair = pair[order]
        first = np.flatnonzero(np.concatenate(
            [[True], pair[1:] != pair[:-1]]))
        best = np.maximum.reduceat(scores[order], first)
        pair = pair[first]
        code = pair // self.E
        self.edge = (pair % self.E).astype(np.int32)
        starts = np.flatnonzero(np.concatenate(
            [[True], code[1:] != code[:-1]]))
        self.keys = code[starts]
        self.off = np.append(starts, code.size).astype(np.int64)
        if store == "f64":
            self.delta = best.astype(np.float64) - self.thr
        elif store == "bf16":
            self.delta = to_bfloat16(
                np.float32(best - np.float32(self.thr))).astype(np.float64)
        else:
            raise ValueError(f"store must be f64 or bf16, got {store!r}")
        self.lin = 10.0 ** (self.delta + self.thr)

    # ------------------------------------------------------------------ #
    def _rows(self, idx: np.ndarray):
        """(found, row) of k-mer indices in the sorted keys."""
        row = np.searchsorted(self.keys, idx)
        row = np.minimum(row, self.keys.size - 1)
        return self.keys[row] == idx, row

    def _expand(self, rows: np.ndarray):
        """(which input, posting position) of every posting of ``rows``."""
        cnt = self.off[rows + 1] - self.off[rows]
        which = np.repeat(np.arange(rows.size), cnt)
        start = np.cumsum(cnt) - cnt
        pos = self.off[rows][which] + np.arange(which.size) - start[which]
        return which, pos

    def score(self, seqs: list) -> Scored:
        """Every candidate of each read (``bytes`` of ACGT and N)."""
        k, E = self.k, self.E
        lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
        reads, edges, deltas = [], [], []
        lo = 0
        while lo < len(seqs):
            hi, top = lo + 1, int(lens[lo])
            while hi < len(seqs) and \
                    (hi - lo + 1) * max(top, int(lens[hi])) <= _BLOCK_WINDOWS:
                top = max(top, int(lens[hi]))
                hi += 1
            r, e, d = self._block(seqs[lo:hi], lens[lo:hi])
            reads.append(r + lo)
            edges.append(e)
            deltas.append(d)
            lo = hi
        r = np.concatenate(reads)
        pair = r * E + np.concatenate(edges)
        uniq, inv = np.unique(pair, return_inverse=True)
        sums = np.bincount(inv, weights=np.concatenate(deltas))
        read = uniq // E
        score = np.maximum(lens - k + 1, 0)[read] * self.thr + sums
        order = np.lexsort((-score, read))
        off = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(np.bincount(read, minlength=len(seqs)), out=off[1:])
        return Scored(off, (uniq % E)[order].astype(np.int32),
                      score[order])

    def windows(self, mat: np.ndarray, lens: np.ndarray):
        """Each window of ASCII reads ``mat`` (0xFF padded) with
        ``lens``: (whether it lies in its read, its count of N, the place
        value of its N, its k-mer index with N read as A)."""
        k = self.k
        n, L = mat.shape
        Q = max(L - k + 1, 0)
        codes = _LUT[mat]
        valid = np.arange(Q)[None, :] < (np.asarray(lens) - k + 1)[:, None]
        n_amb = np.zeros((n, Q), np.int32)
        amb_at = np.zeros((n, Q), np.int64)
        idx = np.zeros((n, Q), np.int64)
        for j in range(k):
            c = codes[:, j:j + Q]
            w = 4 ** (k - 1 - j)
            idx += np.maximum(c, 0).astype(np.int64) * w
            is_n = c == -1
            n_amb += is_n
            amb_at += is_n * w
            if (c[valid] == -2).any():
                raise ValueError("a read holds a letter other than ACGTN")
        return valid, n_amb, amb_at, idx

    def _block(self, seqs, lens):
        mat = np.full((len(seqs), int(lens.max())), 0xFF, np.uint8)
        for i, s in enumerate(seqs):
            mat[i, :len(s)] = np.frombuffer(s, np.uint8)
        valid, n_amb, amb_at, idx = self.windows(mat, lens)
        # clean windows
        r, q = np.nonzero(valid & (n_amb == 0))
        found, row = self._rows(idx[r, q])
        which, pos = self._expand(row[found])
        reads = [r[found][which]]
        edges = [self.edge[pos]]
        deltas = [self.delta[pos]]
        # windows with one ambiguous base (more are skipped: at most
        # floor(k^(1/4)) = 1 for k < 16, AmbigSequenceKnife.java:230-232)
        r, q = np.nonzero(valid & (n_amb == 1))
        if r.size:
            W = 4
            win = np.repeat(np.arange(r.size), W)
            alt = idx[r, q][win] + np.tile(np.arange(W), r.size) * \
                amb_at[r, q][win]
            found, row = self._rows(alt)
            which, pos = self._expand(row[found])
            wid = win[found][which]
            pair = wid * self.E + self.edge[pos]
            uniq, inv = np.unique(pair, return_inverse=True)
            lin = np.bincount(inv, weights=self.lin[pos])
            cnt = np.bincount(inv)
            mean = (lin + (W - cnt) * self.thr_lin) / W
            reads.append(r[uniq // self.E])
            edges.append((uniq % self.E).astype(np.int32))
            deltas.append(np.log10(mean) - self.thr)
        return (np.concatenate(reads), np.concatenate(edges),
                np.concatenate(deltas))

    # ------------------------------------------------------------------ #
    def best(self, scored: Scored, i: int):
        """Read ``i``'s placement rows as RAPPAS writes them: (node ids,
        scores, LWR, rows kept by the keep factor, and each row's
        log10 distance from the cut)."""
        edge, score = scored.candidates(i)
        n = min(edge.size, self.keep_at_most)
        edge, score = edge[:n], score[:n]
        w = 10.0 ** (score - score[0])
        lwr = w / w.sum()
        ratio = np.log10(np.maximum(lwr / lwr[0], 1e-300))
        margin = ratio - np.log10(self.keep_factor)
        kept = n if (margin >= 0).all() else int(np.argmin(margin >= 0))
        return edge, score, lwr, kept, margin


def star_node(edge_num: np.ndarray) -> np.ndarray:
    """The node id of a star tree's leaf with jplace edge ``edge_num``."""
    return np.asarray(edge_num, np.int64) + 1


# ---------------------------------------------------------------------- #
@dataclass
class Sample:
    """One sample file: its reads' headers (without ``>``) and bases."""
    headers: list
    seqs: list


def expected_layout(sample: Sample):
    """(unique reads in first-occurrence order, the ``nm`` list of each:
    its first header whole, its duplicates' up to the first space,
    ``PlacementProcess.java:598-612``; each read's unique index)."""
    first: dict = {}
    uniq, nm = [], []
    for h, s in zip(sample.headers, sample.seqs):
        j = first.get(s)
        if j is None:
            first[s] = len(uniq)
            uniq.append(s)
            nm.append([h])
        else:
            nm[j].append(h.split(" ")[0])
    return uniq, nm, [first[s] for s in sample.seqs]


#: ``score_gap`` of a placement that names an edge twice, or an edge
#: without a posting from the read
FOREIGN = 1e9

#: how close (log10 units) a reference row may lie to the keep-factor
#: cut and still be kept or dropped by the program either way
CUT_BAND = 1e-3


def compare(ref: Reference, sample: Sample, placements: list,
            notplaced: list, fields: list) -> dict:
    """The numbers of one sample: the program's ``placements`` (the jplace
    objects, in file order) and ``notplaced`` (the lines of its
    not-placed log) against the reference.

    * ``score_gap``: the widest distance of a placement row from the
      reference, in log10 units: its likelihood against its edge's
      float64 score, or that score's shortfall below the reference's
      score at the same rank (a wrong or misordered edge), whichever is
      larger;
    * ``lwr_gap``: the widest distance of a row's LWR from the
      reference's at the same rank;
    * ``rows_off``: placements that keep another number of rows than the
      reference's keep-factor cut, unless the rows between lie within
      ``CUT_BAND`` of the cut;
    * ``nm_off``: placements missing, extra, out of first-occurrence
      order, or with another ``nm`` list;
    * ``unplaced_off``: lines of the not-placed log missing or extra."""
    uniq, nm, which = expected_layout(sample)
    scored = ref.score(uniq)
    n_cand = np.diff(scored.off)
    placed = np.flatnonzero(n_cand > 0)
    out = {"score_gap": 0.0, "lwr_gap": 0.0, "rows_off": 0,
           "nm_off": abs(len(placements) - placed.size), "unplaced_off": 0,
           "reads": len(sample.seqs), "placements": len(placements)}
    fe, fl, fw = (fields.index(f) for f in
                  ("edge_num", "likelihood", "like_weight_ratio"))
    for p_obj, i in zip(placements, placed.tolist()):
        if [x[0] for x in p_obj["nm"]] != nm[i]:
            out["nm_off"] += 1
            continue
        rows = np.asarray(p_obj["p"], np.float64)
        node = star_node(rows[:, fe])
        e_ref, s_ref, w_ref, kept, margin = ref.best(scored, i)
        cand_e, cand_s = scored.candidates(i)
        lookup = dict(zip(cand_e.tolist(), cand_s.tolist()))
        s_of = np.array([lookup.get(int(x), np.nan) for x in node])
        n = rows.shape[0]
        if np.isnan(s_of).any() or n > e_ref.size or \
                len(set(node.tolist())) != n:
            out["score_gap"] = max(out["score_gap"], FOREIGN)
            continue
        # a row's distance from the reference: its score against its
        # edge's, or its edge's shortfall below the same rank's best
        gap = np.maximum(np.abs(rows[:, fl] - s_of), s_ref[:n] - s_of)
        out["score_gap"] = max(out["score_gap"], float(gap.max()))
        out["lwr_gap"] = max(out["lwr_gap"],
                             float(np.abs(rows[:, fw] - w_ref[:n]).max()))
        if n != kept and not (np.abs(margin[min(n, kept):max(n, kept)])
                              <= CUT_BAND).all():
            out["rows_off"] += 1
    want = [h for h, j in zip(sample.headers, which) if n_cand[j] == 0]
    out["unplaced_off"] = len(_counted(want) ^ _counted(notplaced))
    return out


def _counted(items) -> set:
    """A multiset as a set of (item, occurrence number) pairs."""
    seen: dict = {}
    for x in items:
        seen[x] = seen.get(x, 0) + 1
    return {(x, c) for x, n in seen.items() for c in range(1, n + 1)}


def read_outputs(jplace_path, notplaced_path):
    """(placements, not-placed lines, fields) of one call's files, in
    :func:`compare`'s order."""
    with open(jplace_path) as f:
        j = json.load(f)
    with open(notplaced_path) as f:
        lines = [x for x in f.read().split("\n") if x]
    return j["placements"], lines, j["fields"]


def merge_numbers(parts: list) -> dict:
    """The numbers of several samples: maxima of gaps, sums of counts."""
    out: dict = {}
    for p in parts:
        for key, v in p.items():
            out[key] = (max(out.get(key, 0.0), v) if isinstance(v, float)
                        else out.get(key, 0) + v)
    return out


def control_outputs(ref: Reference, sample: Sample):
    """The jplace placements and not-placed lines that ``ref`` (the
    control: a reference that stores bfloat16 deltas) writes in the
    program's place, its scores rounded to float32 as the program's."""
    uniq, nm, which = expected_layout(sample)
    scored = ref.score(uniq)
    placements = []
    for i in range(len(uniq)):
        if scored.off[i] == scored.off[i + 1]:
            continue
        edge, score, lwr, kept, _ = ref.best(scored, i)
        s32 = score.astype(np.float32).astype(np.float64)
        rows = [[int(e) - 1, float(s), float(w), 0.05, 0.0]
                for e, s, w in zip(edge[:kept], s32, lwr)]
        placements.append({"p": rows, "nm": [[h, 1] for h in nm[i]]})
    n_cand = np.diff(scored.off)
    notplaced = [h for h, j in zip(sample.headers, which) if n_cand[j] == 0]
    fields = ["edge_num", "likelihood", "like_weight_ratio",
              "distal_length", "pendant_length"]
    return placements, notplaced, fields
