"""The phylo-kmer database: flat tensors + JSON header.

Replaces the reference's JVM-serialized session
(``/root/reference/src/main_v2/SessionNext_v2.java:110-207``, a
version-fragile Java object stream) with a language-neutral, versioned
format: a ``.npz`` of numpy arrays plus an embedded JSON header.

Logical content (mirrors the fields of ``SessionNext_v2.java:43-66``):

* scoring parameters: k, omega, thresholds;
* the original tree (newick with jplace ``{x}`` edge ids) + per-node-id
  arrays (branch lengths, jplace edge ids) so placement needs no tree
  traversal;
* the phylo-kmer postings: for every k-mer present, the set of
  (original-tree edge id, max log10 PP*) pairs
  (``CustomHash_v4_FastUtil81.java:35-36,73-102``) stored as CSR over the
  *sorted unique k-mer index* axis.

The stored score is ``delta = score - log10_threshold`` clamped to a tiny
positive minimum: delta is what placement accumulates
(``S[e] = Q*thr + sum(delta)``, ``PlacementProcess.java:726-734``), and
keeping it strictly positive lets the placement engine detect "edge was
matched" as ``accumulated > 0`` without a second counter tensor.  The raw
score is recovered as ``delta + thr``.

The clamp must be a *normal* float32: a TPU, CUDA code built with
flush-to-zero (``--use_fast_math``) and some XLA CPU paths flush
subnormals to zero, so a subnormal clamp would silently become 0.0 on
device and drop threshold-grade matches from candidate lists (the
reference keeps them: a score exactly at threshold still increments C and
joins L, ``CustomHash_v4_FastUtil81.java:73-102`` +
``PlacementProcess.java:726-734``).  1e-30 is far above the min normal
(~1.18e-38) yet ~23 orders below the smallest genuine delta (one f32 ulp
at threshold magnitude, ~2e-7), so it never perturbs a real score sum.
"""

from __future__ import annotations

import dataclasses
import io
import json
import typing
import zlib
from pathlib import Path

import numpy as np

from rappas_tpu_torch.alphabet import Alphabet, get_alphabet
from rappas_tpu_torch.tree import ArrayTree, Tree, parse_newick, write_newick

FORMAT_VERSION = 1

#: strictly positive floor for stored deltas; must be a NORMAL float32
#: (flush-to-zero-safe on any device) -- see module docstring
DELTA_TINY = np.float32(1e-30)

#: sentinel edge id of light-table pad slots: sorts past every real
#: edge, so pads land at the tail of each edge-sorted posting run and
#: segment presence is just ``edge != LIGHT_PAD_EDGE``
#: (:meth:`PhyloKmerDB.postings_tables`)
LIGHT_PAD_EDGE = np.int32(np.iinfo(np.int32).max)


@dataclasses.dataclass
class PhyloKmerDB:
    k: int
    omega: float
    alphabet: Alphabet
    #: float32 log10((omega/S)^k), the word threshold
    #: (``Main_DBBUILD_3.java:165-166``)
    thr_log10: np.float32
    #: original tree, jplace edge ids assigned
    tree: Tree
    #: sorted unique k-mer indices present in the DB (int64[n_keys])
    keys: np.ndarray
    #: CSR offsets into postings (int64[n_keys+1])
    offsets: np.ndarray
    #: original-tree node id of the edge, per posting (int32[nnz])
    edges: np.ndarray
    #: delta = max log10 PP* - thr, clamped to >= DELTA_TINY (float32[nnz])
    deltas: np.ndarray
    #: extras persisted for resume / debugging (newick strings etc.)
    meta: dict = dataclasses.field(default_factory=dict)

    # -------------------------------------------------------------- #
    @property
    def n_kmers(self) -> int:
        return int(self.keys.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.edges.shape[0])

    @property
    def thr_linear(self) -> np.float32:
        """(omega/S)^k as float32, used by the ambiguity mean handler
        (``PlacementProcess.java:1167``)."""
        ratio = np.float32(self.omega) / np.float32(self.alphabet.n_states)
        return np.float32(np.power(np.float64(ratio), self.k))

    @property
    def arrays(self) -> ArrayTree:
        at = getattr(self, "_arrays", None)
        if at is None:
            at = self.tree.to_arrays()
            self._arrays = at
        return at

    @property
    def n_edge_slots(self) -> int:
        """Width of per-edge score vectors == max original node id + 1."""
        return self.arrays.n_ids

    # -------------------------------------------------------------- #
    @staticmethod
    def threshold(k: int, omega: float, n_states: int) -> np.float32:
        """log10((omega/S)^k) with the reference's exact float widening:
        f32 division, f64 pow, cast f32, f64 log10, cast f32
        (``Main_DBBUILD_3.java:165-166``)."""
        ratio = np.float32(omega) / np.float32(n_states)
        lin = np.float32(np.power(np.float64(ratio), k))
        return np.float32(np.log10(np.float64(lin)))

    # -------------------------------------------------------------- #
    def lookup(self, kmer_index: int):
        """(edges, scores) for one k-mer, or None -- host-side debugging
        mirror of ``getPairsOfTopPosition2``
        (``CustomHash_v4_FastUtil81.java:146-153``)."""
        i = np.searchsorted(self.keys, kmer_index)
        if i >= self.n_kmers or self.keys[i] != kmer_index:
            return None
        lo, hi = self.offsets[i], self.offsets[i + 1]
        raw = np.where(self.deltas[lo:hi] <= DELTA_TINY,
                       np.float32(0.0), self.deltas[lo:hi])
        return self.edges[lo:hi], np.float32(raw + self.thr_log10)

    # -------------------------------------------------------------- #
    def save(self, path, compress: bool = False) -> None:
        """Write the versioned npz (uncompressed by default: zlib costs
        ~70s on a 400 MB k=12 DB for ~2x size; pass compress=True for
        archival copies -- load() reads both)."""
        header = {
            "format_version": FORMAT_VERSION,
            "k": self.k,
            "omega": self.omega,
            "states": self.alphabet.name,
            "thr_log10": float(self.thr_log10),
            "tree_newick": write_newick(self.tree, True, True, True, False),
            "n_kmers": self.n_kmers,
            "nnz": self.nnz,
            "meta": self.meta,
        }
        # write through a file object: np.savez would otherwise append
        # ".npz" to the requested filename
        writer = np.savez_compressed if compress else np.savez
        with open(path, "wb") as f:
            writer(
                f,
                header=np.frombuffer(
                    json.dumps(header).encode("utf-8"), dtype=np.uint8),
                keys=self.keys, offsets=self.offsets,
                edges=self.edges, deltas=self.deltas)

    @classmethod
    def load(cls, path) -> "PhyloKmerDB":
        with np.load(path) as z:
            header = json.loads(bytes(z["header"]).decode("utf-8"))
            if header["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"DB format {header['format_version']} is newer than "
                    f"this build supports ({FORMAT_VERSION})")
            tree = parse_newick(header["tree_newick"],
                                jplace_edge_ids=True)
            # restore jplace ids onto nodes (parsed from {x} labels)
            db = cls(
                k=header["k"], omega=header["omega"],
                alphabet=get_alphabet(header["states"]),
                thr_log10=np.float32(header["thr_log10"]),
                tree=tree,
                keys=z["keys"], offsets=z["offsets"],
                edges=z["edges"], deltas=z["deltas"],
                meta=header.get("meta", {}))
            return db

    # -------------------------------------------------------------- #
    def to_json_dump(self) -> dict:
        """Readable dump equivalent to the reference's ``--jsondb``
        (``SessionNext_v2.saveToJSON``, :214-270): kmer text ->
        {edge id: score} with raw log10 PP* scores."""
        out = {}
        for i in range(self.n_kmers):
            word = self.alphabet.kmer_to_string(int(self.keys[i]), self.k)
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            raw = np.where(self.deltas[lo:hi] <= DELTA_TINY,
                           np.float32(0.0), self.deltas[lo:hi])
            out[word] = {int(e): float(np.float32(r + self.thr_log10))
                         for e, r in zip(self.edges[lo:hi], raw)}
        return out

    # -------------------------------------------------------------- #
    def _matrix(self, n_rows: int, rows: np.ndarray, dtype,
                scale: np.float32 | None):
        D = np.zeros((n_rows, self.n_edge_slots), dtype)
        if scale is None:
            D[rows, self.edges] = self.deltas
        else:
            q = np.maximum(np.rint(self.deltas / scale), 1.0)
            D[rows, self.edges] = np.minimum(q, 65535.0).astype(dtype)
        return D

    def _u16_scale(self) -> np.float32:
        max_delta = float(self.deltas.max()) if self.nnz else 1.0
        return np.float32(max_delta / 65535.0) if max_delta > 0 else \
            np.float32(1.0)

    def dense_matrix(self, pad_rows: int = 1) -> np.ndarray:
        """Dense delta matrix ``D[S^k + pad_rows, n_edge_slots]``: row
        index == k-mer index (absent entries 0; the final pad rows stay 0
        and serve as the miss/padding target)."""
        S = self.alphabet.n_states
        rows = np.repeat(self.keys, np.diff(self.offsets))
        return self._matrix(S ** self.k + pad_rows, rows, np.float32, None)

    def dense_matrix_u16(self, pad_rows: int = 1):
        """(D_u16, scale): fixed-point dense deltas, halving HBM gather
        traffic vs f32.

        ``delta = D_u16 * scale`` with ``scale = max_delta / 65535``;
        present entries are clamped to >= 1 so the ``acc > 0`` match test
        still works.  The quantisation step (~5e-5 log10 units for
        typical DBs) is the same order as f32 addition rounding at score
        magnitudes, so u16 mode stays within the fp tolerance used for
        reference parity; f32 mode remains available for strict
        comparisons.
        """
        S = self.alphabet.n_states
        scale = self._u16_scale()
        rows = np.repeat(self.keys, np.diff(self.offsets))
        return (self._matrix(S ** self.k + pad_rows, rows, np.uint16,
                             scale), scale)

    def compact_matrix(self, pad_rows: int = 1) -> np.ndarray:
        """Compact delta matrix ``D[n_kmers + pad_rows, n_edge_slots]``:
        row i holds the postings of ``keys[i]``.  Used with binary-search
        lookup when ``S^k`` is too large for a direct-indexed table
        (protein mode, large k)."""
        rows = np.repeat(np.arange(self.n_kmers), np.diff(self.offsets))
        return self._matrix(self.n_kmers + pad_rows, rows, np.float32,
                            None)

    def compact_matrix_u16(self, pad_rows: int = 1):
        scale = self._u16_scale()
        rows = np.repeat(np.arange(self.n_kmers), np.diff(self.offsets))
        return (self._matrix(self.n_kmers + pad_rows, rows, np.uint16,
                             scale), scale)

    def postings_tables(self, width: int = 8) -> "PostingsTables":
        """Light/heavy split postings layout for large-tree DBs.

        The dense layouts above cost ``n_rows * E`` floats -- ruinous
        when the tree is large (E ~ 2 * n_taxa score slots) but posting
        lists are short.  Here k-mers with <= ``width`` postings (the
        "light" ones, typically the vast majority on big sparse DBs) are
        stored as fixed-width ``[n_light + 1, width]`` edge/delta tables
        costing 8 bytes per posting slot; the few k-mers with longer
        lists ("heavy", conserved k-mers hitting many edges) go to a
        small dense matrix ``[n_heavy + 1, E]``.  Both tables carry a
        trailing miss row.  Pad slots in the light tables (unused posting
        slots and the miss row) are ``(LIGHT_PAD_EDGE, 0.0)``: the int32
        sentinel edge sorts pads to the TAIL of each read's edge-sorted
        posting run, so (a) segment presence is just
        ``edge != LIGHT_PAD_EDGE`` -- no separate exactness pass -- and
        (b) the sorted run can be sliced to the batch's real posting
        count before the scan machinery (round 4; pads previously
        carried edge 0 and needed a count-cumsum to tell a real edge-0
        segment from pure padding).  The zero delta still contributes
        nothing to any sum.
        """
        lens = np.diff(self.offsets)
        light = lens <= width
        heavy = ~light
        nl = int(light.sum())
        nh = int(heavy.sum())
        E = self.n_edge_slots

        def flat_gather(idx):
            """(row, col, src) triples covering the posting slices of
            the selected k-mers, fully vectorized."""
            ln = lens[idx]
            total = int(ln.sum())
            row = np.repeat(np.arange(idx.shape[0]), ln)
            col = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
            src = np.repeat(self.offsets[idx], ln) + col
            return row, col, src

        light_keys = self.keys[light]
        light_edges = np.full((nl + 1, width), LIGHT_PAD_EDGE, np.int32)
        light_deltas = np.zeros((nl + 1, width), np.float32)
        row, col, src = flat_gather(np.flatnonzero(light))
        light_edges[row, col] = self.edges[src]
        light_deltas[row, col] = self.deltas[src]

        heavy_keys = self.keys[heavy]
        heavy_dense = np.zeros((nh + 1, E), np.float32)
        row, _, src = flat_gather(np.flatnonzero(heavy))
        heavy_dense[row, self.edges[src]] = self.deltas[src]

        return PostingsTables(width=width,
                              light_keys=light_keys,
                              light_edges=light_edges,
                              light_deltas=light_deltas,
                              heavy_keys=heavy_keys,
                              heavy_dense=heavy_dense)


class PostingsTables(typing.NamedTuple):
    """Device layout produced by :meth:`PhyloKmerDB.postings_tables`."""
    width: int
    light_keys: np.ndarray    # int64[nl] sorted
    light_edges: np.ndarray   # int32[nl+1, width], last row zeros (miss)
    light_deltas: np.ndarray  # f32[nl+1, width]
    heavy_keys: np.ndarray    # int64[nh] sorted
    heavy_dense: np.ndarray   # f32[nh+1, E], last row zeros (miss)

    @property
    def nbytes(self) -> int:
        return (self.light_edges.nbytes + self.light_deltas.nbytes +
                self.heavy_dense.nbytes + self.light_keys.nbytes +
                self.heavy_keys.nbytes)


#: (code, edge) fit one int64 when codes < 2^39 and edges < 2^24 --
#: true for every DNA k and protein k <= 8; larger spaces fall back to
#: the 3-pass lexsort
_EDGE_BITS = 24


def max_merge_tuples(codes: np.ndarray, edges: np.ndarray,
                     scores: np.ndarray):
    """Dedup raw (kmer, edge, score) tuples keeping the max score per
    (kmer, edge) pair, returned sorted by (kmer, edge).

    The reference does this incrementally at hash insertion
    (``CustomHash_v4_FastUtil81.java:73-102``, max at put); here it is
    one bulk sort.  Hot path packs (code, edge) into a single int64 and
    sorts with torch (multi-threaded) -- measured ~8x faster than the
    single-threaded 3-key ``np.lexsort`` on a 73M-tuple k=12 build --
    with per-group maxima via ``np.maximum.reduceat``.
    """
    if codes.size == 0:
        return codes, edges, scores
    if (int(codes.min()) >= 0 and
            int(codes.max()) < 1 << (63 - _EDGE_BITS) and
            int(edges.max()) < 1 << _EDGE_BITS and
            int(edges.min()) >= 0):
        packed = (codes.astype(np.int64) << _EDGE_BITS) | \
            edges.astype(np.int64)
        try:
            import torch
            t = torch.from_numpy(packed)
            s_packed, order = torch.sort(t)
            s_packed = s_packed.numpy()
            order = order.numpy()
        except ImportError:  # pragma: no cover - torch is baked in
            order = np.argsort(packed, kind="stable")
            s_packed = packed[order]
        starts = np.empty(s_packed.shape[0], bool)
        starts[0] = True
        np.not_equal(s_packed[1:], s_packed[:-1], out=starts[1:])
        start_idx = np.flatnonzero(starts)
        smax = np.maximum.reduceat(scores[order], start_idx)
        reps = s_packed[start_idx]
        return (reps >> _EDGE_BITS).astype(codes.dtype), \
            (reps & ((1 << _EDGE_BITS) - 1)).astype(edges.dtype), \
            smax.astype(scores.dtype)
    order = np.lexsort((-scores, edges, codes))
    c, e, s = codes[order], edges[order], scores[order]
    first = np.ones(c.shape[0], bool)
    first[1:] = (c[1:] != c[:-1]) | (e[1:] != e[:-1])
    return c[first], e[first], s[first]


def build_csr(codes: np.ndarray, edges: np.ndarray,
              scores: np.ndarray, thr_log10: np.float32,
              presorted: bool = False):
    """Collapse raw (kmer, edge, score) tuples into the CSR postings,
    keeping max score per (kmer, edge) (``CustomHash_v4_FastUtil81.java:
    73-102`` keeps the max at insertion).

    ``presorted=True`` asserts the tuples are already (code, edge)-sorted
    with unique pairs (the bucketed build merge emits this) and skips
    the max-merge sort entirely.

    Returns (keys, offsets, edges, deltas).
    """
    if codes.size == 0:
        return (np.zeros(0, np.int64), np.zeros(1, np.int64),
                np.zeros(0, np.int32), np.zeros(0, np.float32))
    if presorted:
        c, e, s = codes, edges, scores
    else:
        c, e, s = max_merge_tuples(codes, edges, scores)
    # c is sorted: boundary scan instead of np.unique (which re-sorts)
    starts = np.empty(c.shape[0], bool)
    starts[0] = True
    np.not_equal(c[1:], c[:-1], out=starts[1:])
    key_start = np.flatnonzero(starts)
    keys = c[key_start]
    offsets = np.empty(keys.shape[0] + 1, np.int64)
    offsets[:-1] = key_start
    offsets[-1] = c.shape[0]
    deltas = np.maximum(np.float32(s - thr_log10), DELTA_TINY)
    return keys, offsets, e.astype(np.int32), deltas
