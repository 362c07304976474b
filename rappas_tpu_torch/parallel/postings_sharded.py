"""Edge-range sharding of the postings tables: the large-tree multi-device
mode (BASELINE.json config 5: ~4000-taxon trees, k=12).

Port of ``rappas_tpu/parallel/postings_sharded.py``.  The postings are
partitioned by **edge range** over the ``mp`` mesh axis
(:func:`shard_db_by_edge`):

* every posting (edge, delta) lives on exactly one shard -- the one
  owning its edge's range -- so each shard's light segment sums and heavy
  accumulators are *complete* for its edges;
* each shard runs the single-device postings pipeline on its slice of
  the reads -- P1 ``dense_side``, P2 ``ambiguous_postings`` and P3
  ``finalize_postings_wire`` with the shard's ``edge_offset`` -- and
  writes its top-K candidates as a wire with global edge ids;
* the mesh row's wires are all-gathered (:meth:`Mesh.gather`: a copy
  in one process, a collective over the row's group where the row spans
  processes) and M1 ``merge_candidates_wire`` takes the exact global
  top-K of the ``mp * K`` candidates (edges are partitioned, so per-edge
  scores never need a cross-shard sum) and sums the shards' ``|L|``, on
  every process of the row.

Each shard's light table holds global edge ids in the single-device
engine's rows (``LightLayout.of``: u16 ids below 65,535 edge slots).

Reads stay data-parallel over ``dp``.  The host computes the batch's
k-mer indices once and takes each shard's encoded rows with one fancy
index into that shard's direct row table; IUPAC ambiguity windows (the
engine's host expansion) are split by dp slice, and every shard scores
each window over its own edge range.
"""

from __future__ import annotations

import numpy as np
import torch

from rappas_tpu_torch.db import (DELTA_TINY, LIGHT_PAD_EDGE, LightLayout,
                                 PhyloKmerDB, build_csr)
from rappas_tpu_torch.parallel.mesh import Mesh, PendingSlices, dp_slices
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.place.engine import (BatchResult, alt_rows_of,
                                           count_p3, fetch_wire,
                                           host_kmer_indices,
                                           light_row_tally, postings_batch,
                                           stage)
from rappas_tpu_torch.utils import tracing_on


def shard_db_by_edge(db: PhyloKmerDB, mp: int, width: int = 8):
    """Partition the DB's postings into ``mp`` contiguous edge ranges and
    build per-shard postings tables, padded to common shapes.

    Returns (bounds int64[mp+1], stacked dict of arrays with leading mp
    axis): light_pairs [mp, max_nl+1, 2P], rof [mp, space+1] (direct
    k-mer -> row tables, per-shard nl encoding), nl int32[mp],
    heavy_dense [mp, max_nh+1, W] with W = max range width.
    """
    E = db.n_edge_slots
    space = db.alphabet.n_states ** db.k
    if space * 4 > 1 << 30:
        raise ValueError("postings_sharded needs the direct row table "
                         f"(S^k = {space} too large)")
    bounds = np.linspace(0, E, mp + 1).astype(np.int64)
    codes_full = np.repeat(db.keys, np.diff(db.offsets))
    # float64 round trip: build_csr recomputes delta = (score - thr) as
    # f32; with f64 scores the recovered deltas are bit-identical to the
    # originals (an f32 intermediate would perturb ~half by 1 ulp and
    # break cross-mode equality on near-tie candidates)
    scores_full = (np.where(db.deltas <= DELTA_TINY,
                            np.float32(0.0), db.deltas).astype(np.float64)
                   + np.float64(db.thr_log10))

    shards = []
    for i in range(mp):
        sel = (db.edges >= bounds[i]) & (db.edges < bounds[i + 1])
        keys, offsets, edges, deltas = build_csr(
            codes_full[sel], db.edges[sel],
            scores_full[sel], db.thr_log10)
        sub = PhyloKmerDB(k=db.k, omega=db.omega, alphabet=db.alphabet,
                          thr_log10=db.thr_log10, tree=db.tree,
                          keys=keys, offsets=offsets, edges=edges,
                          deltas=deltas)
        sub._arrays = db.arrays  # reuse; only n_edge_slots is read
        shards.append(sub.postings_tables(width))

    max_nl = max(pt.light_keys.shape[0] for pt in shards)
    max_nh = max(pt.heavy_keys.shape[0] for pt in shards)
    widths = np.diff(bounds)
    W = int(widths.max())
    Ptw = 2 * width

    light_pairs = np.zeros((mp, max_nl + 1, Ptw), np.int32)
    # edge halves default to the pad sentinel (sorts past every real
    # edge; presence = edge != sentinel, rappas_tpu_torch.db.LIGHT_PAD_EDGE)
    light_pairs[:, :, :width] = LIGHT_PAD_EDGE
    rof = np.zeros((mp, space + 1), np.int32)
    nl_arr = np.zeros(mp, np.int32)
    heavy_dense = np.zeros((mp, max_nh + 1, W), np.float32)
    heavy_keys = []
    light_keys = []
    for i, pt in enumerate(shards):
        nl = pt.light_keys.shape[0]
        nh = pt.heavy_keys.shape[0]
        nl_arr[i] = nl
        pairs = np.concatenate(
            [pt.light_edges, pt.light_deltas.view(np.int32)], axis=1)
        # rows beyond nl keep sentinel edges / zero deltas; row nl is
        # the miss row and pad rows past it are never addressed
        # (lrows = min(rof, nl))
        light_pairs[i, :nl] = pairs[:nl]
        r = np.full(space + 1, nl, np.int32)
        r[pt.light_keys] = np.arange(nl, dtype=np.int32)
        r[pt.heavy_keys] = nl + 1 + np.arange(nh, dtype=np.int32)
        rof[i] = r
        # heavy columns are local to the shard's edge range
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        heavy_dense[i, :nh, :hi - lo] = pt.heavy_dense[:nh, lo:hi]
        heavy_keys.append(pt.heavy_keys)
        light_keys.append(pt.light_keys)
    return bounds, dict(light_pairs=light_pairs, rof=rof, nl=nl_arr,
                        heavy_dense=heavy_dense, heavy_keys=heavy_keys,
                        light_keys=light_keys)


def slice_ambiguities(amb, lo: int, hi: int):
    """The windows of reads ``lo .. hi - 1`` of a host ambiguity
    expansion (``kidx, alt_win, win_read, win_inv_w, is_mean``), with read
    ids local to the slice and windows renumbered in order; None when the
    slice has none (``rappas_tpu/parallel/postings_sharded.py:181-187``
    masks the others out instead)."""
    if amb is None:
        return None
    kidx, alt_win, win_read, win_inv_w, is_mean = amb
    mine = (win_read >= lo) & (win_read < hi)
    if not mine.any():
        return None
    alt_mine = mine[alt_win]
    new_id = np.cumsum(mine) - 1
    return (kidx[alt_mine], new_id[alt_win[alt_mine]].astype(np.int32),
            (win_read[mine] - lo).astype(np.int32), win_inv_w[mine],
            is_mean[mine])


class PostingsShardedPlacement:
    """Large-tree placement over a (dp, mp) mesh: reads data-parallel,
    postings edge-range-sharded, exact top-K by merging the shards'
    candidate wires."""

    def __init__(self, db: PhyloKmerDB, mesh: Mesh, keep_at_most: int = 7,
                 postings_width: int = 8):
        self.db = db
        self.mesh = mesh
        self.k = db.k
        self.keep_at_most = keep_at_most
        self.thr = float(np.float32(db.thr_log10))
        bounds, t = shard_db_by_edge(db, mesh.shape["mp"], postings_width)
        self._bounds = bounds
        #: the shards' light rows, by the single-device engine's rule
        self.light_layout = LightLayout.of(postings_width, db.n_edge_slots)
        E, W = db.n_edge_slots, t["heavy_dense"].shape[2]
        self.n_edges = E
        # each shard sends its min(K, W) best, the merge keeps K of them
        # (:194-199)
        self._k_shard, self.wide, _ = kernels.wire_format(E, keep_at_most,
                                                          W)
        self.wire_k = min(keep_at_most, mesh.shape["mp"] * self._k_shard)
        self._shards = []
        for j in range(mesh.shape["mp"]):
            nl = int(t["nl"][j])
            nh = t["heavy_keys"][j].shape[0]
            wide = t["light_pairs"][j, :nl + 1]
            edges = wide[:, :postings_width]
            pairs = self.light_layout.pack(
                edges, wide[:, postings_width:].view(np.float32))
            heavy = np.ascontiguousarray(t["heavy_dense"][j, :nh + 1])
            cols = mesh.column(j)
            self._shards.append(dict(
                offset=int(bounds[j]), nl=nl, nh=nh, rof=t["rof"][j],
                light_counts=(edges != LIGHT_PAD_EDGE).sum(axis=1)
                .astype(np.int32), light_counts_on={},
                pairs=mesh.put(pairs, cols),
                heavy_dense=mesh.put(heavy, cols)))

    def score_async(self, codes: np.ndarray, lengths: np.ndarray,
                    amb_host=None) -> PendingSlices:
        """codes int8[B, L] (B divisible by dp); ``amb_host`` is the
        engine's host-side ambiguity expansion of the batch (or None).
        The results are those of the mesh's :meth:`~Mesh.local_rows`; on
        a mesh that spans processes this returns once the gathers have
        (they are synchronous)."""
        mesh, S = self.mesh, self.db.alphabet.n_states
        lengths = np.ascontiguousarray(lengths, np.int32)
        # the batch's k-mer indices once; -1 (invalid) -> the miss entry
        kidx = host_kmer_indices(codes, lengths, self.k, S)
        kidx = np.where(kidx >= 0, kidx, S ** self.k)
        parts = []
        for d, sl in dp_slices(mesh, codes.shape[0]):
            cols = mesh.row_columns(d)
            if not cols:
                continue
            amb = slice_ambiguities(amb_host, sl.start, sl.stop)
            wires, tally = [], []
            for j, dev in cols:
                sh = self._shards[j]
                host, plan = postings_batch(
                    sh["rof"][kidx[sl]], sh["nl"], sh["light_counts"],
                    lengths[sl], amb, None if amb is None else alt_rows_of(
                        sh["rof"][amb[0]], sh["nl"], sh["nh"]))
                count_p3(plan, lengths[sl], host["lrows"])
                H, pairs = sh["heavy_dense"][dev], sh["pairs"][dev]
                with mesh.on(dev):
                    t = stage(host, dev)
                    if tracing_on():
                        tally.extend(light_row_tally(
                            t["lrows"], sh["nl"], sh["light_counts"],
                            sh["light_counts_on"]))
                    plan = plan.staged(t)
                    acc_c = kernels.dense_side(H, t["hrows"], t["hoff"])
                    if "win_off" in t:
                        kernels.ambiguous_postings_(
                            acc_c, H, pairs, t["alt_lrows"], t["alt_hrows"],
                            t["win_off"], t["win_slot"], t["win_inv_w"],
                            t["win_is_mean"], sh["offset"],
                            layout=self.light_layout)
                    wires.append(kernels.finalize_postings_wire(
                        pairs, t["lrows"], acc_c, t["slot_of"],
                        t["lengths"], self.thr, self.k, self.keep_at_most,
                        plan, sh["offset"], self.n_edges,
                        layout=self.light_layout))
            lead = mesh.lead(d)
            with mesh.on(lead):
                wire = kernels.merge_candidates_wire(
                    torch.stack(mesh.gather(wires, d)), self._k_shard,
                    self.wire_k, self.wide)
                part = fetch_wire(wire, mesh.stream(lead), self.wire_k,
                                  self.wide)
                part.tally = tuple(tally) or None
                parts.append(part)
        return PendingSlices(parts)

    def score(self, codes: np.ndarray, lengths: np.ndarray,
              amb_host=None) -> BatchResult:
        return self.score_async(codes, lengths, amb_host).result()
