"""Mesh-aware placement engine: the CLI's multi-device path.

Port of ``rappas_tpu/parallel/engine.py``: a drop-in
:class:`~rappas_tpu_torch.place.engine.PlacementEngine` over a ``(dp,
mp)`` :class:`~rappas_tpu_torch.parallel.mesh.Mesh` that plugs into
``place.pipeline.place_queries`` wherever the single-device engine does,
with all three table layouts and IUPAC ambiguity expansion.  A batch is
cut into ``dp`` slices, one per mesh row.

* **dense layouts (direct / compact)**: the table is cut into ``mp``
  column (edge) shards (:func:`rappas_tpu_torch.convert.column_shards`).
  Per slice the host runs the single engine's batch preparation (the
  direct table's per-read split, the ambiguity expansion); each device of
  the row sums its shard's tile with the single engine's kernels (K1/K2
  or C1/C2, then K4), the tiles are all-gathered (across processes on a
  mesh with ranks) and K3 runs on the whole row -- what GSPMD does to the
  single-chip functions in JAX.
* **postings layout (large trees)**: ``PostingsShardedPlacement`` of
  :mod:`rappas_tpu_torch.parallel.postings_sharded`.

Sharded placement is f32-only (strict parity with the single-device
default; the postings sort payload needs exact deltas), and the table
auto-selection budget is the per-card budget
(``PlacementEngine.table_budget``) times ``mp``: a DB too big for one
device is exactly why the mp axis exists.  The layout and the postings
layout's light width come from ``PlacementEngine.resolve_layout``, as on
one device.
"""

from __future__ import annotations

import numpy as np
import torch

from rappas_tpu_torch.convert import column_shards
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.parallel.mesh import Mesh, dp_slices, score_rows
from rappas_tpu_torch.parallel.postings_sharded import \
    PostingsShardedPlacement
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.place.engine import (BatchResult, PendingBatch,
                                           PlacementEngine)


class ShardedEngine(PlacementEngine):
    """Drop-in ``PlacementEngine`` over a (dp, mp) device mesh.  Its
    tables are sharded, never height-split."""

    SINGLE_DEVICE = False

    def __init__(self, db: PhyloKmerDB, mesh: Mesh,
                 keep_at_most: int = 7,
                 treat_ambiguities: bool = True,
                 ambiguities_with_max: bool = False,
                 table: str = "auto", postings_width: int = 8):
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.mp = mesh.shape["mp"]
        # the per-card budget of the mesh's first device, once per shard
        table, postings_width = self.resolve_layout(
            db, table, "f32",
            self.table_budget(mesh.devices.flat[0]) * self.mp,
            postings_width)
        if table not in ("direct", "compact", "postings"):
            raise ValueError(f"table must be auto/direct/compact/"
                             f"postings, got {table!r}")
        self._init_params(db, keep_at_most, treat_ambiguities,
                          ambiguities_with_max, "f32", table)
        self.scale = 1.0
        self.keys_dev = None
        self._postings = None
        if table == "postings":
            self.postings_width = postings_width
            self._postings = PostingsShardedPlacement(
                db, mesh, keep_at_most=keep_at_most,
                postings_width=postings_width)
            self.light_layout = self._postings.light_layout
            self.wire_k = self._postings.wire_k
        else:
            shards = column_shards(db, table, self.mp)
            self.n_rows = shards[0].shape[0]
            self.D_shards = [mesh.put(s, mesh.column(j))
                             for j, s in enumerate(shards)]
            self.wire_k, self.wide, _ = kernels.wire_format(
                shards[0].shape[1] * self.mp, keep_at_most)
            if table == "compact" and \
                    db.alphabet.n_states ** db.k <= 2 ** 31 - 1:
                # the int32 keys on every distinct device (C1); above 31
                # bits the host searches them (C2), as the single engine
                self.keys_dev = mesh.put(db.keys.astype(np.int32),
                                         mesh.distinct)
        self._init_host_codec()

    # -------------------------------------------------------------- #
    def score_async(self, matrix: np.ndarray, lengths: np.ndarray):
        """The batch's handle; its results are those of the mesh's
        :meth:`~rappas_tpu_torch.parallel.mesh.Mesh.local_rows` (every
        row on a mesh of this process alone).  On a mesh that spans
        processes the call is synchronous at each row's collective."""
        B, L = matrix.shape
        dp_slices(self.mesh, B)          # B must divide by dp
        if L < self.k:
            K = min(self.keep_at_most, self.db.n_edge_slots)
            n = len(self.mesh.local_rows()) * (B // self.dp)
            return PendingBatch(BatchResult(
                np.full((n, K), -1, np.int32),
                np.full((n, K), -np.inf, np.float32),
                np.zeros((n, K), np.float32),
                np.zeros(n, np.int32)))
        lengths = np.ascontiguousarray(lengths, np.int32)
        codes = self.encode_batch(matrix)
        if self.table == "postings":
            amb = (self._expand_ambiguities_host(codes, matrix, lengths)
                   if self.treat_ambiguities else None)
            return self._postings.score_async(codes, lengths, amb_host=amb)
        return score_rows(
            self.mesh, B,
            lambda sl: self.dense_inputs(codes[sl], matrix[sl], lengths[sl]),
            lambda j, dev, t: self.dense_acc(
                t, self.D_shards[j][dev],
                self.keys_dev and self.keys_dev[dev], B // self.dp, L),
            lambda d, tiles, t: kernels.finalize_wire(
                torch.cat(self.mesh.gather(tiles, d), dim=1), t["lengths"],
                self.thr, self.k, self.keep_at_most),
            self.wire_k, self.wide)
