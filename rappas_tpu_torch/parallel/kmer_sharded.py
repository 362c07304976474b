"""K-mer-range DB sharding: model parallelism for the phylo-kmer table.

Port of ``rappas_tpu/parallel/kmer_sharded.py``.  For DBs whose *row*
space dwarfs one device's memory (k=12 DNA, 4000-taxon trees): the sorted
keys' compact table is split into ``mp`` contiguous k-mer ranges
(:func:`rappas_tpu_torch.convert.kmer_range_shards`).  The host searches
each window's global row once; every device of a mesh row folds those
rows into its own range and sums a partial ``[B / dp, E]`` tile (C3
``accumulate_rows_range``), the tiles are summed (:meth:`Mesh.psum`, the
psum over mp: k-mers are unique, so each posting comes from exactly one
shard; an all-reduce where the row spans processes) and the top-K taken
(K3).
"""

from __future__ import annotations

import numpy as np

from rappas_tpu_torch.convert import kmer_range_shards
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.parallel.mesh import Mesh, score_rows
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.place.engine import (BatchResult, host_kmer_indices,
                                           make_key_lookup)


class KmerShardedPlacement:
    """Placement with the compact table sharded by k-mer range over mp.

    The sorted-key search runs once on the host (int64 keys; amino k >= 8
    needs more than 31 bits); the devices receive global int32 row ids
    (miss -> ``n_kmers``) and each shard folds them into its own range
    (out of range -> the shard's zero row)."""

    def __init__(self, db: PhyloKmerDB, mesh: Mesh, keep_at_most: int = 7):
        self.db = db
        self.mesh = mesh
        self.k = db.k
        self.keep_at_most = keep_at_most
        self.thr = float(np.float32(db.thr_log10))
        per, shards = kmer_range_shards(db, mesh.shape["mp"])
        self._per = per
        self.n_local_rows = per + 1
        self.D = [mesh.put(s, mesh.column(j))
                  for j, s in enumerate(shards)]
        self._lookup = make_key_lookup(db.keys)
        self.wire_k, self.wide, _ = kernels.wire_format(db.n_edge_slots,
                                                        keep_at_most)

    def score(self, codes: np.ndarray, lengths: np.ndarray) -> BatchResult:
        """codes: int8[B, L] state codes (B divisible by dp) -> the
        results of the mesh's :meth:`~Mesh.local_rows`."""
        per = self._per
        lengths = np.ascontiguousarray(lengths, np.int32)
        rows = self._lookup(host_kmer_indices(
            codes, lengths, self.k, self.db.alphabet.n_states))

        def finish(d, tiles, t):
            return kernels.finalize_wire(self.mesh.psum(tiles, d),
                                         t["lengths"], self.thr, self.k,
                                         self.keep_at_most)
        return score_rows(
            self.mesh, codes.shape[0],
            lambda sl: {"rows": rows[sl], "lengths": lengths[sl]},
            lambda j, dev, t: kernels.accumulate_rows_range(
                self.D[j][dev], t["rows"], j * per, per),
            finish, self.wire_k, self.wide).result()
