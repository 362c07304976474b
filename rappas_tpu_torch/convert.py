"""Carry a phylo-kmer DB across from the JAX package, and onto a device.

The DB is this system's parameter set: a ``.rptpu`` file written by
either package loads in the other (:meth:`PhyloKmerDB.load` reads the
same bytes), and :func:`db_from_arrays` builds the port's DB from the
fields of a ``rappas_tpu`` ``PhyloKmerDB`` handed over as plain values
and numpy arrays, without importing that package.
"""

from __future__ import annotations

import numpy as np
import torch

from rappas_tpu_torch.alphabet import get_alphabet
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.tree import parse_newick


def db_from_arrays(k: int, omega: float, alphabet: str, thr_log10,
                   newick: str, keys: np.ndarray, offsets: np.ndarray,
                   edges: np.ndarray, deltas: np.ndarray,
                   meta: dict | None = None) -> PhyloKmerDB:
    """The port's DB from the JAX DB's fields.

    ``alphabet`` is the alphabet's name (``db.alphabet.name``);
    ``newick`` is the tree as ``.rptpu`` stores it, with jplace ``{x}``
    edge ids (``write_newick(tree, True, True, True, False)``)."""
    return PhyloKmerDB(
        k=int(k), omega=float(omega), alphabet=get_alphabet(alphabet),
        thr_log10=np.float32(thr_log10),
        tree=parse_newick(newick, jplace_edge_ids=True),
        keys=np.asarray(keys, np.int64),
        offsets=np.asarray(offsets, np.int64),
        edges=np.asarray(edges, np.int32),
        deltas=np.asarray(deltas, np.float32),
        meta=dict(meta or {}))


def device_tables(db: PhyloKmerDB, device) -> tuple:
    """``(D, scale, thr)`` on ``device``: the direct delta table
    f32[S^k + 1, E] (last row all zero: the miss row), the table's scale
    (1 for f32 tables) and the word threshold log10, both 0-d f32."""
    D = torch.from_numpy(db.dense_matrix(pad_rows=1)).to(device)
    scale = torch.tensor(1.0, dtype=torch.float32, device=device)
    thr = torch.tensor(float(db.thr_log10), dtype=torch.float32,
                       device=device)
    return D, scale, thr
