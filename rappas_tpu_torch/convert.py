"""Carry a phylo-kmer DB across from the JAX package, and onto a device.

The DB is this system's parameter set: a ``.rptpu`` file written by
either package loads in the other (:meth:`PhyloKmerDB.load` reads the
same bytes), and :func:`db_from_arrays` builds the port's DB from the
fields of a ``rappas_tpu`` ``PhyloKmerDB`` handed over as plain values
and numpy arrays, without importing that package.  The sharded tables of
a device mesh come from :func:`column_shards` (edge columns),
:func:`kmer_range_shards` (k-mer ranges) and
:func:`rappas_tpu_torch.parallel.postings_sharded.shard_db_by_edge`
(edge ranges of the postings layout).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rappas_tpu_torch.alphabet import get_alphabet
from rappas_tpu_torch.db import LightLayout, PhyloKmerDB
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


class DeviceTables(NamedTuple):
    """A dense layout of a DB on the device."""
    D: torch.Tensor            # f32 or uint16 [n_rows, E], last row zero
    scale: torch.Tensor        # 0-d f32: delta = D * scale
    thr: torch.Tensor          # 0-d f32 word threshold log10
    keys: torch.Tensor | None  # int32[n_kmers] sorted (compact, S^k < 2^31)


#: an f32 table's build on the device (:func:`f32_table`) scatters at
#: most this many postings a step, so that its buffers on the device (an
#: int64 index and an f32 delta a posting) stay under 0.8 MB whatever the
#: table's size; a key's postings are never cut, so a key wider than this
#: takes a step of its own
TABLE_STEP_POSTINGS = 1 << 16


def f32_table(db: PhyloKmerDB, device, table: str) -> torch.Tensor:
    """``db.dense_matrix(pad_rows=1)`` (``table="direct"``) or
    ``db.compact_matrix(pad_rows=1)`` (``"compact"``), built on
    ``device``: the zeroed table allocated there and the CSR's deltas
    scattered in by steps (:data:`TABLE_STEP_POSTINGS`), so that no host
    array of the table's shape exists.  A DB's (key, edge) pairs are
    unique (``build_csr`` keeps each pair's max), so the scatter writes
    what the host's assignment writes, bitwise."""
    device = torch.device(device)
    E = db.n_edge_slots
    n = db.n_kmers
    height = (db.alphabet.n_states ** db.k if table == "direct" else n) + 1
    D = torch.zeros((height, E), dtype=torch.float32, device=device)
    flat = D.view(-1)
    offsets = db.offsets
    lo = 0
    while lo < n:
        # the keys whose postings end within the step (at least one key)
        hi = int(np.searchsorted(
            offsets, offsets[lo] + TABLE_STEP_POSTINGS, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        p0, p1 = int(offsets[lo]), int(offsets[hi])
        rows = (db.keys[lo:hi] if table == "direct"
                else np.arange(lo, hi, dtype=np.int64))
        idx = np.repeat(rows * E, np.diff(offsets[lo:hi + 1]))
        idx += db.edges[p0:p1]
        flat.index_put_((torch.from_numpy(idx).to(device),),
                        torch.from_numpy(db.deltas[p0:p1]).to(device))
        lo = hi
    return D


def device_tables(db: PhyloKmerDB, device, table: str = "direct",
                  precision: str = "f32") -> DeviceTables:
    """The direct or compact table of ``db`` on ``device``
    (``rappas_tpu/place/engine.py:1079-1104``).

    ``D`` is ``dense_matrix`` (``[S^k + 1, E]``, row = k-mer index) or
    ``compact_matrix`` (``[n_kmers + 1, E]``, row = position in the sorted
    keys), f32 (built on the device by :func:`f32_table`) or, with
    ``precision="u16"``, their fixed-point ``_u16`` forms (built on the
    host and copied across); the last row is all zero (the miss row).
    ``scale`` is 1 for f32 tables.  ``keys`` is set for the compact table
    when k-mer indices fit int32 (``S^k <= 2^31 - 1``: the card searches
    the keys), else None (the host searches them)."""
    if table not in ("direct", "compact"):
        raise ValueError(f"no dense table for layout {table!r}")
    if precision not in ("f32", "u16"):
        raise ValueError(f"precision must be f32 or u16, got {precision!r}")
    if precision == "u16":
        D, scale = (db.dense_matrix_u16(pad_rows=1) if table == "direct"
                    else db.compact_matrix_u16(pad_rows=1))
        D = torch.from_numpy(D).to(device)
    else:
        D, scale = f32_table(db, device, table), np.float32(1.0)
    keys = None
    if table == "compact" and db.alphabet.n_states ** db.k <= 2 ** 31 - 1:
        keys = torch.from_numpy(db.keys).to(device).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=device)
    return DeviceTables(D, torch.tensor(float(scale), **f32),
                        torch.tensor(float(db.thr_log10), **f32), keys)


def light_parts(pairs: np.ndarray, part_bytes: int,
                max_parts: int) -> tuple[list, bool]:
    """The light table's height split (``rappas_tpu/place/engine.py:
    1126-1142``): ``(parts, slow)``.  A table past ``part_bytes``
    (``PlacementEngine.LIGHT_PART_BYTES``) is cut into ``ceil(nbytes /
    part_bytes)`` parts of equal height (``np.linspace`` cuts) when that
    is at most ``max_parts`` parts and the table has more rows than
    parts; rows keep their global order, so the miss row ``nl`` is the
    last row of the last part.  A table past the budget that cannot be
    cut stays one part with ``slow`` set."""
    slow = pairs.nbytes > part_bytes
    n_parts = -(-pairs.nbytes // max(part_bytes, 1))
    if slow and n_parts <= max_parts and pairs.shape[0] > n_parts:
        cuts = np.linspace(0, pairs.shape[0], n_parts + 1, dtype=np.int64)
        return [np.ascontiguousarray(pairs[lo:hi])
                for lo, hi in zip(cuts[:-1], cuts[1:])], False
    return [pairs], slow


def _direct_part_count(nbytes: int, n_rows: int, part_bytes: int,
                       split_min: int, max_parts: int) -> int:
    """Parts of a direct table of ``nbytes`` and ``n_rows`` rows (the
    miss row included), 0 when it stays whole
    (``rappas_tpu/place/engine.py:1692-1696``)."""
    n_parts = int(-(-nbytes // part_bytes))
    if (nbytes <= split_min or n_parts < 2 or n_parts > max_parts or
            n_rows - 1 < n_parts):
        return 0
    return n_parts


def direct_parts(dense: np.ndarray, part_bytes: int, split_min: int,
                 max_parts: int):
    """The direct table's height split (``rappas_tpu/place/engine.py:
    1675-1703``): ``(parts, cuts)``, or None when the table stays whole
    (at most ``split_min`` bytes, fewer than 2 or more than ``max_parts``
    parts of ``part_bytes``, ``PlacementEngine.DIRECT_PART_BYTES``, or
    fewer body rows than parts).  The global
    miss row (the last row of ``dense``, f32 or uint16) is dropped; part
    ``i`` is the body rows ``cuts[i] .. cuts[i + 1]`` plus one trailing
    zero row, its pad and miss target."""
    n_parts = _direct_part_count(dense.nbytes, dense.shape[0], part_bytes,
                                 split_min, max_parts)
    if not n_parts:
        return None
    body = dense[:-1]
    zero = np.zeros((1, dense.shape[1]), dense.dtype)
    cuts = np.linspace(0, body.shape[0], n_parts + 1, dtype=np.int64)
    return ([np.concatenate([body[lo:hi], zero])
             for lo, hi in zip(cuts[:-1], cuts[1:])], cuts)


def direct_split_tables(db: PhyloKmerDB, device, precision: str,
                        part_bytes: int, split_min: int, max_parts: int):
    """The direct table of ``db`` in ``precision`` (f32 or u16), split by
    :func:`direct_parts` onto ``device``: ``(parts, cuts, scale)``, or
    None when it stays whole -- decided from its size before the table is
    built.  As in JAX, a split table lives only as its parts."""
    itemsize = 2 if precision == "u16" else 4
    n_rows = db.alphabet.n_states ** db.k + 1
    if not _direct_part_count(n_rows * db.n_edge_slots * itemsize, n_rows,
                              part_bytes, split_min, max_parts):
        return None
    if precision == "u16":
        dense, scale = db.dense_matrix_u16(pad_rows=1)
    else:
        dense, scale = db.dense_matrix(pad_rows=1), np.float32(1.0)
    parts, cuts = direct_parts(dense, part_bytes, split_min, max_parts)
    del dense
    return ([torch.from_numpy(p).to(device) for p in parts], cuts,
            np.float32(scale))


class PostingsState(NamedTuple):
    """The postings layout of a DB: device tables and host lookups."""
    layout: LightLayout        # the light rows' words
    light_parts: tuple         # int32[H_i, w] parts of pairs[nl + 1, w]
    light_slow: bool           # one part, past the part budget
    heavy_dense: torch.Tensor  # f32[nh + 1, E] on the device
    light_counts: np.ndarray   # int32[nl + 1] real postings per row
    light_keys: np.ndarray     # int64[nl] sorted
    heavy_keys: np.ndarray     # int64[nh] sorted
    rof: np.ndarray | None     # int32[S^k + 1] encoded row per k-mer

    @property
    def pairs(self) -> torch.Tensor:
        """The light table of an unsplit layout."""
        if len(self.light_parts) != 1:
            raise ValueError(f"the light table is split into "
                             f"{len(self.light_parts)} parts")
        return self.light_parts[0]


def postings_device_tables(db: PhyloKmerDB, width: int, device,
                           direct_index_limit: int = 1 << 30,
                           part_bytes: int | None = None,
                           max_parts: int = 32) -> PostingsState:
    """The postings layout of ``db`` (``rappas_tpu/place/engine.py:
    1110-1166``), the light table height-split by :func:`light_parts`
    when ``part_bytes`` is given (one part when it is None).

    ``pairs[r]`` holds light k-mer ``r``'s P postings in the
    ``LightLayout.of(width, n_edge_slots)`` row of ``w`` words: below
    65,535 edge slots P u16 edge ids in ``ceil(P / 2)`` words (pads
    ``0xFFFF``), else P int32 ids (pads ``LIGHT_PAD_EDGE``), then P
    bit-cast f32 deltas (pads 0.0); the last row is all pads, the miss
    row.  The rows are packed on the host and uploaded once, so no wider
    copy of the table reaches the device.  ``heavy_dense`` holds the
    k-mers with more than ``width`` postings as dense rows (last row
    zero).  ``rof`` maps a k-mer index to its encoded row (``r < nl``
    light row ``r``, ``nl`` miss, ``nl + 1 + h`` heavy row ``h``; index
    ``S^k`` is the miss target of invalid windows) when it takes at most
    ``direct_index_limit`` bytes, else None (the host searches the
    sorted keys instead)."""
    pt = db.postings_tables(width)
    nl, nh = pt.light_keys.shape[0], pt.heavy_keys.shape[0]
    layout = LightLayout.of(width, db.n_edge_slots)
    pairs = layout.pack(pt.light_edges, pt.light_deltas)
    light_counts = (pt.light_deltas > 0).sum(1).astype(np.int32)
    space = db.alphabet.n_states ** db.k
    rof = None
    if space * 4 <= direct_index_limit:
        rof = np.full(space + 1, nl, np.int32)
        rof[pt.light_keys] = np.arange(nl, dtype=np.int32)
        rof[pt.heavy_keys] = nl + 1 + np.arange(nh, dtype=np.int32)
    parts, slow = ([pairs], False) if part_bytes is None else \
        light_parts(pairs, part_bytes, max_parts)
    return PostingsState(
        layout=layout,
        light_parts=tuple(torch.from_numpy(p).to(device) for p in parts),
        light_slow=slow,
        heavy_dense=torch.from_numpy(pt.heavy_dense).to(device),
        light_counts=light_counts, light_keys=pt.light_keys,
        heavy_keys=pt.heavy_keys, rof=rof)


def column_shards(db: PhyloKmerDB, table: str, mp: int) -> list:
    """The direct or compact f32 table of ``db`` (``dense_matrix`` /
    ``compact_matrix``, last row zero) cut into ``mp`` contiguous column
    shards of equal width, the edge axis first padded with zero columns
    to a multiple of ``mp`` (``rappas_tpu/parallel/mesh.py:59-65``,
    ``parallel/engine.py:95-100``): padded columns are never matched."""
    if table not in ("direct", "compact"):
        raise ValueError(f"no dense table for layout {table!r}")
    dense = (db.dense_matrix(pad_rows=1) if table == "direct"
             else db.compact_matrix(pad_rows=1))
    pad = (-dense.shape[1]) % mp
    if pad:
        dense = np.pad(dense, ((0, 0), (0, pad)))
    w = dense.shape[1] // mp
    return [np.ascontiguousarray(dense[:, j * w:(j + 1) * w])
            for j in range(mp)]


def kmer_range_shards(db: PhyloKmerDB, mp: int):
    """``(per, shards)``: the compact f32 table split into ``mp``
    contiguous ranges of ``per = ceil(n_kmers / mp)`` rows
    (``rappas_tpu/parallel/kmer_sharded.py:53-68``); shard ``i`` holds
    rows ``i * per ..`` and is ``[per + 1, E]``, zero past its last row
    (its row ``per`` is the miss row)."""
    n = db.n_kmers
    per = -(-n // mp)
    compact = db.compact_matrix(pad_rows=0)
    shards = []
    for i in range(mp):
        lo, hi = i * per, min((i + 1) * per, n)
        sh = np.zeros((per + 1, compact.shape[1]), np.float32)
        if hi > lo:
            sh[:hi - lo] = compact[lo:hi]
        shards.append(sh)
    return per, shards
