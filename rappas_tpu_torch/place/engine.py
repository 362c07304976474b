"""Placement engine on PyTorch: batched k-mer scoring on the device.

Port of ``rappas_tpu/place/engine.py`` for the **direct**, **compact**
and **postings** table layouts, the first two in f32 or u16.

Direct (small trees): the phylo-kmer table is a dense delta matrix
``D[S^k + 1, E]`` on the device (``E`` = per-node score slots of the
original tree, last row all-zero = miss target), and a batch of reads is
scored at once:

    ``S[b, e] = Q_b * thr + sum_q D[kmer(b, q), e]``

(``PlacementProcess.java:726-734``), then top-K and ``|L|`` per read;
IUPAC-ambiguous windows add their mean / max contributions
(``PlacementProcess.java:1129-1236``).  The device work runs in four
CUDA kernels of :mod:`rappas_tpu_torch.place.kernels`:

* K1 ``accumulate_packed`` -- reads with no ambiguous or invalid code
  inside their length, shipped 2-bit packed (a quarter of the H2D bytes);
* K2 ``accumulate_codes`` -- the other reads, shipped as int8 codes;
* K4 ``ambiguous_pass_`` -- ambiguity windows, added into ``acc``;
* K3 ``finalize_wire`` -- top-K and ``|L|`` into one int32 wire array.

K1 and K2 each write their own rows of one ``[B, E]`` accumulator, so a
batch with a few ambiguous reads still sends the rest packed (the JAX
engine packs a batch only when no read in it needs codes; the results
are the same).

Compact (``D[n_kmers + 1, E]``, row = position in the sorted keys; what
``table="auto"`` takes on the card for a DB whose keys fit int32 and
whose compact table fits ``AUTO_COMPACT_BYTES``, or a heavy-dominated
one past it that fits one table's budget and whose postings layout would
not be a small share of it): when k-mer indices fit
int32, every read goes as codes to C1 ``accumulate_compact``, which
searches the keys on the card (the JAX engine packs only for direct);
above 31 bits (amino k >= 8, DNA k >= 16) the host searches the keys
(``_db_lookup``) and C2 ``accumulate_rows`` sums the rows.  Ambiguity
alternatives take their rows from the host search in both cases, then
K4 and K3 run as above.

The f32 direct and compact tables are built on the device from the DB's
postings (``convert.f32_table``); no host array of their shape exists.
``precision="u16"`` (direct or compact; postings is f32-only): the table
holds fixed-point deltas (``db.dense_matrix_u16``, built on the host and
copied across), the kernels' u16
instances sum them in f32 and apply the scale once, and K4 scales each
alternative's row before its ``exp2``.

Postings (large trees, protein; ``convert.postings_device_tables``;
``table="auto"`` past the compact line takes it at ``postings_width`` for
a light-dominated DB, or at the DB's own light width, :func:`light_width`,
when that makes it a small share of the compact table):
k-mers with at most ``postings_width`` postings live in one light table
``pairs[nl + 1, w]`` (P edge ids, then P bit-cast deltas: ``w = ceil(P /
2) + P`` words with u16 ids below 65535 edge slots, ``2P`` with int32 ids
at or above, ``db.LightLayout``), the others in a dense
``heavy_dense[nh + 1, E]``.  The host maps every window to an
encoded row and left-packs each read's light hits in one native sweep
(``native/keyprobe.cpp``, built with g++ at first use: a direct index,
or a key probe for big k-mer spaces), and gives each read
with dense content (heavy hits, ambiguity windows) one slot.  Then:

* P1 ``dense_side`` -- heavy hit rows summed per slot into ``acc_c``;
* P2 ``ambiguous_postings_`` -- ambiguity windows added into ``acc_c``;
* P3 ``finalize_postings_wire`` -- per read, sort and sum the light
  postings, join the slot's dense row, top-K and ``|L|`` into the wire.

The wire, like the light rows, carries edge ids as u16 below 65535 edge
slots and as int32 at or above (``kernels.WIDE_EDGES``).  On
``device="cpu"`` the wrappers compute their plain PyTorch versions.

Height-split tables (one device; JAX's rules, the H100's budgets): a
light table past ``LIGHT_PART_BYTES`` lives as up to ``MAX_LIGHT_PARTS``
parts (``convert.light_parts``), and P3 reads it through one of JAX's
row sources (:meth:`PlacementEngine._light_source`): the **routed**
windows (the default; R1 ``finalize_postings_wire_routed``), the
**two-stage** compact table of the batch's unique rows (G1
``gather_compact``, then P3 on it, within ``TWO_STAGE_MAX_UNIQUE`` rows
and ``TWO_STAGE_MAX_BYTES``; with :meth:`PlacementEngine.enable_pipeline`,
G1 of the next batch runs on a second stream beside this batch's P3), the
**select** fallback (R1 ``finalize_postings_wire_parts``) for a batch
whose unique rows overflow, halved first down to ``MIN_SPLIT_B`` reads
(:class:`SplitPending`; never, by default); A1
``ambiguous_postings_parts`` scores ambiguity windows over the parts.  A
direct table past ``DIRECT_SPLIT_MIN`` lives as parts of
``DIRECT_PART_BYTES`` (``convert.direct_parts``): the host routes each
read's windows to their parts, D1 ``routed_accumulate`` and A1
``ambiguous_pass_split`` replace K1/K2 and K4.  On the H100 neither
table is split by default: one table outran its parts (PERF.md).

Host side (copied from the JAX engine): the ASCII -> code table, the
ambiguity expansion and its cycling order, 2-bit packing, the k-mer
lookups and the wire decode.  The table layout rule
(:meth:`PlacementEngine.resolve_table`) is the H100's own.  Per batch the host
inputs travel in ONE pinned staging buffer with one H2D copy on the
engine's stream, and the result comes back as one pinned copy of the
wire words; ``result()`` waits on the event recorded after it.  The
sharded engines of :mod:`rappas_tpu_torch.parallel` run these same steps
per mesh device (:meth:`PlacementEngine.dense_inputs`,
:meth:`PlacementEngine.dense_acc`, :func:`postings_batch`, :func:`stage`,
:func:`fetch_wire`).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from rappas_tpu_torch import native
from rappas_tpu_torch.convert import (device_tables, direct_split_tables,
                                      postings_device_tables)
from rappas_tpu_torch.db import LightLayout, PhyloKmerDB
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.utils import count, span, tracing_on

PAD_CODE = -2     # beyond read end
AMBIG_CODE = -1   # IUPAC ambiguity position

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


class BatchResult(NamedTuple):
    """Device outputs for one read batch (host arrays after fetch)."""
    top_edges: np.ndarray   # int32[B, K] original-tree node ids (-1 pad)
    top_scores: np.ndarray  # float32[B, K] descending
    top_lwr: np.ndarray     # float32[B, K]
    n_matched: np.ndarray   # int32[B] = |L| per read


def unpack_wire(words, K: int, wide: bool = False) -> BatchResult:
    """Host-side decode of the wire words (``kernels.pack_wire``, the
    wide form when ``wide``); LWR recomputed with the same f32 FORMULA
    ``kernels.finalize`` uses (exp2 of the max-shifted scores,
    normalized; host exp2 vs device exp2 can differ 1 ulp).  A row whose
    ``|L|`` is negative is a read P3 could not sort (its plan gave it
    too little room): that raises."""
    words = np.asarray(words)
    ts = words[:, :K].copy().view(np.float32)
    if wide:
        te = words[:, K:2 * K].copy()
        nm = words[:, 2 * K]
    else:
        K2 = (K + 1) // 2
        edges = words[:, K:K + K2].copy().view(np.uint16)[:, :K]
        nm = words[:, K + K2]
        te = np.where(edges == 65535, -1, edges.astype(np.int32))
    if nm.size and int(nm.min()) < 0:
        raise RuntimeError(f"P3 could not sort read "
                           f"{int(np.argmin(nm))}: its postings exceed "
                           "the room its plan gave it")
    valid = te >= 0
    # -inf - -inf on fully-unplaced rows is nan inside np.where's
    # eagerly-evaluated branch; the mask discards it
    with np.errstate(invalid="ignore"):
        d = np.where(valid, ts - ts[:, :1], np.float32(-np.inf))
    w = np.exp2(d * np.float32(np.log2(10.0)), dtype=np.float32)
    lwr = w / np.maximum(w.sum(axis=1, keepdims=True),
                         np.float32(1e-30))
    return BatchResult(te, ts, lwr.astype(np.float32), nm)


class PendingBatch:
    """Handle for a scored batch: its wire words (a pinned host copy
    while the D2H copy may be in flight) and the CUDA event recorded after
    that copy, or a finished :class:`BatchResult`.  ``tally``, counters'
    ``(name, n, per)``, adds each ``n * per`` to its counter once the
    event has passed (``n`` a 0-d tensor that the device fills before the
    event)."""

    def __init__(self, out, wire: int = 0, event=None, wide: bool = False,
                 tally=None):
        self._out = out
        self._wire = wire
        self._event = event
        self._wide = wide
        self.tally = tally

    def result(self) -> BatchResult:
        if isinstance(self._out, BatchResult):
            return self._out
        with span("engine.sync"):
            if self._event is not None:
                self._event.synchronize()
        if self.tally is not None:
            for name, n, per in self.tally:
                count(name, int(n) * per)
            self.tally = None
        with span("engine.unpack"):
            return unpack_wire(self._out.numpy(), self._wire, self._wide)


class SplitPending:
    """Handle for a batch scored as two halves (the two-stage path's
    unique-overflow halving, ``rappas_tpu/place/engine.py:134-148``):
    reads are independent, so the results concatenate."""

    def __init__(self, p1, p2):
        self._parts = (p1, p2)

    def result(self) -> BatchResult:
        r1, r2 = (p.result() for p in self._parts)
        return BatchResult(*(np.concatenate([a, b]) for a, b in zip(r1, r2)))


class PipelinedBatch:
    """Handle for a batch riding the postings software pipeline
    (``rappas_tpu/place/engine.py:151-168``): its P3 is issued when the
    next batch arrives, so that the next batch's G1 overlaps it;
    ``result()`` issues it first if it is still the pipeline's tail."""

    def __init__(self, engine, entry: dict):
        self._engine = engine
        self._entry = entry

    def result(self) -> BatchResult:
        if self._entry["out"] is None:
            self._engine._pp_flush(self._entry)
        return self._entry["out"].result()


def _bucket_size(n: int) -> int:
    """Smallest padded size >= n on a ladder of four steps per power of
    two (``rappas_tpu/place/engine.py:506-520``): the padded length of a
    part's batch-unique rows and of the routed window matrices."""
    n = max(int(n), 1)
    if n <= 16:
        return 1 << (n - 1).bit_length()       # the power of two
    step = 1 << ((n - 1).bit_length() - 3)
    return -(-n // step) * step


def _fast_unique_inverse(flat: np.ndarray):
    """(sorted unique values, inverse map) by ``torch.unique`` on the
    host (``rappas_tpu/place/engine.py:523-532``)."""
    u, inv = torch.unique(torch.from_numpy(flat), return_inverse=True)
    return u.numpy(), inv.numpy()


def route_rows(rows: np.ndarray, cuts: np.ndarray,
               drop=None) -> np.ndarray:
    """Rows [B, Q] routed to the parts that ``cuts`` bound
    (``rappas_tpu/place/engine.py:1705-1734``): int32[n_parts, B, W], part
    ``p``'s part-LOCAL rows of each read stable-left-packed, W one shared
    :func:`_bucket_size` width, pad slots holding the part's height; rows
    equal to ``drop`` (and rows past the last cut) are left out."""
    B = rows.shape[0]
    n = len(cuts) - 1
    masks = []
    for p in range(n):
        m = (rows >= cuts[p]) & (rows < cuts[p + 1])
        if drop is not None:
            m &= rows != drop
        masks.append(m)
    w_max = max((int(m.sum(axis=1).max()) if m.size else 0) for m in masks)
    out = np.empty((n, B, _bucket_size(max(w_max, 1))), np.int32)
    for p, m in enumerate(masks):
        out[p] = int(cuts[p + 1] - cuts[p])
        bb, qq = np.nonzero(m)
        if bb.size:
            pos = (np.cumsum(m, axis=1) - 1)[bb, qq]
            out[p, bb, pos] = rows[bb, qq] - cuts[p]
    return out


def fetch_wire(wire: torch.Tensor, stream, K: int,
               wide: bool) -> PendingBatch:
    """Start the one D2H copy of a batch's wire words (pinned, on
    ``stream``, the current stream of the wire's device) and return its
    handle; on the CPU (``stream`` None) the wire itself."""
    with span("engine.fetch"):
        if stream is None:
            return PendingBatch(wire, wire=K, wide=wide)
        out = torch.empty(wire.shape, dtype=torch.int32, pin_memory=True)
        out.copy_(wire, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    count("engine.d2h_bytes", out.numel() * out.element_size())
    return PendingBatch(out, wire=K, event=done, wide=wide)


def stage(arrays: dict, device: torch.device) -> dict:
    """Host arrays -> tensors of the same dtype and shape on ``device``.
    On the card: one pinned staging buffer (16-byte aligned slots) and ONE
    non-blocking H2D copy on the current stream."""
    with span("engine.stage"):
        if device.type != "cuda":
            return {n: torch.from_numpy(np.ascontiguousarray(a))
                    for n, a in arrays.items()}
        offs, total = {}, 0
        for n, a in arrays.items():
            offs[n] = total
            total += -(-a.nbytes // 16) * 16
        pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        buf = pinned.numpy()
        for n, a in arrays.items():
            buf[offs[n]:offs[n] + a.nbytes] = \
                np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev = pinned.to(device, non_blocking=True)
    count("engine.h2d_bytes", total)
    return {n: dev[offs[n]:offs[n] + a.nbytes]
            .view(_TORCH_DTYPES[a.dtype]).view(a.shape)
            for n, a in arrays.items()}


def pack_reads(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing of int8 state codes (no ambiguities);
    negative codes pack as 0 (their windows are masked by length)."""
    B, L = codes.shape
    safe = np.where(codes < 0, 0, codes).astype(np.uint8)
    pad = (-L) % 4
    if pad:
        safe = np.pad(safe, ((0, 0), (0, pad)))
    quads = safe.reshape(B, -1, 4)
    return (quads[:, :, 0] | (quads[:, :, 1] << 2) |
            (quads[:, :, 2] << 4) | (quads[:, :, 3] << 6)).astype(np.uint8)


def window_offsets(alt_win: np.ndarray, n_win: int) -> np.ndarray:
    """CSR offsets int32[n_win + 1] of the alternatives of each window
    (``alt_win`` must be grouped by ascending window id, as the host
    expansion emits them)."""
    if alt_win.size > 1 and (np.diff(alt_win) < 0).any():
        raise ValueError("ambiguity alternatives are not grouped by "
                         "ascending window id")
    off = np.zeros(n_win + 1, np.int32)
    np.cumsum(np.bincount(alt_win, minlength=n_win), out=off[1:])
    return off


def host_kmer_indices(codes: np.ndarray, lengths: np.ndarray, k: int,
                      n_states: int) -> np.ndarray:
    """[B, Q] k-mer indices on host (-1 = window contains ambiguity or
    padding).  int32 when the index space fits; >31-bit spaces run the
    Horner recurrence as two int32 halves combined once in int64."""
    B, L = codes.shape
    Q = L - k + 1
    amb = np.zeros((B, Q), bool)
    for i in range(k):
        amb |= codes[:, i:i + Q] < 0
    amb |= np.arange(Q)[None, :] > (lengths[:, None] - k)

    def horner(lo_pos, hi_pos, dtype):
        acc = np.zeros((B, Q), dtype)
        for i in range(lo_pos, hi_pos):
            acc *= n_states
            acc += np.maximum(codes[:, i:i + Q], 0).astype(dtype)
        return acc

    if n_states ** k <= 2 ** 31 - 1:
        return np.where(amb, np.int32(-1), horner(0, k, np.int32))
    k2 = k // 2
    if n_states ** max(k2, k - k2) <= 2 ** 31 - 1:
        hi = horner(0, k - k2, np.int32).astype(np.int64)
        lo = horner(k - k2, k, np.int32).astype(np.int64)
        idx = hi * np.int64(n_states ** k2) + lo
    else:       # neither half fits (amino k >= 16): plain int64 pass
        idx = horner(0, k, np.int64)
    return np.where(amb, np.int64(-1), idx)


def searchsorted_rows(keys: np.ndarray, kidx: np.ndarray) -> np.ndarray:
    """Sorted-key lookup: hit -> position, miss -> len(keys) (the
    trailing all-zero pad row)."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(kidx.shape, np.int32)
    pos = np.searchsorted(keys, kidx)
    hit = (pos < n) & (keys[np.clip(pos, 0, n - 1)] == kidx)
    return np.where(hit, pos, n).astype(np.int32)


class HostKeyIndex:
    """Bucketed sorted-key lookup for BIG key sets.

    A one-time index maps the top key bits to the covering range of the
    sorted key array (``lo[b] .. lo[b+1]``); per batch each query then
    linear-scans its bucket (avg < 1 key with ``2^22`` buckets) with
    vectorized gathers over the still-unresolved subset.  Queries landing
    in rare oversized buckets (> ``scan_cap`` entries) fall back to one
    classic searchsorted over just that subset, so worst-case cost is
    never worse than the plain form.

    Semantics identical to :func:`searchsorted_rows` (miss -> ``n``,
    including the ``-1`` padding sentinel of ambiguous windows).
    """

    def __init__(self, keys: np.ndarray, n_buckets_log2: int = 22,
                 scan_cap: int = 16):
        self.keys = keys
        self.n = int(keys.shape[0])
        self.scan_cap = scan_cap
        kmax = int(keys[-1]) if self.n else 0
        self.shift = max(0, kmax.bit_length() - n_buckets_log2)
        nb = (kmax >> self.shift) + 2 if self.n else 2
        edges = (np.arange(nb, dtype=np.int64) << self.shift)
        # int32 bucket table: halves the random-access footprint of the
        # per-query probe
        self.lo = np.searchsorted(keys, edges).astype(np.int32)

    def __call__(self, kidx: np.ndarray) -> np.ndarray:
        n = self.n
        flat = kidx.ravel()
        out = np.full(flat.shape, n, np.int32)
        if n == 0:
            return out.reshape(kidx.shape)
        qi = np.flatnonzero((flat >= 0) & (flat <= int(self.keys[-1])))
        q = flat[qi]
        b = (q.astype(np.int64) >> self.shift)
        lo = self.lo[b]
        hi = self.lo[b + 1]
        for _ in range(self.scan_cap):
            active = lo < hi
            if not active.any():
                break
            qi, q, lo, hi = qi[active], q[active], lo[active], hi[active]
            kv = self.keys[lo]
            is_hit = kv == q
            out[qi[is_hit]] = lo[is_hit]
            keep = ~(is_hit | (kv > q))   # sorted: kv > q => q absent
            qi, q, lo, hi = qi[keep], q[keep], lo[keep] + 1, hi[keep]
        else:
            if qi.size:   # oversized buckets: classic search, subset only
                pos = np.searchsorted(self.keys, q)
                is_hit = (pos < n) & (self.keys[np.clip(pos, 0, n - 1)]
                                      == q)
                out[qi[is_hit]] = pos[is_hit]
        return out.reshape(kidx.shape)


#: keys below this size keep plain searchsorted (index build not worth it)
_KEY_INDEX_MIN = 1 << 16


def make_key_lookup(keys: np.ndarray):
    """Callable ``kidx -> rows`` with :func:`searchsorted_rows` semantics,
    bucket-indexed when the key set is big enough to pay for it."""
    if keys.shape[0] >= _KEY_INDEX_MIN:
        return HostKeyIndex(keys)
    return functools.partial(searchsorted_rows, keys)


def postings_batch(rof: np.ndarray, nl: int, light_counts: np.ndarray,
                   lengths: np.ndarray, amb=None, alt_rows=None,
                   packed=None):
    """:meth:`PlacementEngine.postings_inputs` from a batch's encoded rows
    ``rof`` int32[B, Q] (``r < nl`` light row, ``nl`` miss, ``nl + 1 + h``
    heavy row ``h``) of one light / heavy table pair with ``light_counts``
    real postings per light row; ``amb`` the host ambiguity expansion
    (``kidx`` unused here) and ``alt_rows`` its alternatives' (light,
    heavy) rows in these tables, or both None; ``packed`` the light rows
    that :func:`rappas_tpu_torch.native.probe_light_rows` packed beside
    ``rof`` (its ``lrows``, ``hits``, ``pairs``, ``n_heavy``), or None to
    pack them here."""
    B = rof.shape[0]
    # np.nonzero of the 2-D mask, in the same row-major order, at a
    # tenth of its cost; no pass at all when the sweep counted no heavy hit
    hb, hq = (np.zeros((2, 0), np.int64) if packed and not packed[3] else
              np.divmod(np.flatnonzero(rof > nl), rof.shape[1]))
    win_read = amb[2] if amb is not None else np.zeros(0, np.int32)
    uniq_reads = np.unique(np.concatenate([hb, win_read]))
    slot_of = np.full(B, -1, np.int32)
    slot_of[uniq_reads] = np.arange(uniq_reads.size, dtype=np.int32)
    hoff = np.zeros(uniq_reads.size + 1, np.int32)
    np.cumsum(np.bincount(slot_of[hb], minlength=uniq_reads.size),
              out=hoff[1:])
    host = {"lengths": lengths, "slot_of": slot_of,
            "hrows": (rof[hb, hq] - (nl + 1)).astype(np.int32),
            "hoff": hoff}
    if amb is not None:
        _, alt_win, win_read, win_inv_w, is_mean = amb
        host["alt_lrows"], host["alt_hrows"] = alt_rows
        host["win_off"] = window_offsets(alt_win, win_read.shape[0])
        host["win_slot"] = slot_of[win_read]
        host["win_inv_w"] = win_inv_w.astype(np.float32)
        host["win_is_mean"] = is_mean.astype(np.uint8)

    # stable left-pack of the light hit windows into JAX's width ladder
    # (rappas_tpu/place/engine.py:1460-1479), so that the two-stage path
    # sees the same rows; the dropped slots are misses, whose pad postings
    # never reach a sum
    if packed is None:
        hit = rof < nl
        counts = hit.sum(axis=1)
    else:
        full, counts, pairs, _ = packed
    w_max = int(counts.max()) if counts.size else 0
    Q = rof.shape[1]
    W = next((c for c in (8, 16, 32, 48, 64, 96, 128, 192, 256)
              if w_max <= c < Q - 8), Q)
    if packed is None:
        # boolean masks take and fill in row-major order: each read's hits
        # in window order into its first slots
        lrows = np.full((B, W), nl, np.int32)
        lrows[np.arange(W) < counts[:, None]] = rof[hit]
        pairs = light_counts[lrows].sum(axis=1)
    else:
        lrows = np.ascontiguousarray(full[:, :W])
    host["lrows"] = lrows
    with span("engine.plan"):
        plan = kernels.postings_plan(pairs)
    host.update((n, t.numpy()) for n, t in plan.tensors().items())
    return host, plan


def count_p3(plan: kernels.PostingsPlan, lengths: np.ndarray,
             lrows: np.ndarray) -> None:
    """The counters of one P3 launch over reads of ``lengths`` from its
    host plan: reads per path, the batcher's pad rows (length 0) left out
    (``engine.p3_reads_warp``, ``engine.p3_reads_block``,
    ``engine.p3_reads_scratch``), the global scratch's bytes
    (``engine.p3_scratch_bytes``, an int64 key and an f32 total a sort
    slot), the real light postings P3 gathers (``engine.p3_postings``)
    and the row slots it is handed (``engine.p3_row_slots``, ``lrows``
    int32[B, W]); in traced runs only, since ``paths`` reads the plan's
    tensors back on the host."""
    if not tracing_on():
        return
    for path, n in plan.paths(lengths.shape[0], lengths > 0).items():
        count(f"engine.p3_reads_{path}", n)
    count("engine.p3_scratch_bytes", plan.n_scratch * 12)
    count("engine.p3_postings", plan.postings)
    count("engine.p3_row_slots", lrows.size)


def _on_host(n: torch.Tensor) -> torch.Tensor:
    """A 0-d count on the card copied to pinned host memory without a
    wait (a count on the CPU as it is)."""
    if n.device.type != "cuda":
        return n
    host = torch.empty((), dtype=n.dtype, pin_memory=True)
    return host.copy_(n, non_blocking=True)


def light_row_tally(lrows: torch.Tensor, nl: int, counts: np.ndarray,
                    on: dict) -> tuple:
    """The tally (:class:`PendingBatch`) of counters
    ``engine.p3_light_rows`` and ``engine.p3_row_postings``: the distinct
    light rows of P3's staged ``lrows`` (``nl`` the miss row) and their
    real postings (``counts`` int32[nl + 1] a row, copied to ``lrows``'s
    device at the first call and kept in ``on`` by device), counted on
    the device (a traced run's: on the host it took 14-32 ms a 1,024-read
    batch of full-length reads)."""
    if lrows.device not in on:
        on[lrows.device] = torch.from_numpy(counts).to(lrows.device)
    counts = on[lrows.device]
    seen = torch.zeros(nl + 1, dtype=torch.bool, device=lrows.device)
    seen[lrows.reshape(-1).long()] = True
    seen[nl] = False
    return (("engine.p3_light_rows", _on_host(seen.sum()), 1),
            ("engine.p3_row_postings", _on_host((counts * seen).sum()), 1))


def light_width(lens: np.ndarray, n_edges: int) -> tuple[int, int]:
    """The postings layout's light width for keys of ``lens`` postings on
    ``n_edges`` slots, and its device bytes there: the W that minimises
    ``(nl(W) + 1) * 4w(W) + (nh(W) + 1) * 4E``, where the ``nl(W)`` keys of
    at most W postings are light rows of ``w(W)`` words (W edge ids and W
    deltas, :class:`~rappas_tpu_torch.db.LightLayout`: ``ceil(W / 2) + W``
    below 65535 slots, ``2W`` at or above) and the other ``nh(W)`` dense
    f32 rows, each table with its miss row.  Between two key lengths the
    bytes only grow with W, so W is 0 or a key length; a tie takes the
    smaller."""
    counts = np.bincount(lens, minlength=1)
    widths = np.flatnonzero(np.r_[1, counts[1:]])
    nl = np.cumsum(counts)[widths]
    words = np.array([LightLayout.of(w, n_edges).words for w in widths])
    nbytes = (nl + 1) * 4 * words + (len(lens) - nl + 1) * 4 * n_edges
    best = int(np.argmin(nbytes))
    return int(widths[best]), int(nbytes[best])


def alt_rows_of(rof: np.ndarray, nl: int, nh: int):
    """Encoded rows of ambiguity alternatives -> (light rows, heavy rows):
    ``nl`` / ``nh`` where the alternative is not in that table."""
    return (np.minimum(rof, nl).astype(np.int32),
            np.where(rof > nl, rof - (nl + 1), nh).astype(np.int32))


class PlacementEngine:
    # The layout policy.  Every value below was measured, or checked, on
    # an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
    # ``scripts/layout_sweep.py``; "row X" names the DB's row of PERF.md's
    # table "Table layouts" (section 5).
    #: the card the budgets were set on:
    #: ``torch.cuda.get_device_properties(0).total_memory``.  A byte
    #: budget below is a share of it: on another card it scales with that
    #: card's memory (:meth:`card_bytes`); on the CPU it stands as set,
    #: so the CPU engine makes the card's choices
    CARD_MEMORY_BYTES = 85_017_493_504
    #: one table's budget: half the card.  The largest tables placed in
    #: the sweep (a 32.2 GB u16 compact table, row config 5; 20.1 GB
    #: direct, rows config 6 and sparse12) ran at their layout's engine
    #: rate; the other half is left to the batches' buffers and a second
    #: engine
    DIRECT_BYTE_LIMIT = CARD_MEMORY_BYTES // 2
    #: byte budget for the postings layout's host k-mer -> row index
    #: (int32[S^k + 1]); above it the host searches the sorted keys
    DIRECT_INDEX_LIMIT = 1 << 30
    #: resolve_table's compact line: past this many bytes a compact
    #: table's host build and upload cost a 200k-read CLI run more than
    #: postings' slower placement (compact ahead by 1.83 s at 2.41 GB,
    #: row config 6; postings by 0.28 s at 8.04 GB, row k12_E1000; the
    #: line where they cross).  Below it ``table="auto"`` takes compact,
    #: which outran direct on every DB swept (direct tied it only with
    #: every k-mer present at k=8, row k8_occ1.0), so auto never takes
    #: direct
    AUTO_COMPACT_BYTES = 7_300_000_000
    #: past the compact line an f32 DB takes postings at its own light
    #: width (:func:`light_width`) when that layout costs at most this
    #: share of the compact table's bytes.  A quarter keeps compact for
    #: the method's own dense builds (PERF.md §4: 44.5 postings a key on
    #: 119 slots, 227.4 on 299, where postings saves under 1.5x) and
    #: takes postings for the 4,000-taxon k=10 DB (45 a key on 8,000
    #: slots: 0.29 GB against 33.55 GB).  The share weighs the tables
    #: alone: P3's per-batch scratch, 12 B a posting of the reads past
    #: ``kernels.SMEM_PAIRS`` postings, also grows with the width (0.80
    #: GB for 1,024 reads of 1,450 bp at width 45) and is not counted
    AUTO_POSTINGS_SHARE = 0.25
    #: the light table's part size: a light table that fits one table's
    #: budget stays one table; one table outran the light table routed in
    #: two parts on every DB swept (row config 5: 71,606 against 47,196
    #: engine reads/s, CLI 30,145 against 24,293)
    LIGHT_PART_BYTES = DIRECT_BYTE_LIMIT
    #: the two-stage path's caps on a batch's unique light rows and on
    #: their compact table's bytes (the light rows' words: 16 at width 8
    #: with int32 edge ids, 12 with u16 ones): config 5's 8,192-read
    #: batches hold 352,879-359,369 unique rows (23 MB at 16 words), so
    #: both admit batches up to twice that; past them a batch takes the
    #: select fallback (63,815 engine reads/s on row config 5, ahead of
    #: the two-stage path's 53,972)
    TWO_STAGE_MAX_UNIQUE = 1 << 20
    TWO_STAGE_MAX_BYTES = 64 << 20
    #: the batch size down to which a batch whose unique rows pass the
    #: two-stage caps is halved before the select fallback: never (row
    #: config 5: the select fallback on whole 8,192-read batches ran at
    #: 0.86x the one table; halved down to 1,024 reads, in
    #: ``chip_smoke.py``'s select phase, at 0.21x)
    MIN_SPLIT_B = 1 << 62
    #: the direct table's split: past ``DIRECT_SPLIT_MIN`` bytes (never:
    #: on row config 2 the split engine ran 78,334 engine reads/s against
    #: the whole table's 514,228, and its CLI 34,697 reads/s against
    #: 74,640) into parts of ``DIRECT_PART_BYTES`` (one table's budget)
    DIRECT_SPLIT_MIN = 1 << 62
    DIRECT_PART_BYTES = DIRECT_BYTE_LIMIT
    #: the most parts of a light or direct table: the kernels' part table
    #: (``csrc/parts.cuh`` ``kMaxParts``); past it a light table stays one
    #: slow part and a direct table stays whole
    MAX_LIGHT_PARTS = 64
    MAX_DIRECT_PARTS = 64
    #: tables are height-split, routed and pipelined only on the
    #: one-device engine (JAX: ``type(self) is PlacementEngine``); the
    #: sharded engine sets it False
    SINGLE_DEVICE = True

    def __init__(self, db: PhyloKmerDB, keep_at_most: int = 7,
                 treat_ambiguities: bool = True,
                 ambiguities_with_max: bool = False,
                 device="cuda", precision: str = "f32",
                 table: str = "auto", postings_width: int = 8):
        with span("engine.init"):
            self.device = torch.device(device)
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"device must be cuda or cpu, got {device!r}")
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "PlacementEngine(device='cuda') needs a CUDA device and "
                    "none is available; pass device='cpu' to run the plain "
                    "PyTorch versions on the CPU")
            if precision not in ("f32", "u16"):
                raise ValueError(f"precision must be f32 or u16, got "
                                 f"{precision!r}")
            table, postings_width = self.resolve_layout(
                db, table, precision, self.table_budget(self.device),
                postings_width)
            if table not in ("direct", "compact", "postings"):
                raise ValueError(f"table must be auto/direct/compact/"
                                 f"postings, got {table!r}")
            if table == "postings" and precision == "u16":
                raise ValueError(
                    "postings table mode is f32-only (the sort payload "
                    "carries exact deltas); use precision='f32'")
            self._init_params(db, keep_at_most, treat_ambiguities,
                              ambiguities_with_max, precision, table)
            with span("engine.table"):
                held = self._init_tables(db, table, precision,
                                         postings_width)
                if self.device.type == "cuda":
                    # the span's time is the build's on the device
                    torch.cuda.synchronize(self.device)
            count("engine.table_bytes",
                  sum(t.numel() * t.element_size() for t in held))
            if table == "postings":
                count("engine.postings_width", postings_width)
                count("engine.edge_id_bytes", self.light_layout.edge_bytes)
            self._init_host_codec()
            self._stream = self._gather_stream = None
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
                # G1 of the software pipeline's next batch runs on its own
                # stream, beside P3 of this batch on the engine's
                self._gather_stream = torch.cuda.Stream(self.device)
                # the table upload ran on the current stream
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))

    def _init_tables(self, db: PhyloKmerDB, table: str, precision: str,
                     postings_width: int) -> tuple:
        """The layout's tables on the device, and what the engine keeps
        of their host lookups; returns the device tables."""
        split = None
        if table == "direct" and self.SINGLE_DEVICE:
            split = direct_split_tables(
                db, self.device, precision,
                self.card_bytes(self.DIRECT_PART_BYTES, self.device),
                self.DIRECT_SPLIT_MIN, self.MAX_DIRECT_PARTS)
        if split is not None:
            # a split direct table lives only as its parts
            parts, cuts, scale = split
            self.direct_parts = tuple(parts)
            self._direct_cuts = cuts
            self._direct = kernels.make_parts(parts, np.diff(cuts))
            self.D, self.keys_dev = None, None
            self.scale = float(scale)
            self.n_rows = int(cuts[-1]) + 1
            return self.direct_parts
        if table != "postings":
            tabs = device_tables(db, self.device, table, precision)
            self.D, self.keys_dev = tabs.D, tabs.keys
            self.scale = float(tabs.scale)
            self.n_rows = self.D.shape[0]
            return (self.D,)
        ps = postings_device_tables(
            db, postings_width, self.device, self.DIRECT_INDEX_LIMIT,
            self.card_bytes(self.LIGHT_PART_BYTES, self.device)
            if self.SINGLE_DEVICE else None,
            self.MAX_LIGHT_PARTS)
        self.light_parts, self.heavy_dense = ps.light_parts, \
            ps.heavy_dense
        self.postings_width = postings_width
        self.light_layout = ps.layout
        self._light_slow = ps.light_slow
        #: the light table when it is one part
        self.pairs = self.light_parts[0] \
            if len(self.light_parts) == 1 else None
        self._light = kernels.make_parts(
            self.light_parts, [p.shape[0] for p in self.light_parts])
        self._light_counts = ps.light_counts
        self._light_counts_on = {}      # by device, for traced runs
        self._light_keys_np = ps.light_keys
        self._heavy_keys_np = ps.heavy_keys
        self._rof_np = ps.rof
        self._nl = ps.light_keys.shape[0]
        # split light tables route windows to their parts by default
        # (rappas_tpu/place/engine.py:1143-1152); enable_routed_windows
        # (False) restores the two-stage path
        self._routed_windows = (self.SINGLE_DEVICE and
                                len(self.light_parts) > 1)
        return self.light_parts + (self.heavy_dense,)

    def _init_params(self, db: PhyloKmerDB, keep_at_most: int,
                     treat_ambiguities: bool, ambiguities_with_max: bool,
                     precision: str, table: str) -> None:
        self.db = db
        self.k = db.k
        self.alphabet = db.alphabet
        self.keep_at_most = keep_at_most
        self.treat_ambiguities = treat_ambiguities
        self.ambiguities_with_max = ambiguities_with_max
        self.precision = precision
        self.table = table
        self.n_edges = db.n_edge_slots
        #: the wire's K and whether it carries int32 edge ids
        self.wire_k, self.wide, _ = kernels.wire_format(self.n_edges,
                                                        keep_at_most)
        self.thr = float(np.float32(db.thr_log10))
        #: the height-split direct table (None: whole), and the light
        #: table's parts, width and row layout (set by the postings layout)
        self.direct_parts = None
        self.light_parts = ()
        self.postings_width = None
        self.light_layout = None
        #: part-routed windows on a split light table; the software
        #: pipeline of the two-stage path, its tail and the lock that
        #: serialises the tail's hand-off between the issuing thread and a
        #: result's flush (rappas_tpu/place/engine.py:1205-1216)
        self._routed_windows = False
        self._pp_enabled = False
        self._pp_tail = None
        self._pp_lock = threading.Lock()

    # -------------------------------------------------------------- #
    @classmethod
    def card_bytes(cls, nbytes: int, device) -> int:
        """A byte budget set for the H100 80GB (``nbytes``) on
        ``device``: scaled by its card's memory over
        ``CARD_MEMORY_BYTES`` on CUDA, as it stands on the CPU."""
        device = torch.device(device)
        if device.type != "cuda":
            return nbytes
        total = torch.cuda.get_device_properties(device).total_memory
        return nbytes * total // cls.CARD_MEMORY_BYTES

    @classmethod
    def table_budget(cls, device) -> int:
        """The bytes one table may take on ``device``
        (``DIRECT_BYTE_LIMIT``, :meth:`card_bytes`)."""
        return cls.card_bytes(cls.DIRECT_BYTE_LIMIT, device)

    @classmethod
    def resolve_table(cls, db: PhyloKmerDB, table: str, precision: str,
                      direct_byte_limit: int,
                      postings_width: int = 8) -> str:
        """The layout of :meth:`resolve_layout`."""
        return cls.resolve_layout(db, table, precision, direct_byte_limit,
                                  postings_width)[0]

    @classmethod
    def resolve_layout(cls, db: PhyloKmerDB, table: str, precision: str,
                       direct_byte_limit: int,
                       postings_width: int = 8) -> tuple[str, int]:
        """'auto' -> the concrete device layout for this DB (the analog of
        the reference's direct-vs-hashed capacity choice,
        ``CustomHash_v4_FastUtil81.java:49-63``), among the layouts whose
        table fits ``direct_byte_limit`` bytes, and the postings layout's
        light width.  Below the compact line, the layout that placed such
        a DB fastest on the H100 (CLI reads/s over 200k reads, set-up
        included; PERF.md "Table layouts"); past it, the smaller:

        * **compact** while its keys fit int32 (the card searches them)
          and its table fits ``AUTO_COMPACT_BYTES``;
        * else f32: **postings** at ``postings_width`` for a
          light-dominated DB (most postings in k-mers with at most
          ``postings_width`` entries); **postings** at the DB's own
          light width (:func:`light_width`) when that layout takes at
          most ``AUTO_POSTINGS_SHARE`` of the compact table's bytes, or
          when the compact table does not fit; **compact** otherwise;
        * else u16 (never postings): **compact** while it fits; a DB too
          large for it raises.

        Direct, never faster than compact on the card, is taken only when
        asked for, and an asked-for layout keeps ``postings_width``.
        """
        if table != "auto":
            return table, postings_width
        itemsize = 2 if precision == "u16" else 4
        compact_bytes = (db.n_kmers + 1) * db.n_edge_slots * itemsize
        if (db.alphabet.n_states ** db.k <= 2 ** 31 - 1 and
                compact_bytes <= min(direct_byte_limit,
                                     cls.AUTO_COMPACT_BYTES)):
            return "compact", postings_width
        if precision == "u16":
            if compact_bytes <= direct_byte_limit:
                return "compact", postings_width
            raise ValueError(
                f"DB too large for a u16 table: the compact table takes "
                f"{compact_bytes} bytes, past the card's budget of "
                f"{direct_byte_limit}; use precision='f32' (postings "
                f"layout)")
        lens = np.diff(db.offsets)
        heavy_nnz = int(lens[lens > postings_width].sum()) \
            if lens.size else 0
        if heavy_nnz * 2 <= max(int(db.nnz), 1):
            return "postings", postings_width
        width, nbytes = light_width(lens, db.n_edge_slots)
        if (nbytes <= cls.AUTO_POSTINGS_SHARE * compact_bytes or
                compact_bytes > direct_byte_limit):
            return "postings", width
        return "compact", postings_width

    def _init_host_codec(self) -> None:
        # max ambiguities per k-mer: floor(k^(1/S))
        # (AmbigSequenceKnife.java:95)
        self.max_ambig = int(np.floor(
            self.k ** (1.0 / self.alphabet.n_states)))
        # host code table: ASCII -> state code / AMBIG / invalid
        a = self.alphabet
        tab = np.full(256, PAD_CODE, np.int8)
        valid = a.char_to_code != 255
        tab[valid] = a.char_to_code[valid].astype(np.int8)
        tab[a.is_ambiguous_table] = AMBIG_CODE
        self._code_tab = tab
        # per-ambiguity-char alternative lists (state codes)
        self._amb_alts = {ord(c): a.ambiguity_codes(c)
                          for c in a.ambiguities}
        for c in list(a.ambiguities):
            self._amb_alts[ord(c.lower())] = a.ambiguity_codes(c)
        # flat tables for the vectorized single-ambiguity expansion:
        # alt_tab[ascii, j] = j-th alternative state, alt_len[ascii] = W
        max_alt = max(len(v) for v in self._amb_alts.values())
        self._alt_tab = np.zeros((256, max_alt), np.int64)
        self._alt_len = np.zeros(256, np.int64)
        for o, alts in self._amb_alts.items():
            self._alt_len[o] = len(alts)
            self._alt_tab[o, :len(alts)] = np.asarray(alts)

    # -------------------------------------------------------------- #
    def encode_batch(self, matrix: np.ndarray) -> np.ndarray:
        """ASCII uint8 [B, L] (0xFF padded) -> int8 codes."""
        return self._code_tab[matrix]

    # -------------------------------------------------------------- #
    def score(self, matrix: np.ndarray, lengths: np.ndarray) -> BatchResult:
        return self.score_async(matrix, lengths).result()

    def score_async(self, matrix: np.ndarray,
                    lengths: np.ndarray) -> PendingBatch:
        """Dispatch scoring of ASCII reads ``uint8[B, L]`` (0xFF padded)
        without waiting for the device; call ``.result()`` on the
        returned handle.  Batches issued back to back queue on the
        engine's stream, so the host can prepare the next batch while
        the device scores this one."""
        count("engine.batches")
        with span("engine.score_async"):
            B, L = matrix.shape
            if L < self.k:
                # no window fits: every read is unplaced
                K = self.wire_k
                return PendingBatch(BatchResult(
                    np.full((B, K), -1, np.int32),
                    np.full((B, K), -np.inf, np.float32),
                    np.zeros((B, K), np.float32),
                    np.zeros(B, np.int32)))
            lengths = np.ascontiguousarray(lengths, np.int32)
            with span("engine.encode"):
                codes = self.encode_batch(matrix)
            if self.table == "postings":
                return self._score_postings(codes, matrix, lengths)
            if self.direct_parts is not None:
                return self._score_direct_split(codes, matrix, lengths)
            with span("engine.inputs"):
                host = self.dense_inputs(codes, matrix, lengths)
            with self._on_stream():
                dev = stage(host, self.device)
                # a traced run counts the rows C1 reads
                rows = (torch.empty((B, L - self.k + 1), dtype=torch.int32,
                                    device=self.device)
                        if tracing_on() and "codes" in dev and
                        self.table == "compact" else None)
                with span("engine.launch"):
                    acc = self.dense_acc(dev, self.D, self.keys_dev, B, L,
                                         rows)
                    wire = kernels.finalize_wire(
                        acc, dev["lengths"], self.thr, self.k,
                        self.keep_at_most)
                tally = None if rows is None else self._row_tally(rows)
                pending = fetch_wire(wire, self._stream, self.wire_k,
                                     self.wide)
                pending.tally = tally
                return pending

    def _row_tally(self, rows: torch.Tensor) -> tuple:
        """The tally (:class:`PendingBatch`) of counter
        ``engine.c1_row_bytes``: the distinct table rows that C1's
        windows read (the miss row left out), counted on the device, times
        a row's bytes."""
        n = self.D.shape[0] - 1
        seen = torch.zeros(n + 1, dtype=torch.bool, device=rows.device)
        seen[rows.reshape(-1).long()] = True
        return (("engine.c1_row_bytes", _on_host(seen[:n].sum()),
                 self.D.shape[1] * self.D.element_size()),)

    def dense_inputs(self, codes: np.ndarray, matrix: np.ndarray,
                     lengths: np.ndarray) -> dict:
        """The host arrays of one direct or compact batch: ``lengths``;
        the direct table's per-read split (:meth:`_split_direct`), the
        compact table's ``codes`` (keys on the card) or host-searched
        ``rows``; with ambiguity windows their alternatives' rows and
        ``win_off``, ``win_read``, ``win_inv_w``, ``win_is_mean``."""
        host = {"lengths": lengths}
        if self.table == "direct":
            self._split_direct(codes, lengths, host)
        elif self.keys_dev is not None:
            # compact, int32 index space: every read goes as codes to C1,
            # which searches the keys on the card
            host["codes"] = codes
        else:
            # compact, index space above 31 bits: the host searches the
            # keys (engine.py:1370-1373) and C2 sums the rows
            host["rows"] = self._db_lookup(host_kmer_indices(
                codes, lengths, self.k, self.alphabet.n_states))
        self._ambiguity_inputs(codes, matrix, lengths, host)
        return host

    def _ambiguity_inputs(self, codes: np.ndarray, matrix: np.ndarray,
                          lengths: np.ndarray, host: dict) -> None:
        """A direct or compact batch's ambiguity windows into ``host``:
        their alternatives' rows (the k-mer index on the direct table, the
        host key search on the compact one), ``win_off``, ``win_read``,
        ``win_inv_w``, ``win_is_mean``; nothing without windows."""
        amb = (self._expand_ambiguities_host(codes, matrix, lengths)
               if self.treat_ambiguities else None)
        if amb is None:
            return
        kidx, alt_win, win_read, win_inv_w, is_mean = amb
        host["alt_rows"] = (kidx.astype(np.int32) if self.table == "direct"
                            else self._db_lookup(kidx))
        host["win_off"] = window_offsets(alt_win, win_read.shape[0])
        host["win_read"] = win_read.astype(np.int32)
        host["win_inv_w"] = win_inv_w.astype(np.float32)
        host["win_is_mean"] = is_mean.astype(np.uint8)

    # -------------------------------------------------------------- #
    # the height-split direct table (rappas_tpu/place/engine.py:1675-1757):
    # the host computes the k-mer indices and routes each read's windows to
    # their parts; D1 sums them part by part, A1 scores the ambiguity
    # windows, K3 finishes.  The 2-bit packed path does not apply.
    def _score_direct_split(self, codes: np.ndarray, matrix: np.ndarray,
                            lengths: np.ndarray) -> PendingBatch:
        with span("engine.inputs"):
            kidx = host_kmer_indices(codes, lengths, self.k,
                                     self.alphabet.n_states)
            rows = np.where(kidx >= 0, kidx,
                            kidx.dtype.type(self.n_rows - 1))
            host = {"lengths": lengths, "routed": self._route_direct(rows)}
            self._ambiguity_inputs(codes, matrix, lengths, host)
        with self._on_stream():
            dev = stage(host, self.device)
            with span("engine.launch"):
                acc = kernels.routed_accumulate_(
                    self._direct, dev["routed"], self.scale)
                if "win_off" in dev:
                    kernels.ambiguous_pass_split_(
                        acc, self._direct, self.scale, dev["alt_rows"],
                        dev["win_off"], dev["win_read"], dev["win_inv_w"],
                        dev["win_is_mean"])
                wire = kernels.finalize_wire(acc, dev["lengths"], self.thr,
                                             self.k, self.keep_at_most)
            return fetch_wire(wire, self._stream, self.wire_k, self.wide)

    def _route_direct(self, rows: np.ndarray) -> np.ndarray:
        """Split direct table: each read's rows routed to their parts
        (pads = the part's height, its zero row); the global miss row lies
        past the last cut and drops out
        (``rappas_tpu/place/engine.py:1736-1739``)."""
        return route_rows(rows, self._direct_cuts)

    def dense_acc(self, dev: dict, D: torch.Tensor, keys, B: int,
                  L: int, rows: torch.Tensor | None = None) -> torch.Tensor:
        """The [B, E] sums of one batch's staged :meth:`dense_inputs` over
        the table ``D`` (the whole table, or one column shard of it) and
        its int32 ``keys`` (compact with the keys on the card, else None):
        K1/K2, C1 (which writes the windows' rows into ``rows`` when it is
        given) or C2, then K4 for the ambiguity windows."""
        S = self.alphabet.n_states
        if self.table == "compact":
            acc = (kernels.accumulate_compact(
                D, keys, dev["codes"], self.k, S, self.scale, rows)
                if "codes" in dev else
                kernels.accumulate_rows(D, dev["rows"], self.scale))
        else:
            acc = torch.empty((B, D.shape[1]), dtype=torch.float32,
                              device=D.device)
        if self.table == "direct" and "packed" in dev:
            kernels.accumulate_packed(
                D, dev["packed"], dev.get("packed_lengths", dev["lengths"]),
                L, self.k, self.scale, acc=acc, dest=dev.get("packed_dest"))
        if self.table == "direct" and "codes" in dev:
            kernels.accumulate_codes(
                D, dev["codes"], self.k, S, self.scale, acc=acc,
                dest=dev.get("codes_dest"))
        if "win_off" in dev:
            kernels.ambiguous_pass_(
                acc, D, self.scale, dev["alt_rows"], dev["win_off"],
                dev["win_read"], dev["win_inv_w"], dev["win_is_mean"])
        return acc

    def _split_direct(self, codes: np.ndarray, lengths: np.ndarray,
                      host: dict) -> None:
        """The direct table's per-read split into ``host``: reads clean
        inside their length go 2-bit packed to K1 (``packed``, with
        ``packed_lengths``/``packed_dest`` when some reads are coded), the
        others as int8 codes to K2 (``codes``, ``codes_dest``).  2-bit
        packing would fabricate k-mers from negative codes (they pack as
        0 == 'A'), and a non-DNA alphabet sends every read coded."""
        B, L = codes.shape
        if self.alphabet.n_states == 4:
            coded = ((codes < 0) &
                     (np.arange(L)[None, :] < lengths[:, None])).any(axis=1)
        else:
            coded = np.ones(B, bool)
        n_coded = int(coded.sum())
        if n_coded < B:
            if n_coded:
                sel = np.flatnonzero(~coded)
                host["packed"] = pack_reads(codes[sel])
                host["packed_lengths"] = lengths[sel]
                host["packed_dest"] = sel.astype(np.int32)
            else:
                host["packed"] = pack_reads(codes)
        if n_coded:
            if n_coded < B:
                sel = np.flatnonzero(coded)
                host["codes"] = codes[sel]
                host["codes_dest"] = sel.astype(np.int32)
            else:
                host["codes"] = codes

    @functools.cached_property
    def _db_lookup(self):
        """The compact table's host key search ``kidx -> rows`` (miss and
        -1 -> ``n_kmers``), bucket-indexed for big key sets
        (``rappas_tpu/place/engine.py:2021-2023``)."""
        return make_key_lookup(self.db.keys)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())


    # -------------------------------------------------------------- #
    def _expand_ambiguities_host(self, codes: np.ndarray,
                                 matrix: np.ndarray, lengths: np.ndarray):
        """Expand IUPAC windows into alternative k-mer rows (host side).

        Alternative generation reproduces the reference's cycling scheme
        (``AmbigSequenceKnife.java:240-258``): for W = prod(|alts_p|)
        alternatives, ambiguous position p takes ``alts_p[j mod |alts_p|]``
        in alternative j.

        Fully vectorized for single-ambiguity windows -- the ONLY kind
        reachable at practical k, since ``max_ambig = floor(k^(1/S))``
        (``AmbigSequenceKnife.java:95``) is 1 for every DNA k <= 15 and
        every amino k: sliding-window counts via cumsum, one fancy-index
        gather of the window codes, and a repeat/cumsum flattening of
        the variable per-window alternative counts.  Multi-ambiguity
        windows (DNA k >= 16 only) take a small per-window loop
        reproducing the reference's diagonal enumeration including its
        duplicates.
        """
        k, S = self.k, self.alphabet.n_states
        amb_mask = codes == AMBIG_CODE
        if not amb_mask.any() or self.max_ambig < 1:
            return None
        B, L = codes.shape
        Q = L - k + 1
        if Q <= 0:
            return None
        weights = S ** np.arange(k - 1, -1, -1, dtype=np.int64)

        def touched_windows(mask):
            """(rows, window-ids) of every window containing a set
            position of ``mask`` -- sparse sliding-window expansion
            (ambiguities are rare; a dense [B, L] cumsum costs ~20 ms
            per 16k-read batch, this is sub-ms at realistic N rates)."""
            mb, mp = np.nonzero(mask)
            lo = np.maximum(mp - (k - 1), 0)
            hi = np.minimum(mp, Q - 1)
            n = hi - lo + 1
            tot = int(n.sum())
            rb = np.repeat(mb, n)
            rq = np.repeat(lo, n) + (np.arange(tot) -
                                     np.repeat(np.cumsum(n) - n, n))
            return rb, rq

        # per-window ambiguity counts, sparsely: sort/collapse the
        # touched (read, window) keys -- never materialises a [B, Q]
        # counts array (the nonzero/add.at over it cost ~10 ms/batch)
        rb, rq = touched_windows(amb_mask)
        key = rb.astype(np.int64) * Q + rq
        uniq_key, counts = np.unique(key, return_counts=True)
        wb = (uniq_key // Q).astype(np.int64)
        wq = (uniq_key % Q).astype(np.int64)
        valid = (counts <= self.max_ambig) & \
            (wq <= lengths[wb].astype(np.int64) - k)
        in_read = np.arange(L)[None, :] < lengths[:, None]
        pad_mask = (codes == PAD_CODE) & in_read   # mid-read junk only
        if pad_mask.any():
            pb, pq = touched_windows(pad_mask)
            valid &= ~np.isin(uniq_key, pb.astype(np.int64) * Q + pq)

        is_mean = not self.ambiguities_with_max
        kidx_parts, alt_win_parts = [], []
        win_read_parts, win_inv_w_parts = [], []
        n_win = 0

        single = valid & (counts == 1)
        sb, sq = wb[single], wq[single]
        if sb.size:
            win = codes[sb[:, None],
                        sq[:, None] + np.arange(k)[None, :]]
            win = win.astype(np.int64)            # [nw, k]
            p = np.argmax(win < 0, axis=1)        # the ambiguous slot
            chars = matrix[sb, sq + p]
            # base index with 0 at the ambiguous slot (Horner; an int64
            # matmul over materialised variants has no BLAS path and
            # costs ~10x this), variant j adds alt_j * S^(k-1-p)
            base = np.zeros(sb.size, np.int64)
            for i in range(k):
                base = base * S + np.maximum(win[:, i], 0)
            Wn = self._alt_len[chars]             # [nw]
            tot = int(Wn.sum())
            awin = np.repeat(np.arange(sb.size), Wn)
            j = np.arange(tot) - np.repeat(np.cumsum(Wn) - Wn, Wn)
            alt_codes = self._alt_tab[chars[awin], j]
            kidx_parts.append(base[awin] + alt_codes * weights[p[awin]])
            alt_win_parts.append(awin.astype(np.int32))
            win_read_parts.append(sb.astype(np.int32))
            win_inv_w_parts.append((1.0 / Wn).astype(np.float32))
            n_win = sb.size

        multi = valid & (counts > 1)
        if multi.any():                           # DNA k >= 16 only
            for b, q in zip(wb[multi], wq[multi]):
                window = codes[b, q:q + k].astype(np.int64)
                amb_pos = np.flatnonzero(window < 0)
                alts = [self._amb_alts[int(matrix[b, q + p])]
                        for p in amb_pos]
                W = int(np.prod([len(x) for x in alts]))
                variants = np.repeat(window[None, :], W, axis=0)
                for p, al in zip(amb_pos, alts):
                    variants[:, p] = np.asarray(al)[
                        np.arange(W) % len(al)]
                kidx_parts.append(variants @ weights)
                alt_win_parts.append(np.full(W, n_win, np.int32))
                win_read_parts.append(np.int32(b)[None])
                win_inv_w_parts.append(np.float32(1.0 / W)[None])
                n_win += 1
        if n_win == 0:
            return None
        return (np.concatenate(kidx_parts),       # raw k-mer indices
                np.concatenate(alt_win_parts),
                np.concatenate(win_read_parts),
                np.concatenate(win_inv_w_parts),
                np.full(n_win, is_mean, bool))

    # -------------------------------------------------------------- #
    # postings layout (large trees, protein): the host maps every window
    # to an encoded row and left-packs the light hits in one sweep, and
    # gathers the dense sources into slots; the device runs P1, P2 and P3
    def _score_postings(self, codes: np.ndarray, matrix: np.ndarray,
                        lengths: np.ndarray):
        with span("engine.inputs"):
            host, plan = self.postings_inputs(codes, matrix, lengths)
            lrows = host["lrows"]       # before the row source rewrites it
            src = self._light_source(host)
        if src is None:
            # too many batch-unique rows for one compact table: halve the
            # batch (rappas_tpu/place/engine.py:1527-1545)
            h = codes.shape[0] // 2
            return SplitPending(
                self._score_postings(codes[:h], matrix[:h], lengths[:h]),
                self._score_postings(codes[h:], matrix[h:], lengths[h:]))
        count_p3(plan, lengths, lrows)
        with self._on_stream():
            dev, acc_c, plan = self._postings_dense(host, plan)
            # a traced run counts the light rows P3 reads from the table
            tally = (light_row_tally(dev["lrows"], self._nl,
                                     self._light_counts,
                                     self._light_counts_on)
                     if tracing_on() and src[0] == "table" else None)
            with span("engine.launch"):
                if src[0] == "compact" and self._pp_enabled:
                    return self._pp_submit(dev, acc_c, plan, src[1])
                wire = self._postings_wire(src, dev, acc_c, plan)
            pending = fetch_wire(wire, self._stream, self.wire_k, self.wide)
            pending.tally = tally
            return pending

    def _postings_dense(self, host: dict, plan):
        """Stage a postings batch and run its dense side on the engine's
        stream: P1, then P2 (A1 on a split light table) for its ambiguity
        windows.  Returns the staged inputs, ``acc_c`` and P3's plan."""
        dev = stage(host, self.device)
        plan = plan.staged(dev)          # P3's plan, staged with the batch
        with span("engine.launch"):
            acc_c = kernels.dense_side(self.heavy_dense, dev["hrows"],
                                       dev["hoff"])
            if "win_off" in dev:
                spec = (dev["alt_lrows"], dev["alt_hrows"], dev["win_off"],
                        dev["win_slot"], dev["win_inv_w"],
                        dev["win_is_mean"])
                if len(self.light_parts) > 1:
                    kernels.ambiguous_postings_parts_(
                        acc_c, self.heavy_dense, self._light, *spec,
                        layout=self.light_layout)
                else:
                    kernels.ambiguous_postings_(acc_c, self.heavy_dense,
                                                self.pairs, *spec,
                                                layout=self.light_layout)
        return dev, acc_c, plan

    def _postings_wire(self, src: tuple, dev: dict, acc_c, plan,
                       compact=None) -> torch.Tensor:
        """P3 of a staged postings batch from the light row source that
        :meth:`_light_source` chose: R1 routed or part-select, P3 on the
        compact table (G1 first unless ``compact`` is given) or on the one
        light table."""
        args = (acc_c, dev["slot_of"], dev["lengths"], self.thr, self.k,
                self.keep_at_most, plan)
        layout = self.light_layout
        kind = src[0]
        if kind == "routed":
            return kernels.finalize_postings_wire_routed(
                self._light, dev["routed"], *args, layout=layout)
        if kind == "parts":
            return kernels.finalize_postings_wire_parts(
                self._light, dev["lrows"], *args, miss=self._nl,
                layout=layout)
        if kind == "compact":
            if compact is None:
                compact = kernels.gather_compact_(self._light, dev["uniq"],
                                                  dev["uniq_off"])
            return kernels.finalize_postings_wire(
                compact, dev["lrows"], *args, miss=src[1], layout=layout)
        return kernels.finalize_postings_wire(self.pairs, dev["lrows"],
                                              *args, layout=layout)

    def _light_source(self, host: dict):
        """Where P3 reads this batch's light rows
        (``rappas_tpu/place/engine.py:1496-1584``), rewriting ``host``:

        * ``("table",)`` -- the one light table at ``lrows``;
        * ``("routed",)`` -- a split table with routed windows: ``lrows``
          becomes ``routed`` int32[n_parts, B, W] (:meth:`_route_windows`);
        * ``("compact", miss)`` -- the two-stage path, on a split table or a
          single one past the part budget whose batch-unique rows pay:
          ``uniq``/``uniq_off`` give each part's unique rows (part-local,
          each run padded to a :func:`_bucket_size`; a single table's pads
          are the miss row), ``lrows`` becomes the inverse map into the
          compact table G1 gathers, and ``miss`` is the light miss row's
          position there (-1: absent);
        * ``("parts",)`` -- a split table whose unique rows overflow the
          compact budget at the smallest batch: the select fallback over
          global ``lrows``;
        * None -- the unique rows overflow and the batch can still be
          halved (:class:`SplitPending`).

        P3's plan was made from the rows before any of these rewrites."""
        parts = self.light_parts
        nparts = len(parts)
        if nparts > 1 and self._routed_windows:
            host["routed"] = self._route_windows(host.pop("lrows"))
            return ("routed",)
        if not (self._light_slow or nparts > 1):
            return ("table",)
        lrows = host["lrows"]
        B = lrows.shape[0]
        uniq, inv = _fast_unique_inverse(lrows.ravel())
        U = uniq.shape[0]
        # the compact [U, w] table must stay within the two-stage caps
        compact_ok = (U <= self.TWO_STAGE_MAX_UNIQUE and
                      U * parts[0].shape[1] * 4 <= self.TWO_STAGE_MAX_BYTES)
        if not compact_ok and nparts > 1 and B >= 2 * self.MIN_SPLIT_B:
            return None
        if not (compact_ok and (nparts > 1 or U * 3 <= lrows.size)):
            return ("parts",) if nparts > 1 else ("table",)
        if nparts > 1:
            # uniq is sorted, so each part's unique rows are one run; each
            # is fetched from its own part only.  Pad slots hold row 0 of
            # the part; the inverse map never points at them.
            offs = np.concatenate([[0], np.cumsum([p.shape[0]
                                                   for p in parts])])
            cuts = np.searchsorted(uniq, offs[1:])
            starts = np.concatenate([[0], cuts[:-1]])
            pads = np.array([_bucket_size(max(int(c - a), 1))
                             for a, c in zip(starts, cuts)], np.int64)
            pad_off = np.concatenate([[0], np.cumsum(pads)])
            uq = np.zeros(int(pad_off[-1]), np.int32)
            for i in range(nparts):
                uq[pad_off[i]:pad_off[i] + cuts[i] - starts[i]] = \
                    uniq[starts[i]:cuts[i]] - offs[i]

            def compact_pos(j):
                part = np.searchsorted(cuts, j, side="right")
                return pad_off[part] + (j - starts[part])
        else:
            pad_off = np.array([0, _bucket_size(U)], np.int64)
            uq = np.full(int(pad_off[-1]), self._nl, np.int32)
            uq[:U] = uniq

            def compact_pos(j):
                return j
        host["uniq"] = uq
        host["uniq_off"] = pad_off.astype(np.int32)
        host["lrows"] = compact_pos(inv).reshape(lrows.shape).astype(
            np.int32)
        # lrows <= nl, so the miss row, when present, is the last unique
        miss = int(compact_pos(U - 1)) if U and uniq[-1] == self._nl else -1
        return ("compact", miss)

    def _route_windows(self, lrows: np.ndarray) -> np.ndarray:
        """Split light table: each read's light rows routed to their parts
        (pads = the part's height); the global miss row ``nl`` drops out
        (``rappas_tpu/place/engine.py:1768-1773``)."""
        cuts = np.concatenate([[0], np.cumsum([p.shape[0]
                                               for p in self.light_parts])])
        return route_rows(lrows, cuts, drop=self._nl)

    def enable_routed_windows(self, on: bool = True) -> None:
        """Toggle part-routed windows on a split light table (on by
        default for the one-device engine); ``False`` restores the
        two-stage path (``rappas_tpu/place/engine.py:1759-1766``)."""
        if on and self.table != "postings":
            raise ValueError("routed windows apply to postings mode")
        self._routed_windows = on

    # ---- the postings software pipeline (two-stage path, one device) -- #
    # rappas_tpu/place/engine.py:1586-1659.  JAX hides batch i+1's unique
    # gather inside batch i's program; here G1 of batch i+1 runs on the
    # gather stream, after its H2D, while P3 of batch i runs on the
    # engine's stream, and P3 of batch i+1 waits for its G1.
    def enable_pipeline(self, on: bool = True) -> None:
        """Opt into the software pipeline of the two-stage gather
        (``rappas_tpu/place/engine.py:1615-1631``): it rides the two-stage
        path, so routed windows go off; turning it off restores them on a
        split table."""
        if on and not (self.table == "postings" and self.SINGLE_DEVICE):
            raise ValueError("pipelining applies to the single-device "
                             "postings engine only")
        self._pp_enabled = on
        self._routed_windows = (not on and self.SINGLE_DEVICE and
                                len(self.light_parts) > 1)

    def _pp_submit(self, dev, acc_c, plan, miss) -> PipelinedBatch:
        """Queue a staged two-stage batch: it becomes the pipeline's tail,
        and the batch before it is issued with this one's G1 beside it."""
        staged = None
        if self._stream is not None:
            staged = torch.cuda.Event()
            staged.record(self._stream)
        entry = {"dev": dev, "acc_c": acc_c, "plan": plan, "miss": miss,
                 "staged": staged, "compact": None, "gathered": None,
                 "out": None}
        with self._pp_lock:
            prev, self._pp_tail = self._pp_tail, entry
            if prev is not None:
                self._pp_issue(prev, entry)
        return PipelinedBatch(self, entry)

    def _pp_issue(self, prev: dict, nxt: dict | None) -> None:
        """Issue ``prev``'s P3 (G1 first on the engine's stream for the
        pipeline's first batch); when ``nxt`` is given, its G1 goes to the
        gather stream before, to run beside ``prev``'s P3."""
        with self._on_stream():
            if prev["compact"] is None:
                prev["compact"] = kernels.gather_compact_(
                    self._light, prev["dev"]["uniq"],
                    prev["dev"]["uniq_off"])
            if nxt is not None:
                self._pp_gather(nxt)
            if prev["gathered"] is not None:
                self._stream.wait_event(prev["gathered"])
            wire = self._postings_wire(("compact", prev["miss"]),
                                       prev["dev"], prev["acc_c"],
                                       prev["plan"], prev["compact"])
            prev["out"] = fetch_wire(wire, self._stream, self.wire_k,
                                     self.wide)
        for key in ("dev", "acc_c", "plan", "compact", "staged", "gathered"):
            prev[key] = None

    def _pp_gather(self, entry: dict) -> None:
        """G1 of a queued batch, on the gather stream after its H2D (on
        the CPU: in place)."""
        uniq, uniq_off = entry["dev"]["uniq"], entry["dev"]["uniq_off"]
        g = self._gather_stream
        if g is None:
            entry["compact"] = kernels.gather_compact_(self._light, uniq,
                                                       uniq_off)
            return
        g.wait_event(entry["staged"])
        with torch.cuda.stream(g):
            entry["compact"] = kernels.gather_compact_(self._light, uniq,
                                                       uniq_off)
            entry["gathered"] = torch.cuda.Event()
            entry["gathered"].record(g)
        # the staged inputs were allocated on the engine's stream and are
        # read on the gather stream; the compact table the other way round
        uniq.record_stream(g)
        entry["compact"].record_stream(self._stream)

    def _pp_flush(self, entry: dict) -> None:
        """Issue the pipeline's tail, unless the next batch already did."""
        with self._pp_lock:
            if entry is not self._pp_tail:
                return
            self._pp_tail = None
            self._pp_issue(entry, None)

    def postings_inputs(self, codes: np.ndarray, matrix: np.ndarray,
                        lengths: np.ndarray):
        """The host arrays of one postings batch and P3's plan
        (``rappas_tpu/place/engine.py:1391-1500``, one light table):

        * ``lengths``, ``slot_of`` int32[B]: the read's dense slot, -1
          for a read with no dense content;
        * ``hrows`` int32[n_h], ``hoff`` int32[n_slots + 1]: heavy hit
          rows, grouped by slot (``np.nonzero`` is row-major, so hits
          come grouped by read, and slots ascend with reads);
        * with ambiguity windows: ``alt_lrows``/``alt_hrows`` int32
          [n_alt] (light row or ``nl``, heavy row or ``nh``),
          ``win_off`` int32[n_win + 1], ``win_slot``, ``win_inv_w``,
          ``win_is_mean``;
        * ``lrows`` int32[B, W]: each read's light hit rows, left-packed
          in window order (``nl`` pads), W the least step of JAX's ladder
          (8 .. 256, below Q - 8) that holds the batch's most hits, else
          Q;
        * P3's plan arrays (``kernels.postings_plan``): ``block_reads``
          int32 when a read's postings pass the warp path's region,
          ``scratch_off`` int64[B + 1] when they pass one block's shared
          memory."""
        rof, packed = self._rows_from_codes(codes, lengths)
        amb = (self._expand_ambiguities_host(codes, matrix, lengths)
               if self.treat_ambiguities else None)
        return postings_batch(
            rof, self._nl, self._light_counts, lengths, amb,
            None if amb is None else self._map_alt_rows(amb[0]), packed)

    def _host_rows(self, kidx: np.ndarray) -> np.ndarray:
        """Encoded row per window: ``r < nl`` light row, ``nl`` miss,
        ``nl + 1 + h`` heavy row ``h`` (invalid windows -> miss)."""
        if self._rof_np is not None:
            space = self.alphabet.n_states ** self.k
            return self._rof_np[np.where(kidx >= 0, kidx, space)]
        # big key space (protein k >= 8): ONE combined bucketed search
        # over all keys with encoded-row values
        keys, vals = self._comb_lookup_arrays
        pos = self._comb_lookup(kidx)                       # miss -> n
        n = keys.shape[0]
        return np.where(pos < n, vals[np.minimum(pos, n - 1)],
                        np.int32(self._nl))

    @functools.cached_property
    def _comb_lookup_arrays(self):
        """(sorted all-keys array, encoded-row values) for the combined
        lookup (light and heavy keys are disjoint by construction)."""
        nl = self._nl
        nh = self._heavy_keys_np.shape[0]
        comb = np.concatenate([self._light_keys_np,
                               self._heavy_keys_np])
        enc = np.concatenate([np.arange(nl, dtype=np.int32),
                              nl + 1 + np.arange(nh, dtype=np.int32)])
        srt = np.argsort(comb, kind="stable")
        return comb[srt], enc[srt]

    @functools.cached_property
    def _comb_lookup(self):
        return make_key_lookup(self._comb_lookup_arrays[0])

    @functools.cached_property
    def _native_probe(self):
        """Fused native rolling-hash + row-lookup callable
        ``(codes, lengths) -> (rof, lrows, hits, pairs, n_heavy)``
        (:func:`rappas_tpu_torch.native.probe_light_rows`, which packs
        each read's light rows in the same sweep): the direct index where
        the engine has one, else the bucketed key probe; or None for a
        small key set without a direct index (the numpy passes give the
        same rows)."""
        if self._rof_np is not None:
            lookup = {"direct": self._rof_np}
        else:
            hki = self._comb_lookup
            if not isinstance(hki, HostKeyIndex):
                return None     # small key set: numpy path is already fast
            keys, vals = self._comb_lookup_arrays
            lookup = {"keys": keys, "vals": vals, "lo": hki.lo,
                      "shift": hki.shift}
        return functools.partial(
            native.probe_light_rows, k=self.k,
            n_states=self.alphabet.n_states, nl=self._nl,
            light_counts=self._light_counts, **lookup)

    def _rows_from_codes(self, codes: np.ndarray, lengths: np.ndarray):
        """Encoded row per window straight from state codes, and the light
        rows packed (:func:`postings_batch`'s ``packed``): the fused native
        sweep, or for a small key set without a direct index the numpy
        passes with ``packed`` None."""
        probe = self._native_probe
        if probe is not None:
            rof, *packed = probe(codes, lengths)
            return rof, tuple(packed)
        return self._host_rows(host_kmer_indices(
            codes, lengths, self.k, self.alphabet.n_states)), None

    def _map_alt_rows(self, kidx: np.ndarray):
        """Raw alternative k-mer indices -> (light rows, heavy rows):
        ``nl`` / ``nh`` where the alternative is not in that table."""
        return alt_rows_of(self._host_rows(kidx), self._nl,
                           self._heavy_keys_np.shape[0])
