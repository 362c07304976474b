"""Placement pipeline: stream query reads -> jplace output.

Host orchestration around
:class:`rappas_tpu_torch.place.engine.PlacementEngine`,
mirroring ``/root/reference/src/main_v2/Main_PLACEMENT_v07.java`` /
``PlacementProcess.processQueries``:

* md5 dedup of identical read sequences BEFORE scoring; duplicates join
  the first occurrence's ``nm`` list (``PlacementProcess.java:591-629``).
  Because scoring is batched here (the reference is strictly serial),
  duplicates that arrive while their first occurrence is still in-flight
  are queued and attached when its batch completes;
* unplaced reads (no k-mer matched the DB) are listed in
  ``logs/notplaced_<query>.tsv`` -- every occurrence, like the reference,
  which re-processes duplicates of unplaced reads (``:797-806``);
* per-query TSV report ``logs/placements_<query>.tsv`` (``:937-962``);
* output file ``<workdir>/placements_<query>.jplace``
  (``Main_PLACEMENT_v07.java:313``); placement objects appear in
  first-occurrence read order even though batches complete out of order.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.place.jplace import JplaceWriter
from rappas_tpu_torch.seqio import IndexBatcher, ingest_blocks
from rappas_tpu_torch.utils import log

#: per-order dedup state codes (see _OrderState)
_IN_FLIGHT, _PLACED, _UNPLACED, _FILTERED = 0, 1, 2, 3


class _PyDedup:
    """Python fallback for :class:`rappas_tpu_torch.native.NativeDedup`
    (identical contract: first occurrence -> -1 and registers the
    order; duplicate -> the registered first order)."""

    def __init__(self):
        self._m: dict[bytes, int] = {}

    def __call__(self, md5s: np.ndarray, orders: np.ndarray) -> np.ndarray:
        blob = np.ascontiguousarray(md5s, np.uint8).tobytes()
        ol = orders.tolist()
        out = np.empty(len(ol), np.int64)
        m = self._m
        for i, o in enumerate(ol):
            v = m.setdefault(blob[16 * i:16 * i + 16], o)
            out[i] = -1 if v == o else v
        return out


def _make_dedup():
    try:
        from rappas_tpu_torch.native import NativeDedup
        return NativeDedup()
    except Exception:
        return _PyDedup()


class _OrderState:
    """Per-arrival-order placement state, array-backed so batch
    completion registers a whole batch with three vectorized stores.

    ``status[o]``: _IN_FLIGHT | _PLACED | _UNPLACED | _FILTERED;
    placed orders also carry ``(bidx, slot)`` -> the
    :class:`BatchPlacements` and in-batch read index a duplicate
    attaches to.  ``pending[o]`` queues full headers of duplicates that
    arrived while order ``o``'s batch was still in flight."""

    def __init__(self):
        n = 1 << 14
        self.status = np.zeros(n, np.int8)
        self.bidx = np.full(n, -1, np.int32)
        self.slot = np.zeros(n, np.int32)
        self.batches: list = []
        self.pending: dict[int, list] = {}

    def ensure(self, n):
        cur = self.status.shape[0]
        if n <= cur:
            return
        new = max(n, cur * 2)
        self.status = np.concatenate(
            [self.status, np.zeros(new - cur, np.int8)])
        self.bidx = np.concatenate(
            [self.bidx, np.full(new - cur, -1, np.int32)])
        self.slot = np.concatenate(
            [self.slot, np.zeros(new - cur, np.int32)])

    def register(self, batch, orders, placed, filtered):
        """Vectorized per-batch state store (orders: int64[n], placed /
        filtered: bool[n]; slots are in-batch read indices 0..n)."""
        bid = len(self.batches)
        self.batches.append(batch)
        self.ensure(int(orders.max()) + 1 if orders.size else 0)
        self.status[orders] = np.select(
            [placed, filtered], [_PLACED, _FILTERED], _UNPLACED)
        self.bidx[orders] = bid
        self.slot[orders] = np.arange(orders.shape[0], dtype=np.int32)

    def batch_of(self, order):
        return self.batches[int(self.bidx[order])], int(self.slot[order])


@dataclasses.dataclass
class PlacementConfig:
    keep_at_most: int = 7          # ArgumentsParser_v2.java:88
    keep_factor: float = 0.01      # :89
    guppy_compatible: bool = False
    treat_ambiguities: bool = True  # :90 (--noamb disables)
    ambiguities_with_max: bool = False  # --ambwithmax
    ns_bound: float = float("-inf")
    batch_size: int = 1024
    write_tsv: bool = True
    invocation: str = "rappas-tpu"
    precision: str = "f32"
    table: str = "auto"
    #: torch device of the engine that place_queries makes when none is
    #: passed in ("cuda" raises where CUDA is absent)
    device: str = "cuda"
    #: (host_id, num_hosts) -- this process places only its round-robin
    #: shard of the reads and writes ``placements_<q>.jplace.part<id>``
    #: (multi-host mode; the port CLI does not reach it yet, ROADMAP
    #: queue 1 item 8)
    read_shard: tuple | None = None


def _first_tokens(pb, idx):
    """Sub-headers (header up to the first space,
    ``PlacementProcess.java:598-612``) of block records ``idx`` as a
    byte blob + offsets -- fully vectorized for native blocks."""
    from rappas_tpu_torch.native import gather_ranges
    blob, off = _headers_blob([(pb, np.asarray(idx, np.int64))])
    sp = np.flatnonzero(blob == 0x20)
    if sp.size:
        k = np.searchsorted(sp, off[:-1])
        cand = np.where(k < sp.size, sp[np.minimum(k, sp.size - 1)],
                        np.iinfo(np.int64).max)
        ends = np.minimum(cand, off[1:])
    else:
        ends = off[1:]
    return gather_ranges(blob, off[:-1], ends)


def _headers_blob(refs):
    """Concatenated utf-8 header bytes + int64 offsets for one batch's
    reads (``refs`` = list of (block, index-array) chunks in batch row
    order).  Native blocks take the vectorized range gather; PyBlock
    (FASTQ/gz/no-toolchain) encodes its python strings."""
    from rappas_tpu_torch.native import gather_ranges
    blobs = []
    offs = [np.zeros(1, np.int64)]
    base = 0
    for pb, idx in refs:
        if hasattr(pb, "hdr_buf"):
            b, o = gather_ranges(pb.hdr_buf, pb.hdr_off[idx],
                                 pb.hdr_off[idx + 1])
        else:
            hs = [pb.header(int(i)).encode("utf-8") for i in idx]
            b = np.frombuffer(b"".join(hs), np.uint8)
            o = np.zeros(len(hs) + 1, np.int64)
            np.cumsum(np.fromiter(map(len, hs), np.int64, len(hs)),
                      out=o[1:])
        blobs.append(b)
        offs.append(o[1:] + base)
        base += int(o[-1])
    return (blobs[0] if len(blobs) == 1 else np.concatenate(blobs),
            np.concatenate(offs))


def place_queries(db: PhyloKmerDB, query_path, workdir,
                  config: PlacementConfig | None = None,
                  engine: PlacementEngine | None = None) -> Path:
    config = config or PlacementConfig()
    workdir = Path(workdir)
    logs = workdir / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    qname = Path(query_path).name

    engine = engine or PlacementEngine(
        db, keep_at_most=config.keep_at_most,
        treat_ambiguities=config.treat_ambiguities,
        ambiguities_with_max=config.ambiguities_with_max,
        precision=config.precision, table=config.table,
        device=config.device)
    writer = JplaceWriter(db.tree, config.invocation,
                          guppy_compatible=config.guppy_compatible,
                          keep_factor=config.keep_factor)
    arr = db.arrays

    dedup = _make_dedup()
    reg = _OrderState()
    batcher = IndexBatcher(batch_size=config.batch_size)
    t0 = time.time()
    counts = {"total": 0, "unique": 0, "unplaced": 0}

    suffix = ("" if config.read_shard is None
              else f".part{config.read_shard[0]}")
    tsv = open(logs / f"placements_{qname}.tsv{suffix}", "wb") \
        if config.write_tsv else None
    if tsv:
        tsv.write(b"Query\tARTree_NodeId\tARTree_NodeName\t"
                  b"ExtendedTree_NodeId\tExtendedTree_NodeName\t"
                  b"Original_NodeId\tOriginal_NodeName\tPP*\n")
    # node-id-indexed label blob for the native TSV formatter
    _lbl = [s.encode("utf-8") for s in arr.labels]
    lbl_buf = b"".join(_lbl)
    lbl_off = np.zeros(len(_lbl) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, _lbl), np.int64, len(_lbl)),
              out=lbl_off[1:])
    lbl_off = lbl_off.astype(np.int32)
    # --original-nodes DBs: the best edge resolves to an adjacent ghost
    # whose AR/extended mapping fills the TSV columns
    # (PlacementProcess.java:856-962; precomputed at build, see
    # orinodes_resolution_table of rappas_tpu's build); default DBs
    # leave the four mapping columns empty exactly like the reference's
    # onlyFakes branch (PlacementProcess.java:951-959)
    resolution = db.meta.get("orinodes_resolution")
    notplaced = open(logs / f"notplaced_{qname}.tsv{suffix}", "wb")

    # ZERO python loops over reads on the hot path: parse / md5 /
    # dedup-map / matrix fill run in native block calls
    # (rappas_tpu_torch.native via seqio.ingest_blocks), state registration is
    # three vectorized stores, and python only touches actual
    # duplicates and unplaced reads.  The reference's strictly serial
    # equivalent is PlacementProcess.java:568-645.

    def handle_batch(meta, in_flight_batch):
        """Fold one completed batch into the writer -- array work per
        BATCH.  ``meta`` is ``(refs, orders)``: header bytes stay in
        one blob (round 5), python strings materialize only for reads
        on an output edge case (unplaced, queued duplicates, the rare
        --original-nodes TSV branch)."""
        refs, orders = meta
        res = in_flight_batch.result()
        n = orders.shape[0]
        counts["unique"] += n
        pre = writer.precompute_batch(res)
        placed = pre["n_keep"][:n] > 0
        filtered = np.zeros(n, bool)
        if config.ns_bound > float("-inf"):
            filtered = placed & (res.top_scores[:n, 0] < config.ns_bound)
            placed &= ~filtered
        hdr_blob, hdr_off = _headers_blob(refs)
        reads = np.flatnonzero(placed)
        batch = writer.add_batch(hdr_blob, hdr_off, pre, reads,
                                 orders[reads])
        reg.register(batch, orders, placed, filtered)
        fmt_q.put(batch)       # eager line formatting (thread)

        def hdr(i):
            return hdr_blob[hdr_off[i]:hdr_off[i + 1]].tobytes() \
                .decode("utf-8", "replace")

        # duplicates queued while this batch was in flight (rare):
        # resolve BEFORE listing unplaced so a first occurrence and its
        # early duplicates land together, like the serial reference
        pending_here = {}
        if reg.pending:
            oset = set(orders.tolist())
            for o in [o for o in reg.pending if o in oset]:
                pending_here[o] = reg.pending.pop(o)
        unplaced = ~placed & ~filtered
        if pending_here:
            # rare interleaving path: queued duplicates must land right
            # after their first occurrence
            unplaced_lines = []
            interesting = unplaced | np.isin(
                orders, np.fromiter(pending_here, np.int64,
                                    len(pending_here)))
            for i in np.flatnonzero(interesting).tolist():
                dups = pending_here.get(int(orders[i]))
                if placed[i]:
                    for dup_header in dups or ():
                        JplaceWriter.add_duplicate(batch, i, dup_header)
                elif not filtered[i]:
                    unplaced_lines.append(hdr(i))
                    unplaced_lines.extend(dups or ())
            if unplaced_lines:
                counts["unplaced"] += len(unplaced_lines)
                notplaced.write(("\n".join(unplaced_lines) + "\n")
                                .encode("utf-8"))
        elif unplaced.any():
            # bulk unplaced listing with one range gather + newline
            # scatter (a high-miss workload -- e.g. protein screens --
            # can have ~every read here; the python loop was its wall)
            from rappas_tpu_torch.native import gather_ranges
            ui = np.flatnonzero(unplaced)
            ub, uo = gather_ranges(hdr_blob, hdr_off[ui],
                                   hdr_off[ui + 1])
            lens_u = np.diff(uo)
            out = np.full(ub.shape[0] + ui.size, 0x0A, np.uint8)
            out[np.arange(ub.shape[0]) +
                np.repeat(np.arange(ui.size), lens_u)] = ub
            counts["unplaced"] += int(ui.size)
            notplaced.write(out.tobytes())
        if tsv and reads.size:
            best = res.top_edges[reads, 0]
            score0 = res.top_scores[reads, 0]
            if resolution is None:
                # default DBs: one native call formats the whole batch.
                # Only the toolchain-dependent calls sit in the try --
                # a real I/O error from tsv.write must propagate, not
                # be mistaken for a missing compiler
                from rappas_tpu_torch.native import (format_tsv_rows,
                                               gather_ranges)
                buf = None
                try:
                    hb, ho = gather_ranges(hdr_blob, hdr_off[reads],
                                           hdr_off[reads + 1])
                    buf = format_tsv_rows(hb, ho, best, score0,
                                          lbl_buf, lbl_off)
                except Exception:
                    pass       # toolchain missing: python fallback
                if buf is not None:
                    tsv.write(buf)
                    return
            lines = []
            for i, b, score in zip(reads.tolist(), best.tolist(),
                                   score0.tolist()):
                q = hdr(i).split(" ")[0]
                r = resolution.get(str(b)) if resolution else None
                if r is not None:
                    ar_id, ar_lbl, ext_id, ext_lbl, orig = r
                    lines.append(f"{q}\t{ar_id}\t{ar_lbl}\t{ext_id}\t"
                                 f"{ext_lbl}\t{orig}\t"
                                 f"{arr.labels[orig]}\t{score}")
                else:
                    lines.append(f"{q}\t\t\t\t\t{b}\t"
                                 f"{arr.labels[b]}\t{score}")
            tsv.write(("\n".join(lines) + "\n").encode("utf-8"))

    # keep a few batches in flight: device compute and both transfer
    # directions overlap with the host-side jplace assembly.  The
    # engine's host-side prep (packing / k-mer indexing / table lookup
    # / window routing) runs on a single dedicated thread so it
    # overlaps the main thread's dedup + writer work too (round 5);
    # one worker keeps engine calls serialized in submission order.
    from concurrent.futures import ThreadPoolExecutor
    prep = ThreadPoolExecutor(max_workers=1)
    in_flight: list = []

    def submit(batch):
        refs, orders, lens, mat = batch
        fut = prep.submit(engine.score_async, mat, lens)
        in_flight.append(((refs, orders), fut))
        if len(in_flight) > 3:
            meta, f = in_flight.pop(0)
            handle_batch(meta, f.result())

    # round-5 host pipelining across cores: a reader thread runs file
    # IO + native block parse + md5 (ctypes releases the GIL), and a
    # formatter thread renders each completed batch's jplace line blob
    # eagerly (native formatting, also GIL-free) so the final write is
    # mostly sequential file IO.  Dedup and state registration stay in
    # the main thread, in arrival order -- the ordering contract is
    # untouched.
    import queue
    import threading
    blocks_q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()     # set on ANY exit so no thread leaks

    def _reader():
        err = None
        try:
            for blk in ingest_blocks(query_path):
                while not stop.is_set():
                    try:
                        blocks_q.put(blk, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as e:   # propagate into the main thread
            err = e
        while not stop.is_set():     # None = clean end of stream
            try:
                blocks_q.put(err, timeout=0.25)
                return
            except queue.Full:
                continue

    fmt_q: "queue.Queue" = queue.Queue()

    fmt_err: list = []

    def _formatter():
        # _batch_lines already returns None when the native toolchain is
        # missing; anything it raises is a formatting bug, re-raised in
        # the main thread after the join below
        while True:
            b = fmt_q.get()
            if b is None:
                return
            try:
                b.lines = writer._batch_lines(b) or False
            except BaseException as e:
                fmt_err.append(e)
                return

    reader = threading.Thread(target=_reader, daemon=True)
    reader.start()
    formatter = threading.Thread(target=_formatter, daemon=True)
    formatter.start()

    def iter_blocks():
        while True:
            blk = blocks_q.get()
            if blk is None:
                return
            if isinstance(blk, BaseException):
                raise blk
            yield blk

    try:
        shard = config.read_shard
        gidx = 0       # index over the whole file (round-robin host shard,
        #                as rappas_tpu's parallel.distributed.shard_reads)
        order = 0      # arrival rank within this shard (output ordering)
        for pb in iter_blocks():
            # md5 keys come pre-computed per block (gap-stripped sequence,
            # PlacementProcess.java:591-596 / Fasta.java:34-39); the
            # digest -> first-order map lives in native code (_make_dedup)
            if shard is None:
                sel = np.arange(pb.n, dtype=np.int64)
            else:
                g = gidx + np.arange(pb.n, dtype=np.int64)
                sel = np.flatnonzero(g % shard[1] == shard[0])
                gidx += pb.n
            counts["total"] += sel.shape[0]
            orders_blk = order + np.arange(sel.shape[0], dtype=np.int64)
            order += sel.shape[0]
            first = dedup(pb.md5s[sel], orders_blk)
            dup = np.flatnonzero(first >= 0)
            if dup.size:
                # duplicate occurrences: attach to the placed first,
                # re-list unplaced per occurrence (the reference only
                # dedups *placed* reads, PlacementProcess.java:591-629),
                # queue while the first's batch is still in flight.
                # Round 5: the common placed case is fully vectorized --
                # sub-header tokens are extracted in one pass and attached
                # per target batch as array chunks; python remains only
                # for unplaced / in-flight firsts (rare).
                js = sel[dup]
                fo = first[dup]
                cap = reg.status.shape[0]
                st = np.where(fo < cap,
                              reg.status[np.minimum(fo, cap - 1)],
                              np.int8(_IN_FLIGHT))
                pl = np.flatnonzero(st == _PLACED)
                if pl.size:
                    toks, toff = _first_tokens(pb, js[pl])
                    bids = reg.bidx[fo[pl]]
                    slots = reg.slot[fo[pl]]
                    for bid in np.unique(bids).tolist():
                        m = np.flatnonzero(bids == bid)
                        from rappas_tpu_torch.native import gather_ranges
                        tb, to = gather_ranges(toks, toff[m], toff[m + 1])
                        reg.batches[bid].add_extras_chunk(
                            slots[m].astype(np.int64), tb, to)
                for d in np.flatnonzero(st == _UNPLACED).tolist():
                    notplaced.write((pb.header(int(js[d])) + "\n")
                                    .encode("utf-8"))
                    counts["unplaced"] += 1
                for d in np.flatnonzero(st == _IN_FLIGHT).tolist():
                    reg.pending.setdefault(int(fo[d]), []).append(
                        pb.header(int(js[d])))
                # _FILTERED: nsbound-filtered reads re-filter silently
            fresh = np.flatnonzero(first < 0)
            for b in batcher.add_block(pb, sel[fresh], orders_blk[fresh]):
                submit(b)
        for b in batcher.flush():
            submit(b)
        for meta, f in in_flight:
            handle_batch(meta, f.result())
    finally:
        # release the pipeline threads on EVERY exit path: an
        # exception mid-stream must not leak a reader blocked on
        # a full queue, a formatter blocked on get(), or the prep
        # executor (they pin parsed blocks / batches otherwise)
        stop.set()
        prep.shutdown(wait=False)
        fmt_q.put(None)
        reader.join(timeout=10)
        formatter.join(timeout=60)
    if fmt_err:
        raise fmt_err[0]

    if tsv:
        tsv.close()
    notplaced.close()

    out = workdir / f"placements_{qname}.jplace{suffix}"
    writer.write(out)
    dt = time.time() - t0
    log(f"{counts['total']} queries ({counts['unique']} unique, "
        f"{counts['unplaced']} unplaced) in {dt:.2f}s "
        f"({counts['total'] / max(dt, 1e-9):.0f} reads/s)")
    log(f"{writer.n_placements} placements written to {out}")
    return out
