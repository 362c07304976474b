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
from rappas_tpu_torch.native import (NativeDedup, format_tsv_rows,
                                     gather_ranges)
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.place.jplace import JplaceWriter
from rappas_tpu_torch.seqio import IndexBatcher, ingest_blocks
from rappas_tpu_torch import utils
from rappas_tpu_torch.utils import count, log, span, trace_totals

#: per-order dedup state codes (see _OrderState)
_IN_FLIGHT, _PLACED, _UNPLACED, _FILTERED = 0, 1, 2, 3


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
    #: (multi-host mode: ``--num-hosts``, ``--coordinator``)
    read_shard: tuple | None = None


def _first_tokens(pb, idx):
    """Sub-headers (header up to the first space,
    ``PlacementProcess.java:598-612``) of block records ``idx`` as a
    byte blob + offsets -- fully vectorized for native blocks."""
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
    (FASTQ/gz) encodes its python strings."""
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
    before = trace_totals()
    with span("place.call"):
        out, n_placements, t0 = _place(db, query_path, workdir, config,
                                       engine)
    dt = time.time() - t0
    after = trace_totals()

    def delta(name):
        return after["counters"].get(name, 0) - \
            before["counters"].get(name, 0)
    n = delta("place.reads")
    log(f"{n} queries ({delta('place.unique')} unique, "
        f"{delta('place.unplaced')} unplaced) in {dt:.2f}s "
        f"({n / max(dt, 1e-9):.0f} reads/s)")
    log(f"{n_placements} placements written to {out}")
    if utils.VERBOSITY >= 1:
        # this call's span totals (count, total ms / self ms) and counters
        parts = []
        for name, a in sorted(after["spans"].items()):
            b = before["spans"].get(name, {"count": 0, "total_s": 0.0,
                                           "self_s": 0.0})
            if a["count"] > b["count"]:
                parts.append(f"{name} {a['count'] - b['count']}x "
                             f"{1e3 * (a['total_s'] - b['total_s']):.1f}/"
                             f"{1e3 * (a['self_s'] - b['self_s']):.1f} ms")
        parts += [f"{name}={delta(name)}" for name in sorted(
            after["counters"]) if delta(name)]
        log("trace: " + ", ".join(parts), level=1)
    return out


def _place(db: PhyloKmerDB, query_path, workdir,
           config: PlacementConfig | None,
           engine: PlacementEngine | None):
    """The body of :func:`place_queries`: the jplace path, the number of
    placements written and the start of the placement clock."""
    with span("place.start"):
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

        dedup = NativeDedup()
        reg = _OrderState()
        batcher = IndexBatcher(batch_size=config.batch_size)
        t0 = time.time()

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
        with span("place.result_wait"):
            res = in_flight_batch.result()
        n = orders.shape[0]
        count("place.unique", n)
        count("place.batches")
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

        # duplicates queued while this batch was in flight: every
        # duplicate whose first occurrence lies in its own input block
        # (a block is deduped before any of its batches is scored, and a
        # block holds 8 MB: a whole MiSeq sample of 7,113 x 240 bp reads,
        # where pipeline.pending_dup_pct reads 100%).  Resolve BEFORE
        # listing unplaced so a first occurrence and its early
        # duplicates land together, like the serial reference
        pending_here = {}
        if reg.pending:
            oset = set(orders.tolist())
            for o in [o for o in reg.pending if o in oset]:
                pending_here[o] = reg.pending.pop(o)
        unplaced = ~placed & ~filtered
        if pending_here:
            # queued duplicates must land right after their first
            # occurrence
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
                count("place.unplaced", len(unplaced_lines))
                notplaced.write(("\n".join(unplaced_lines) + "\n")
                                .encode("utf-8"))
        elif unplaced.any():
            # bulk unplaced listing with one range gather + newline
            # scatter (a high-miss workload -- e.g. protein screens --
            # can have ~every read here; the python loop was its wall)
            ui = np.flatnonzero(unplaced)
            ub, uo = gather_ranges(hdr_blob, hdr_off[ui],
                                   hdr_off[ui + 1])
            lens_u = np.diff(uo)
            out = np.full(ub.shape[0] + ui.size, 0x0A, np.uint8)
            out[np.arange(ub.shape[0]) +
                np.repeat(np.arange(ui.size), lens_u)] = ub
            count("place.unplaced", int(ui.size))
            notplaced.write(out.tobytes())
        if tsv and reads.size:
            best = res.top_edges[reads, 0]
            score0 = res.top_scores[reads, 0]
            if resolution is None:
                # default DBs: one native call formats the whole batch
                hb, ho = gather_ranges(hdr_blob, hdr_off[reads],
                                       hdr_off[reads + 1])
                tsv.write(format_tsv_rows(hb, ho, best, score0, lbl_buf,
                                          lbl_off))
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
    in_flight: list = []

    def submit(batch):
        refs, orders, lens, mat = batch
        fut = prep.submit(engine.score_async, mat, lens)
        in_flight.append(((refs, orders), fut))
        if len(in_flight) > 3:
            drain_one(*in_flight.pop(0))

    def drain_one(meta, f):
        with span("place.prep_wait"):
            h = f.result()
        with span("place.fold"):
            handle_batch(meta, h)

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
            blocks = ingest_blocks(query_path)
            while True:
                with span("place.read"):
                    blk = next(blocks, None)
                if blk is None:
                    break
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
        # anything _batch_lines raises is re-raised in the main thread
        # after the join below
        while True:
            b = fmt_q.get()
            if b is None:
                return
            try:
                with span("place.format"):
                    b.lines = writer._batch_lines(b)
            except BaseException as e:
                fmt_err.append(e)
                return

    with span("place.start"):
        prep = ThreadPoolExecutor(max_workers=1)
        reader = threading.Thread(target=_reader, daemon=True)
        reader.start()
        formatter = threading.Thread(target=_formatter, daemon=True)
        formatter.start()

    def iter_blocks():
        while True:
            with span("place.ingest_wait"):
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
            with span("place.dedup"):
                # md5 keys come pre-computed per block (gap-stripped
                # sequence, PlacementProcess.java:591-596 /
                # Fasta.java:34-39); the digest -> first-order map lives
                # in native code (NativeDedup)
                if shard is None:
                    sel = np.arange(pb.n, dtype=np.int64)
                else:
                    g = gidx + np.arange(pb.n, dtype=np.int64)
                    sel = np.flatnonzero(g % shard[1] == shard[0])
                    gidx += pb.n
                count("place.blocks")
                count("place.reads", sel.shape[0])
                orders_blk = order + np.arange(sel.shape[0],
                                               dtype=np.int64)
                order += sel.shape[0]
                first = dedup(pb.md5s[sel], orders_blk)
                dup = np.flatnonzero(first >= 0)
                if dup.size:
                    # duplicate occurrences: attach to the placed first,
                    # re-list unplaced per occurrence (the reference only
                    # dedups *placed* reads,
                    # PlacementProcess.java:591-629), queue while the
                    # first's batch is still in flight.  A first placed
                    # in an earlier block's folded batch takes the
                    # vectorized path (round 5): sub-header tokens are
                    # extracted in one pass and attached per target batch
                    # as array chunks.  Python handles per read the
                    # duplicates of unplaced firsts and of firsts still
                    # in flight, which is every duplicate whose first
                    # lies in its own block (see handle_batch)
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
                            tb, to = gather_ranges(toks, toff[m],
                                                   toff[m + 1])
                            reg.batches[bid].add_extras_chunk(
                                slots[m].astype(np.int64), tb, to)
                    unpl = np.flatnonzero(st == _UNPLACED)
                    for d in unpl.tolist():
                        notplaced.write((pb.header(int(js[d])) + "\n")
                                        .encode("utf-8"))
                    flying = np.flatnonzero(st == _IN_FLIGHT)
                    for d in flying.tolist():
                        reg.pending.setdefault(int(fo[d]), []).append(
                            pb.header(int(js[d])))
                    # _FILTERED: nsbound-filtered reads re-filter silently
                    count("place.dups_attached", int(pl.size))
                    count("place.dups_unplaced", int(unpl.size))
                    count("place.unplaced", int(unpl.size))
                    count("place.dups_pending", int(flying.size))
                fresh = np.flatnonzero(first < 0)
                for b in batcher.add_block(pb, sel[fresh],
                                           orders_blk[fresh]):
                    submit(b)
        # the batcher's last partial batches: dedup's end of stream
        with span("place.dedup"):
            for b in batcher.flush():
                submit(b)
        for meta, f in in_flight:
            drain_one(meta, f)
    finally:
        # release the pipeline threads on EVERY exit path: an
        # exception mid-stream must not leak a reader blocked on
        # a full queue, a formatter blocked on get(), or the prep
        # executor (they pin parsed blocks / batches otherwise)
        with span("place.finish"):
            stop.set()
            prep.shutdown(wait=False)
            fmt_q.put(None)
            reader.join(timeout=10)
            formatter.join(timeout=60)
    if fmt_err:
        raise fmt_err[0]

    with span("place.finish"):
        if tsv:
            tsv.close()
        notplaced.close()
        out = workdir / f"placements_{qname}.jplace{suffix}"
        writer.write(out)
    return out, writer.n_placements, t0
