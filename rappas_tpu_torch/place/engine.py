"""Placement engine on PyTorch: batched k-mer scoring on the device.

Port of ``rappas_tpu/place/engine.py`` for the **direct** table layout.
The phylo-kmer table is a dense delta matrix ``D[S^k + 1, E]`` on the
device (``E`` = per-node score slots of the original tree, last row
all-zero = miss target), and a batch of reads is scored at once:

    ``S[b, e] = Q_b * thr + sum_q D[kmer(b, q), e]``

(``PlacementProcess.java:726-734``), then top-K and ``|L|`` per read;
IUPAC-ambiguous windows add their mean / max contributions
(``PlacementProcess.java:1129-1236``).  The device work runs in the four
CUDA kernels of :mod:`rappas_tpu_torch.place.kernels`:

* K1 ``accumulate_packed`` -- reads with no ambiguous or invalid code
  inside their length, shipped 2-bit packed (a quarter of the H2D bytes);
* K2 ``accumulate_codes`` -- the other reads, shipped as int8 codes;
* K4 ``ambiguous_pass_`` -- ambiguity windows, added into ``acc``;
* K3 ``finalize_wire`` -- top-K and ``|L|`` into one int32 wire array.

K1 and K2 each write their own rows of one ``[B, E]`` accumulator, so a
batch with a few ambiguous reads still sends the rest packed (the JAX
engine packs a batch only when no read in it needs codes; the results
are the same).  On ``device="cpu"`` the wrappers compute their plain
PyTorch versions.

Host side (copied from the JAX engine): the ASCII -> code table, the
ambiguity expansion and its cycling order, 2-bit packing, the table
layout rule and the wire decode.  Per batch the host inputs travel in
ONE pinned staging buffer with one H2D copy on the engine's stream, and
the result comes back as one pinned copy of the wire words; ``result()``
waits on the event recorded after it.

Not ported yet (they raise ``NotImplementedError``): the compact and
postings layouts, ``precision="u16"``, and ``E >= 65535`` edge slots
(the u16 wire) -- ROADMAP queue 1.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from rappas_tpu_torch.convert import device_tables
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place import kernels

PAD_CODE = -2     # beyond read end
AMBIG_CODE = -1   # IUPAC ambiguity position

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


class BatchResult(NamedTuple):
    """Device outputs for one read batch (host arrays after fetch)."""
    top_edges: np.ndarray   # int32[B, K] original-tree node ids (-1 pad)
    top_scores: np.ndarray  # float32[B, K] descending
    top_lwr: np.ndarray     # float32[B, K]
    n_matched: np.ndarray   # int32[B] = |L| per read


def unpack_wire(words, K: int) -> BatchResult:
    """Host-side decode of the wire words (``kernels.pack_wire``); LWR
    recomputed with the same f32 FORMULA ``kernels.finalize`` uses (exp2
    of the max-shifted scores, normalized; host exp2 vs device exp2 can
    differ 1 ulp)."""
    words = np.asarray(words)
    K2 = (K + 1) // 2
    ts = words[:, :K].copy().view(np.float32)
    edges = words[:, K:K + K2].copy().view(np.uint16)[:, :K]
    nm = words[:, K + K2]
    te = np.where(edges == 65535, -1, edges.astype(np.int32))
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
    that copy, or a finished :class:`BatchResult`."""

    def __init__(self, out, wire: int = 0, event=None):
        self._out = out
        self._wire = wire
        self._event = event

    def result(self) -> BatchResult:
        if isinstance(self._out, BatchResult):
            return self._out
        if self._event is not None:
            self._event.synchronize()
        return unpack_wire(self._out.numpy(), self._wire)


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


class PlacementEngine:
    #: byte budget for the direct-indexed dense table (above it the JAX
    #: engine takes the compact table).  PLACEHOLDER: the JAX engine's
    #: value for a 16 GB TPU v5e, kept so that ``table="auto"`` resolves
    #: as it does there, until H100 measurements set it.
    DIRECT_BYTE_LIMIT = 8 << 30
    #: PLACEHOLDER, as above: the JAX engine's fast-gather zone edge on
    #: the v5e (``resolve_table`` picks direct below twice this size).
    LIGHT_SPLIT_BYTES = 96 << 20

    def __init__(self, db: PhyloKmerDB, keep_at_most: int = 7,
                 treat_ambiguities: bool = True,
                 ambiguities_with_max: bool = False,
                 device="cuda", precision: str = "f32",
                 table: str = "auto", postings_width: int = 8):
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
        if precision == "u16":
            raise NotImplementedError(
                "precision='u16' is not yet ported (ROADMAP queue 1 "
                "item 1)")
        table = self.resolve_table(db, table, precision,
                                   self.DIRECT_BYTE_LIMIT, postings_width)
        if table != "direct":
            item = {"compact": 4, "postings": 5}.get(table)
            if item is None:
                raise ValueError(f"table must be auto/direct/compact/"
                                 f"postings, got {table!r}")
            raise NotImplementedError(
                f"table={table!r} is not yet ported (ROADMAP queue 1 "
                f"item {item})")
        if db.n_edge_slots >= 65535:
            raise NotImplementedError(
                f"{db.n_edge_slots} edge slots do not fit the u16 wire; "
                "the four-array result path is not yet ported (ROADMAP "
                "queue 1 item 5)")
        self.db = db
        self.k = db.k
        self.alphabet = db.alphabet
        self.keep_at_most = keep_at_most
        self.treat_ambiguities = treat_ambiguities
        self.ambiguities_with_max = ambiguities_with_max
        self.precision = precision
        self.table = table
        self.D, scale, thr = device_tables(db, self.device)
        self.scale = float(scale)
        self.thr = float(thr)
        self.n_rows = self.D.shape[0]
        self._init_host_codec()
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the table upload ran on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # -------------------------------------------------------------- #
    @classmethod
    def resolve_table(cls, db: PhyloKmerDB, table: str, precision: str,
                      direct_byte_limit: int,
                      postings_width: int = 8) -> str:
        """'auto' -> the concrete device layout for this DB size (the
        analog of the reference's direct-vs-hashed capacity choice,
        ``CustomHash_v4_FastUtil81.java:49-63``).

        The rule is the JAX engine's, unchanged, so that both packages
        pick the same layout for a DB: direct while the dense table is
        small (under ``2 * LIGHT_SPLIT_BYTES`` and the direct budget);
        past that, postings for light-dominated DBs (most postings in
        k-mers with at most ``postings_width`` entries) and the
        direct/compact capacity rule otherwise.  Its thresholds were
        measured for a TPU v5e; for the port they are placeholders until
        H100 measurements set them.
        """
        if table != "auto":
            return table
        itemsize = 2 if precision == "u16" else 4
        dense_bytes = (db.alphabet.n_states ** db.k *
                       db.n_edge_slots * itemsize)
        compact_bytes = (db.n_kmers + 1) * db.n_edge_slots * itemsize
        fast_bytes = 2 * cls.LIGHT_SPLIT_BYTES
        if dense_bytes <= min(fast_bytes, direct_byte_limit):
            return "direct"
        lens = np.diff(db.offsets)
        heavy_nnz = int(lens[lens > postings_width].sum()) \
            if lens.size else 0
        light_dominated = heavy_nnz * 2 <= max(int(db.nnz), 1)
        if precision != "u16" and light_dominated:
            return "postings"
        if dense_bytes <= max(direct_byte_limit, 2 * compact_bytes):
            return "direct"
        if compact_bytes <= direct_byte_limit:
            return "compact"
        if precision == "u16":
            raise ValueError(
                "DB too large for u16 dense/compact tables; use "
                "precision='f32' (postings layout)")
        return "postings"

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
        B, L = matrix.shape
        if L < self.k:
            # no window fits: every read is unplaced
            K = min(self.keep_at_most, self.db.n_edge_slots)
            return PendingBatch(BatchResult(
                np.full((B, K), -1, np.int32),
                np.full((B, K), -np.inf, np.float32),
                np.zeros((B, K), np.float32),
                np.zeros(B, np.int32)))
        lengths = np.ascontiguousarray(lengths, np.int32)
        codes = self.encode_batch(matrix)
        host = {"lengths": lengths}
        # 2-bit packing fabricates k-mers from negative codes (they pack
        # as 0 == 'A'), so only reads clean inside their length go packed
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
        amb = (self._expand_ambiguities_host(codes, matrix, lengths)
               if self.treat_ambiguities else None)
        if amb is not None:
            kidx, alt_win, win_read, win_inv_w, is_mean = amb
            host["alt_rows"] = kidx.astype(np.int32)
            host["win_off"] = window_offsets(alt_win, win_read.shape[0])
            host["win_read"] = win_read.astype(np.int32)
            host["win_inv_w"] = win_inv_w.astype(np.float32)
            host["win_is_mean"] = is_mean.astype(np.uint8)

        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            dev = self._stage(host)
            acc = torch.empty((B, self.D.shape[1]), dtype=torch.float32,
                              device=self.device)
            if "packed" in dev:
                kernels.accumulate_packed(
                    self.D, dev["packed"],
                    dev.get("packed_lengths", dev["lengths"]), L, self.k,
                    self.scale, acc=acc, dest=dev.get("packed_dest"))
            if "codes" in dev:
                kernels.accumulate_codes(
                    self.D, dev["codes"], self.k, self.alphabet.n_states,
                    self.scale, acc=acc, dest=dev.get("codes_dest"))
            if amb is not None:
                kernels.ambiguous_pass_(
                    acc, self.D, self.scale, dev["alt_rows"],
                    dev["win_off"], dev["win_read"], dev["win_inv_w"],
                    dev["win_is_mean"])
            wire = kernels.finalize_wire(acc, dev["lengths"], self.thr,
                                         self.k, self.keep_at_most)
            K = min(self.keep_at_most, self.D.shape[1])
            if self._stream is None:
                return PendingBatch(wire, wire=K)
            out = torch.empty(wire.shape, dtype=torch.int32,
                              pin_memory=True)
            out.copy_(wire, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
            return PendingBatch(out, wire=K, event=done)

    def _stage(self, arrays: dict) -> dict:
        """Host arrays -> device tensors of the same dtype and shape.  On
        the card: one pinned staging buffer (16-byte aligned slots) and
        ONE non-blocking H2D copy on the current stream."""
        if self._stream is None:
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
        dev = pinned.to(self.device, non_blocking=True)
        return {n: dev[offs[n]:offs[n] + a.nbytes]
                .view(_TORCH_DTYPES[a.dtype]).view(a.shape)
                for n, a in arrays.items()}

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
