"""jplace (JSON placement) output.

Reproduces the reference's jplace assembly
(``/root/reference/src/main_v2/Main_PLACEMENT_v07.java:216-315`` and
``PlacementProcess.java:974-1047``):

* ``tree``: original tree newick with branch lengths (12 decimals),
  internal labels and ``{edge_id}`` labels;
* ``fields`` default order ``[edge_num, likelihood, like_weight_ratio,
  distal_length, pendant_length]``; ``--guppy-compat`` order
  ``[distal_length, edge_num, like_weight_ratio, likelihood,
  pendant_length]`` (``Main_PLACEMENT_v07.java:281-297``);
* one placement object per *distinct* read sequence; duplicate reads are
  appended to the ``nm`` list (full header for the first occurrence,
  header truncated at the first space for duplicates --
  ``PlacementProcess.java:605-612,1052-1060``);
* keep-factor cutoff: after the best row, stop at the first row with
  ``lwr < best_lwr * keep_factor`` (``PlacementProcess.java:996-1000``);
* ``version: 3`` and ``metadata.invocation``.

Performance: the reference assembles one json_simple object tree per
value at ~500 reads/s; here placements are stored as per-batch ARRAY
records (zero per-read python objects on the hot path) and the ``"p"``
rows of a whole batch are formatted by one native call
(``rappas_tpu_torch/native/jplacefmt.cpp``, shortest-round-trip doubles via
``std::to_chars``) with a pure-python fallback.
"""

from __future__ import annotations

import json

import numpy as np

from rappas_tpu_torch.tree import Tree, write_newick


def jplace_tree_string(tree: Tree) -> str:
    return write_newick(tree, branch_lengths=True, internal_labels=True,
                        jplace_labels=True, id_prefix=False)


def _json_str(h: str) -> str:
    """JSON string literal; fast path for the typical clean header."""
    if h.isascii() and h.isprintable() and '"' not in h and "\\" not in h:
        return '"%s"' % h
    return json.dumps(h)


class BatchPlacements:
    """All placements of one scored batch, as arrays.

    ``reads[j]`` is the in-batch read index of placement ``j``;
    ``orders[j]`` its global first-occurrence rank (used to restore the
    reference's serial output order, batches complete out of order).
    ``extra[i]`` holds duplicate-read sub-headers attached to read ``i``.
    Headers live as one utf-8 byte blob + offsets (round 5: no per-read
    python strings on the hot path; only reads that hit an output edge
    case ever decode).  Duplicate-read "nm" sub-headers attach either
    as strings (``extra``, the rare in-flight-resolution path) or as
    whole vectorized chunks (``extra_chunks``: (slots, token-blob,
    offsets) tuples, the bulk path)."""
    __slots__ = ("pre", "hdr_blob", "hdr_off", "reads", "orders",
                 "extra", "extra_chunks", "lines")

    def __init__(self, pre: dict, hdr_blob: np.ndarray,
                 hdr_off: np.ndarray, reads: np.ndarray,
                 orders: np.ndarray):
        self.pre = pre
        self.hdr_blob = hdr_blob
        self.hdr_off = hdr_off
        self.reads = reads
        self.orders = orders
        self.extra: dict[int, list[str]] = {}
        self.extra_chunks: list = []
        #: eagerly-formatted native line blob (set by the writer's
        #: background formatter; None = format at write time; the last
        #: tuple element records the extras count it was rendered with)
        self.lines = None

    def header(self, i: int) -> str:
        return self.hdr_blob[self.hdr_off[i]:self.hdr_off[i + 1]] \
            .tobytes().decode("utf-8", "replace")

    def extras_for(self, i: int) -> list:
        """Duplicate sub-headers of in-batch read ``i`` (chronological);
        python-fallback rendering only."""
        out = list(self.extra.get(i, ()))
        for slots, blob, off in self.extra_chunks:
            for m in np.flatnonzero(slots == i).tolist():
                out.append(blob[off[m]:off[m + 1]].tobytes()
                           .decode("utf-8", "replace"))
        return out

    def extras_count(self) -> int:
        return (sum(len(v) for v in self.extra.values()) +
                sum(int(c[0].shape[0]) for c in self.extra_chunks))

    def add_extras_chunk(self, slots: np.ndarray, tok_blob: np.ndarray,
                         tok_off: np.ndarray) -> None:
        """Attach duplicate sub-header tokens for many reads at once
        (``slots``: in-batch read indices, one per token)."""
        if slots.shape[0]:
            self.extra_chunks.append((slots, tok_blob, tok_off))


class JplaceWriter:
    def __init__(self, tree: Tree, invocation: str,
                 guppy_compatible: bool = False,
                 keep_factor: float = 0.01):
        # NOTE: the --nsbound score filter is applied by the pipeline
        # BEFORE reads reach this writer (place_queries.handle_batch);
        # the writer only ever sees reads that passed it
        self.tree = tree
        self.invocation = invocation
        self.guppy = guppy_compatible
        self.keep_factor = keep_factor
        self._batches: list[BatchPlacements] = []
        arr = tree.to_arrays()
        self._jplace_ids = arr.jplace_edge_id
        self._branch_len = arr.branch_len
        # per-node cached decimal fragments: edge_num and distal_length
        # depend only on the node id, so the per-row work left is two
        # float prints (likelihood, lwr)
        self._edge_str = [str(int(j)) for j in self._jplace_ids]
        self._distal_str = [repr(float(np.float32(b / np.float32(2.0))))
                            for b in self._branch_len]
        # flat buffers for the native formatter
        self._estr_buf = "".join(self._edge_str).encode("ascii")
        self._estr_off = np.zeros(len(self._edge_str) + 1, np.int32)
        np.cumsum([len(s) for s in self._edge_str],
                  out=self._estr_off[1:])
        self._dstr_buf = "".join(self._distal_str).encode("ascii")
        self._dstr_off = np.zeros(len(self._distal_str) + 1, np.int32)
        np.cumsum([len(s) for s in self._distal_str],
                  out=self._dstr_off[1:])
        self._native_fmt = True

    # -------------------------------------------------------------- #
    @property
    def n_placements(self) -> int:
        return sum(b.reads.shape[0] for b in self._batches)

    def precompute_batch(self, res) -> dict:
        """Vectorised per-batch derivation of everything ``p`` rows need:
        jplace edge ids, distal lengths, the keep-factor cut
        (``PlacementProcess.java:996-1022``).  Returns arrays indexed per
        read."""
        edges = res.top_edges
        valid = edges >= 0
        safe = np.maximum(edges, 0)
        lwr = res.top_lwr
        keep = valid.copy()
        if keep.shape[1] > 1:
            keep[:, 1:] &= lwr[:, 1:] >= (lwr[:, :1] * self.keep_factor)
        keep = np.logical_and.accumulate(keep, axis=1)
        n_keep = keep.sum(axis=1).astype(np.int64)
        return {"node": safe, "scores": res.top_scores, "lwr": lwr,
                "n_keep": n_keep}

    def add_batch(self, hdr_blob: np.ndarray, hdr_off: np.ndarray,
                  pre: dict, reads: np.ndarray,
                  orders: np.ndarray) -> BatchPlacements:
        """Register one scored batch's placed reads.

        ``reads``: in-batch indices of reads that placed (and passed
        --nsbound); ``orders``: their global first-occurrence ranks;
        ``hdr_blob``/``hdr_off``: the batch's full headers as one utf-8
        byte blob + int64 offsets (read ``i``'s header is
        ``hdr_blob[hdr_off[i]:hdr_off[i+1]]``).
        """
        b = BatchPlacements(pre, hdr_blob, hdr_off,
                            np.asarray(reads, np.int64),
                            np.asarray(orders, np.int64))
        self._batches.append(b)
        return b

    @staticmethod
    def add_duplicate(batch: BatchPlacements, i: int, header: str) -> None:
        """Register an identical read on an existing placement
        (sub-header = up to first space, ``PlacementProcess.java:
        598-612``)."""
        batch.extra.setdefault(i, []).append(header.split(" ")[0])

    # -------------------------------------------------------------- #
    def _batch_rows(self, b: BatchPlacements):
        """Masked row arrays + offsets for one batch's placements."""
        pre = b.pre
        reads = b.reads
        n_keep = pre["n_keep"][reads]
        K = pre["node"].shape[1]
        mask = np.arange(K)[None, :] < n_keep[:, None]
        nodes = pre["node"][reads][mask]
        scores = pre["scores"][reads][mask]
        lwrs = pre["lwr"][reads][mask]
        row_off = np.zeros(reads.shape[0] + 1, np.int64)
        np.cumsum(n_keep, out=row_off[1:])
        return nodes, scores, lwrs, row_off

    def _batch_rows_native(self, b: BatchPlacements):
        """``(rows_blob bytes, rows_off)`` via the native formatter, or
        None when the toolchain is missing."""
        if not self._native_fmt:
            return None
        nodes, scores, lwrs, row_off = self._batch_rows(b)
        try:
            from rappas_tpu_torch.native import format_placement_rows
            return format_placement_rows(
                nodes, scores, lwrs, row_off,
                self._estr_buf, self._estr_off,
                self._dstr_buf, self._dstr_off, self.guppy)
        except Exception:          # toolchain missing: python fallback
            self._native_fmt = False
            return None

    def _batch_row_texts(self, b: BatchPlacements) -> list[str]:
        """jplace ``"p"`` row-list text per placement of one batch."""
        nat = self._batch_rows_native(b)
        if nat is not None:
            s = nat[0].decode("ascii")
            off = nat[1].tolist()
            return [s[off[i]:off[i + 1]]
                    for i in range(b.reads.shape[0])]
        nodes, scores, lwrs, row_off = self._batch_rows(b)
        es, ds = self._edge_str, self._distal_str
        nl = nodes.tolist()
        sl = scores.tolist()
        wl = lwrs.tolist()
        out = []
        for i in range(b.reads.shape[0]):
            lo, hi = int(row_off[i]), int(row_off[i + 1])
            if self.guppy:
                out.append(",".join(
                    "[%s,%s,%r,%r,0.0]" % (ds[nl[r]], es[nl[r]],
                                           wl[r], sl[r])
                    for r in range(lo, hi)))
            else:
                out.append(",".join(
                    "[%s,%r,%r,%s,0.0]" % (es[nl[r]], sl[r],
                                           wl[r], ds[nl[r]])
                    for r in range(lo, hi)))
        return out

    def _extras_arrays(self, b: BatchPlacements):
        """Duplicate "nm" sub-headers flattened in placement order
        (chronological within a placement): ``(cnt int32[n_placed],
        ex_blob bytes, ex_off int64[total+1])`` or None when the batch
        has none."""
        n = b.reads.shape[0]
        pos_parts, blob_parts, start_parts, len_parts = [], [], [], []
        base = 0
        if b.extra:
            # one array pass over ALL dict entries (the per-entry numpy
            # calls were ~2 s/M reads at realistic in-flight dup rates)
            slots = np.fromiter(
                (i for i, lst in b.extra.items() for _ in lst),
                np.int64, sum(len(v) for v in b.extra.values()))
            bs = [s.encode("utf-8") for lst in b.extra.values()
                  for s in lst]
            ls = np.fromiter(map(len, bs), np.int64, len(bs))
            off = np.zeros(ls.shape[0] + 1, np.int64)
            np.cumsum(ls, out=off[1:])
            pos_parts.append(np.searchsorted(b.reads, slots))
            blob_parts.append(np.frombuffer(b"".join(bs), np.uint8))
            start_parts.append(base + off[:-1])
            len_parts.append(ls)
            base += int(off[-1])
        for slots, blob, off in b.extra_chunks:
            pos_parts.append(np.searchsorted(b.reads, slots))
            blob_parts.append(blob)
            start_parts.append(base + off[:-1])
            len_parts.append(np.diff(off))
            base += int(blob.shape[0])
        if not pos_parts:
            return None
        from rappas_tpu_torch.native import gather_ranges
        pos = np.concatenate(pos_parts)
        blob_all = np.concatenate(blob_parts)
        starts = np.concatenate(start_parts)
        lens = np.concatenate(len_parts)
        srt = np.argsort(pos, kind="stable")
        ex_blob, ex_off = gather_ranges(blob_all, starts[srt],
                                        starts[srt] + lens[srt])
        cnt = np.bincount(pos, minlength=n).astype(np.int32)
        return cnt, ex_blob.tobytes(), ex_off

    def _batch_lines(self, b: BatchPlacements, reuse_rows=None):
        """Fully-assembled ``{"p":..,"nm":..},\\n`` lines of one batch
        (native, duplicate sub-headers included): ``(blob, line_off,
        rows_blob, rows_off, n_extras)``.  None when the toolchain is
        missing."""
        if reuse_rows is not None:
            nat = reuse_rows
        else:
            nat = self._batch_rows_native(b)
            if nat is None:
                return None
        rows_blob, rows_off = nat
        from rappas_tpu_torch.native import (format_placement_lines,
                                       gather_ranges)
        hb, hdr_off = gather_ranges(b.hdr_blob, b.hdr_off[b.reads],
                                    b.hdr_off[b.reads + 1])
        ex = self._extras_arrays(b)
        n_extras = int(ex[0].sum()) if ex is not None else 0
        try:
            blob, off = format_placement_lines(
                rows_blob, rows_off, hb.tobytes(), hdr_off,
                *(ex if ex is not None else (None, b"", None)))
        except Exception:              # toolchain missing
            self._native_fmt = False
            return None
        return blob, off, rows_blob, rows_off, n_extras

    def _ordered_chunks(self):
        """Yield placement text as BYTES chunks in first-occurrence read
        order (the reference's serial order).  A chunk holds >= 1
        complete ``{"p":...,"nm":...}`` objects joined by b",\\n"; runs
        of consecutive placements from one batch are sliced from the
        batch's native line blob in one go.  Duplicate-read ``nm``
        sub-headers are baked into the blob by the native formatter
        (round 5); an eagerly-formatted blob is reused when its extras
        count still matches, else the batch re-renders from its cached
        rows blob.  Per-placement python remains only on the
        no-toolchain fallback."""
        if not self._batches:
            return
        bl = self._batches
        sizes = [b.reads.shape[0] for b in bl]
        all_orders = np.concatenate([b.orders for b in bl])
        bidx = np.repeat(np.arange(len(sizes)), sizes)
        pos = np.concatenate([np.arange(s) for s in sizes]) \
            if sizes else np.zeros(0, np.int64)
        srt = np.argsort(all_orders, kind="stable")
        bid_s = bidx[srt]
        pos_s = pos[srt]
        n = srt.shape[0]
        run_starts = np.flatnonzero(np.concatenate(
            [[True], (bid_s[1:] != bid_s[:-1]) |
             (pos_s[1:] != pos_s[:-1] + 1)])) if n else np.zeros(0,
                                                                 np.int64)
        run_ends = np.append(run_starts[1:], n)
        lines = [None] * len(bl)
        texts = [None] * len(bl)

        def py_line(b, j, p):
            i = int(b.reads[p])
            header = b.header(i)
            nm = ",".join("[%s,1]" % _json_str(h)
                          for h in [header] + b.extras_for(i))
            if texts[j] is None:
                texts[j] = self._batch_row_texts(b)
            rows = texts[j][p]
            return ('{"p":[%s],"nm":[%s]}' % (rows, nm)).encode("utf-8")

        for s, e in zip(run_starts.tolist(), run_ends.tolist()):
            j = int(bid_s[s])
            b = bl[j]
            if lines[j] is None:
                ent = b.lines
                if ent is not None and ent is not False and \
                        ent[4] != b.extras_count():
                    # extras arrived after the eager render: re-render
                    # with them baked in, reusing the cached rows blob
                    ent = self._batch_lines(b, reuse_rows=ent[2:4])
                if ent is None:
                    ent = self._batch_lines(b)
                lines[j] = ent if ent is not None else False
            ent = lines[j]
            p0, p1 = int(pos_s[s]), int(pos_s[e - 1])
            if ent is False:
                for p in range(p0, p1 + 1):
                    yield py_line(b, j, p)
                continue
            blob, off = ent[0], ent[1]
            yield blob[off[p0]:off[p1 + 1] - 2]       # strip last ",\n"

    # -------------------------------------------------------------- #
    def _fields(self) -> list[str]:
        if self.guppy:
            return ["distal_length", "edge_num", "like_weight_ratio",
                    "likelihood", "pendant_length"]
        return ["edge_num", "likelihood", "like_weight_ratio",
                "distal_length", "pendant_length"]

    def to_dict(self) -> dict:
        return {
            "tree": jplace_tree_string(self.tree),
            "placements": [json.loads(t) for c in self._ordered_chunks()
                           for t in c.split(b",\n")],
            "version": 3,
            "metadata": {"invocation": self.invocation},
            "fields": self._fields(),
        }

    def write(self, path) -> None:
        """Stream the jplace JSON, one placement per line (diffs well).

        Hand-rolled serialisation: ``json.dump`` dominates the host-side
        placement budget at high read counts (measured 12s per 100k
        reads); since round 4 whole batch runs are native-formatted byte
        chunks (``jplacefmt.cpp``)."""
        with open(path, "wb") as f:
            f.write(b'{"tree":')
            f.write(json.dumps(jplace_tree_string(self.tree)).encode())
            f.write(b',\n"placements":[')
            first = True
            for c in self._ordered_chunks():
                f.write(b"\n" if first else b",\n")
                first = False
                f.write(c)
            f.write(b'\n],\n"version":3,\n"metadata":')
            f.write(json.dumps({"invocation": self.invocation}).encode())
            f.write(b',\n"fields":')
            f.write(json.dumps(self._fields()).encode())
            f.write(b"}\n")
