"""Streaming FASTA / FASTQ readers and batching for the placement engine.

Replaces ``/root/reference/src/inputs/FASTAPointer.java`` /
``FASTQPointer.java``.  Reads are yielded as (header, sequence) pairs;
``#``-prefixed and empty lines are skipped like the reference
(``FASTAPointer.java:83-86``).  Multi-line sequences are concatenated.

:class:`IndexBatcher` groups reads into fixed-capacity numpy batches
(padded to a static length bucket) so the JAX placement kernel sees
static shapes; :func:`ingest_blocks` feeds it parsed blocks (native C++
for plain FASTA, :class:`PyBlock` otherwise).
"""

from __future__ import annotations

import gzip
import hashlib
from typing import Iterator

import numpy as np

from rappas_tpu_torch.native import parse_fasta_block


def _open(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")
    return open(p, "r")


def read_fasta(path) -> Iterator[tuple[str, str]]:
    header = None
    chunks: list[str] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line or line.startswith("#"):
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)


def read_fastq(path) -> Iterator[tuple[str, str]]:
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            # strip CRLF like the FASTA reader: a '\r' left on the
            # sequence would corrupt the md5 dedup key and invalidate
            # the read's last k-mer window
            h = h.rstrip("\n").rstrip("\r")
            if not h:
                continue
            if not h.startswith("@"):
                raise ValueError(f"malformed FASTQ header: {h!r}")
            seq = f.readline().rstrip("\n").rstrip("\r")
            plus = f.readline()
            f.readline()  # qualities
            if not plus.startswith("+"):
                raise ValueError("malformed FASTQ record")
            yield h[1:], seq


def read_sequences(path) -> Iterator[tuple[str, str]]:
    """Dispatch on extension: .fq/.fastq(.gz) -> FASTQ, else FASTA."""
    p = str(path)
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith((".fq", ".fastq")):
        return read_fastq(path)
    return read_fasta(path)


def _parse_fasta_block(data: bytes) -> list[tuple[str, bytes]]:
    """Parse a byte block of complete FASTA records (fast path: C-level
    splits; falls back to line-wise parsing when '#' comment lines or
    '\\r' endings are present)."""
    if b"\r" in data or b"\n#" in data or data.startswith(b"#"):
        out = []
        header = None
        chunks: list[bytes] = []
        for line in data.split(b"\n"):
            line = line.rstrip(b"\r")
            if not line or line.startswith(b"#"):
                continue
            if line.startswith(b">"):
                if header is not None:
                    out.append((header, b"".join(chunks)))
                header = line[1:].decode()
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            out.append((header, b"".join(chunks)))
        return out
    out = []
    for rec in data.split(b"\n>"):
        if not rec or rec == b">":
            continue
        if rec.startswith(b">"):
            rec = rec[1:]
        hdr, _, rest = rec.partition(b"\n")
        if not hdr:
            continue
        out.append((hdr.decode(),
                    rest.replace(b"\n", b"") if b"\n" in rest else rest))
    return out


def read_record_blocks(path, block_bytes: int = 8 << 20
                       ) -> Iterator[list[tuple[str, bytes]]]:
    """Yield lists of (header, sequence-bytes) records.

    Plain FASTA takes a block parser (~10x the per-line generator rate
    at production read counts); FASTQ and gzipped inputs wrap the
    streaming readers in chunks.
    """
    import itertools

    p = str(path)
    if p.endswith(".gz") or p[:-3 if p.endswith(".gz") else len(p)] \
            .endswith((".fq", ".fastq")):
        it = read_sequences(path)
        while True:
            chunk = list(itertools.islice(it, 16384))
            if not chunk:
                return
            yield [(h, s.encode("ascii")) for h, s in chunk]
    for block in read_raw_fasta_blocks(path, block_bytes):
        yield _parse_fasta_block(block)


# ------------------------------------------------------------------ #
# block-ingest layer (round 4): the placement pipeline consumes parsed
# BLOCKS with lazily-materialized python objects, so per-read host work
# shrinks to dedup dict bookkeeping (VERDICT r3 item 6).  The native
# path (rappas_tpu_torch.native.parse_fasta_block: C++ parse + md5 + matrix
# fill) covers plain FASTA; FASTQ / gzipped inputs take the python
# PyBlock with identical semantics.
# ------------------------------------------------------------------ #

def read_raw_fasta_blocks(path, block_bytes: int = 8 << 20
                          ) -> Iterator[bytes]:
    """Raw byte blocks of complete FASTA records (cut at '\\n>')."""
    def nonblank(b):
        # bytes.strip() copies the whole multi-MB block just to test
        # emptiness (~60 ms/block measured); isspace() returns at the
        # first non-space byte
        return b and not b.isspace()

    with open(str(path), "rb") as f:
        tail = b""
        while True:
            chunk = f.read(block_bytes)
            if not chunk:
                if nonblank(tail):
                    yield tail
                return
            data = tail + chunk
            cut = data.rfind(b"\n>")
            if cut == -1:
                tail = data
                continue
            tail = data[cut + 1:]
            block = data[:cut + 1]
            if nonblank(block):
                yield block


class PyBlock:
    """The :class:`rappas_tpu_torch.native.ParsedBlock` interface in
    python, built from parsed (header, seq-bytes) records (FASTQ and
    gzipped inputs)."""

    __slots__ = ("n", "_headers", "_seqs", "lens", "md5s")

    def __init__(self, records: list[tuple[str, bytes]]):
        self.n = len(records)
        self._headers = [h for h, _ in records]
        self._seqs = [s for _, s in records]
        self.lens = np.fromiter(map(len, self._seqs), np.int64, self.n)
        self.md5s = np.frombuffer(
            b"".join(hashlib.md5(s.replace(b"-", b"") if b"-" in s
                                 else s).digest()
                     for s in self._seqs), np.uint8).reshape(self.n, 16)

    def header(self, i: int) -> str:
        return self._headers[i]

    def sequence(self, i: int) -> bytes:
        return self._seqs[i]

    def fill_matrix(self, idx: np.ndarray, L: int) -> np.ndarray:
        mat = np.full((len(idx), L), 0xFF, np.uint8)
        for row, i in enumerate(np.asarray(idx, np.int64)):
            s = self._seqs[i][:L]
            mat[row, :len(s)] = np.frombuffer(s, np.uint8)
        return mat


def ingest_blocks(path, block_bytes: int = 8 << 20):
    """Yield parsed blocks of any supported input: native
    :class:`rappas_tpu_torch.native.ParsedBlock` for plain FASTA,
    :class:`PyBlock` for FASTQ and gzipped inputs."""
    if str(path).endswith((".gz", ".fq", ".fastq")):
        for records in read_record_blocks(path, block_bytes):
            yield PyBlock(records)
        return
    for block in read_raw_fasta_blocks(path, block_bytes):
        yield parse_fasta_block(block)


class IndexBatcher:
    """Length-bucketed batcher over (block, record-index) pairs.

    ``add_block(pb, idxs, orders)`` ingests one parsed block's fresh
    reads at a time (numpy bucketing, native matrix fill) and returns
    any completed ``(refs, orders, lengths, matrix)`` batches, where
    ``refs`` is a list of ``(block, index-array)`` chunks in batch row
    order and ``orders`` the int64 arrival ranks -- fully array-level,
    no per-read python objects (round 5; the old interface carried one
    meta tuple per read).  ``flush()`` drains partial buckets.
    Matrices are padded to ``batch_size`` rows when ``pad_batch``
    (static shapes for the engine), pad cells 0xFF."""

    def __init__(self, batch_size: int = 1024,
                 buckets: tuple[int, ...] = (64, 128, 256, 512, 1024,
                                             4096, 16384),
                 pad_batch: bool = True):
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.pad_batch = pad_batch
        tab = []
        for b in self.buckets:
            tab.extend([b] * (b + 1 - len(tab)))
        self._tab = np.asarray(tab, np.int64)
        #: bucket -> [[(pb, idx-array), ...], [order-array, ...], count]
        self._pend: dict[int, list] = {}

    def add_block(self, pb, idxs, orders):
        out = []
        if not len(idxs):
            return out
        ia = np.asarray(idxs, np.int64)
        oa = np.asarray(orders, np.int64)
        lens = pb.lens[ia]
        top = self.buckets[-1]
        b = np.where(lens < self._tab.shape[0],
                     self._tab[np.minimum(lens, self._tab.shape[0] - 1)],
                     -(-lens // top) * top)
        srt = np.argsort(b, kind="stable")
        bs = b[srt]
        starts = np.flatnonzero(
            np.concatenate([[True], bs[1:] != bs[:-1]]))
        for s, e in zip(starts.tolist(),
                        np.append(starts[1:], bs.size).tolist()):
            bucket = int(bs[s])
            sel = srt[s:e]
            entry = self._pend.get(bucket)
            if entry is None:
                entry = self._pend[bucket] = [[], [], 0]
            entry[0].append((pb, ia[sel]))
            entry[1].append(oa[sel])
            entry[2] += sel.shape[0]
            while entry[2] >= self.batch_size:
                out.append(self._emit(bucket, full_only=True))
        return out

    def flush(self):
        for bucket in sorted(self._pend):
            if self._pend[bucket][2]:
                yield self._emit(bucket, full_only=False)
        self._pend.clear()

    def _emit(self, bucket: int, full_only: bool):
        entry = self._pend[bucket]
        chunks, olist, count = entry
        take = self.batch_size if full_only else count
        entry[2] = count - take
        refs = []
        ords = []
        mats = []
        lens_parts = []
        left = take
        while left:
            pb, idx = chunks[0]
            o = olist[0]
            if idx.shape[0] <= left:
                chunks.pop(0)
                olist.pop(0)
            else:
                chunks[0] = (pb, idx[left:])
                olist[0] = o[left:]
                idx = idx[:left]
                o = o[:left]
            refs.append((pb, idx))
            ords.append(o)
            mats.append(pb.fill_matrix(idx, bucket))
            lens_parts.append(pb.lens[idx])
            left -= idx.shape[0]
        n = self.batch_size if self.pad_batch else take
        mat = np.full((n, bucket), 0xFF, np.uint8)
        mat[:take] = mats[0] if len(mats) == 1 else np.vstack(mats)
        out_lens = np.zeros(n, np.int32)
        out_lens[:take] = np.concatenate(lens_parts)
        orders = ords[0] if len(ords) == 1 else np.concatenate(ords)
        return refs, orders, out_lens, mat
