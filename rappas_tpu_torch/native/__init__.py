"""Native (C++) host components, compiled on demand with g++.

These are the host-side hot loops of the placement path (the
reference's equivalents are its Java inner loops):

* ``ingest.cpp`` -- FASTA block parse, md5 dedup keys, padded matrix
  fill and the md5 -> first-occurrence map;
* ``jplacefmt.cpp`` -- jplace ``"p"`` rows, whole placement lines and
  TSV report lines, formatted per batch.

Each library is built at first use into ``rappas_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by the hash of its source; no network
or pip involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_BUILD = _DIR.parent / "_build"
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    pass


def _build(name: str) -> Path:
    src = _DIR / f"{name}.cpp"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"_{name}_{tag}.so"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    # build under a per-process name and rename: concurrent test workers
    # may build the same library at once
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # note: no -ffast-math -- float formatting must stay IEEE-exact
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"")
        raise NativeUnavailable(
            f"could not build {name}: {detail!r}") from e
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib


# ------------------------------------------------------------------ #
# jplace row formatter wrapper
# ------------------------------------------------------------------ #

def _jp_lib() -> ctypes.CDLL:
    lib = load("jplacefmt")
    if not getattr(lib, "_jp_configured", False):
        c = ctypes
        lib.jp_format_rows.restype = c.c_longlong
        lib.jp_format_rows.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int, c.c_void_p, c.c_int64, c.c_void_p]
        lib.jp_format_lines.restype = c.c_longlong
        lib.jp_format_lines.argtypes = [
            c.c_char_p, c.c_void_p, c.c_char_p, c.c_void_p,
            c.c_void_p, c.c_char_p, c.c_void_p,
            c.c_longlong, c.c_void_p, c.c_longlong, c.c_void_p]
        lib.jp_format_tsv.restype = c.c_longlong
        lib.jp_format_tsv.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_longlong, c.c_char_p, c.c_void_p,
            c.c_void_p, c.c_longlong]
        lib._jp_configured = True
    return lib


def gather_ranges(buf: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray):
    """Concatenate ``buf[starts[i]:ends[i]]`` slices, fully vectorized.

    Returns ``(blob uint8[total], off int64[n+1])``.  The workhorse of
    the array-level header plumbing (round 5): batches carry header
    BYTES + offsets instead of per-read python strings."""
    lens = (ends - starts).astype(np.int64)
    off = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    tot = int(off[-1])
    pos = np.repeat(starts.astype(np.int64) - off[:-1], lens) + \
        np.arange(tot, dtype=np.int64)
    return buf[pos], off


def format_tsv_rows(hdr_blob: np.ndarray, hdr_off: np.ndarray,
                    best: np.ndarray, scores: np.ndarray,
                    lbl_buf: bytes, lbl_off: np.ndarray) -> bytes:
    """Format a batch's TSV report lines in one native call (qname =
    header up to the first space; ``lbl_buf``/``lbl_off`` index node
    labels by id).  Trailing newline included per line."""
    lib = _jp_lib()
    n = hdr_off.shape[0] - 1
    hdr_blob = np.ascontiguousarray(hdr_blob, np.uint8)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    best = np.ascontiguousarray(best, np.int32)
    scores = np.ascontiguousarray(scores, np.float32)
    lbl_off = np.ascontiguousarray(lbl_off, np.int32)
    cap = int(hdr_blob.shape[0]) + 96 * max(n, 1) + len(lbl_buf)
    while True:
        buf = ctypes.create_string_buffer(cap)
        written = lib.jp_format_tsv(
            hdr_blob.ctypes.data, hdr_off.ctypes.data,
            best.ctypes.data, scores.ctypes.data, n,
            lbl_buf, lbl_off.ctypes.data, buf, cap)
        if written >= 0:
            return buf.raw[:written]
        cap *= 2


def format_placement_lines(rows_blob: bytes, rows_off: np.ndarray,
                           hdr_blob: bytes, hdr_off: np.ndarray,
                           extra_cnt: np.ndarray | None = None,
                           ex_blob: bytes = b"",
                           ex_off: np.ndarray | None = None):
    """Assemble a batch's full ``{"p":[...],"nm":[["h",1],...]}`` lines
    in one native call.  ``extra_cnt``/``ex_blob``/``ex_off`` optionally
    carry duplicate-read "nm" sub-headers, flattened in placement order
    (round 5).  Returns ``(blob bytes, out_off int64[n+1])``."""
    lib = _jp_lib()
    n = rows_off.shape[0] - 1
    rows_off = np.ascontiguousarray(rows_off, np.int64)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    if extra_cnt is not None:
        extra_cnt = np.ascontiguousarray(extra_cnt, np.int32)
        ex_off = np.ascontiguousarray(ex_off, np.int64)
        ecnt_ptr = extra_cnt.ctypes.data
        ex_off_ptr = ex_off.ctypes.data
    else:
        ecnt_ptr = None
        ex_off_ptr = None
    out_off = np.empty(n + 1, np.int64)
    cap = (len(rows_blob) + 2 * len(hdr_blob) + 2 * len(ex_blob) +
           48 * max(n, 1))
    while True:
        buf = ctypes.create_string_buffer(cap)
        written = lib.jp_format_lines(
            rows_blob, rows_off.ctypes.data, hdr_blob,
            hdr_off.ctypes.data, ecnt_ptr, ex_blob, ex_off_ptr,
            n, buf, cap, out_off.ctypes.data)
        if written >= 0:
            return buf.raw[:written], out_off
        cap *= 2


def format_placement_rows(nodes: np.ndarray, scores: np.ndarray,
                          lwr: np.ndarray, row_off: np.ndarray,
                          estr_buf: bytes, estr_off: np.ndarray,
                          dstr_buf: bytes, dstr_off: np.ndarray,
                          guppy: bool):
    """Format a batch of jplace ``"p"`` row lists in one native call.

    Returns ``(text bytes, out_off int64[n+1])`` where placement ``i``'s
    rows are ``text[out_off[i]:out_off[i+1]]``.  Raises
    :class:`NativeUnavailable` when the toolchain is missing (callers
    fall back to the python formatter).
    """
    lib = _jp_lib()
    n = row_off.shape[0] - 1
    nodes = np.ascontiguousarray(nodes, np.int32)
    scores = np.ascontiguousarray(scores, np.float32)
    lwr = np.ascontiguousarray(lwr, np.float32)
    row_off = np.ascontiguousarray(row_off, np.int64)
    estr_off = np.ascontiguousarray(estr_off, np.int32)
    dstr_off = np.ascontiguousarray(dstr_off, np.int32)
    out_off = np.empty(n + 1, np.int64)
    cap = int(nodes.shape[0]) * 96 + 64
    while True:
        buf = ctypes.create_string_buffer(cap)
        written = lib.jp_format_rows(
            nodes.ctypes.data, scores.ctypes.data, lwr.ctypes.data,
            row_off.ctypes.data, n,
            estr_buf, estr_off.ctypes.data,
            dstr_buf, dstr_off.ctypes.data,
            1 if guppy else 0, buf, cap, out_off.ctypes.data)
        if written >= 0:
            return buf.raw[:written], out_off
        cap *= 2


# ------------------------------------------------------------------ #
# read-ingest wrapper (FASTA block parse + md5 dedup keys + matrix fill)
# ------------------------------------------------------------------ #

def _ig_lib() -> ctypes.CDLL:
    lib = load("ingest")
    if not getattr(lib, "_ig_configured", False):
        c = ctypes
        lib.ig_count.restype = c.c_longlong
        lib.ig_count.argtypes = [c.c_char_p, c.c_longlong]
        lib.ig_parse.restype = c.c_longlong
        lib.ig_parse.argtypes = [c.c_char_p, c.c_longlong, c.c_void_p,
                                 c.c_void_p, c.c_void_p, c.c_void_p,
                                 c.c_longlong]
        lib.ig_md5.argtypes = [c.c_void_p, c.c_void_p, c.c_longlong,
                               c.c_void_p]
        lib.ig_fill.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                c.c_longlong, c.c_longlong, c.c_void_p]
        lib.dd_new.restype = c.c_void_p
        lib.dd_free.argtypes = [c.c_void_p]
        lib.dd_lookup.argtypes = [c.c_void_p, c.c_void_p, c.c_longlong,
                                  c.c_void_p, c.c_void_p]
        lib._ig_configured = True
    return lib


class ParsedBlock:
    """One FASTA block parsed natively: compacted header/sequence byte
    buffers with int64 offsets and the per-record 16-byte md5 dedup keys
    ('-' stripped, ``Fasta.java:34-39`` semantics).  Headers materialize
    lazily (only reads that reach an output path need a python str)."""

    __slots__ = ("n", "hdr_buf", "hdr_off", "seq_buf", "seq_off",
                 "lens", "md5s")

    def __init__(self, n, hdr_buf, hdr_off, seq_buf, seq_off, md5s):
        self.n = n
        self.hdr_buf = hdr_buf
        self.hdr_off = hdr_off
        self.seq_buf = seq_buf
        self.seq_off = seq_off
        self.lens = np.diff(seq_off).astype(np.int64)
        self.md5s = md5s

    def header(self, i: int) -> str:
        return self.hdr_buf[self.hdr_off[i]:self.hdr_off[i + 1]] \
            .tobytes().decode("utf-8", "replace")

    def sequence(self, i: int) -> bytes:
        return self.seq_buf[self.seq_off[i]:self.seq_off[i + 1]] \
            .tobytes()

    def fill_matrix(self, idx: np.ndarray, L: int) -> np.ndarray:
        """Padded uint8 matrix of the selected records (pad 0xFF)."""
        lib = _ig_lib()
        idx = np.ascontiguousarray(idx, np.int64)
        mat = np.empty((idx.shape[0], L), np.uint8)
        lib.ig_fill(self.seq_buf.ctypes.data, self.seq_off.ctypes.data,
                    idx.ctypes.data, idx.shape[0], L, mat.ctypes.data)
        return mat


def parse_fasta_block(data: bytes) -> ParsedBlock:
    """Parse one byte block of complete FASTA records and compute the
    md5 dedup keys, all in native code.  Raises
    :class:`NativeUnavailable` when the toolchain is missing."""
    lib = _ig_lib()
    n = len(data)
    nrec = lib.ig_count(data, n)
    hdr_buf = np.empty(n, np.uint8)
    seq_buf = np.empty(n, np.uint8)
    hdr_off = np.empty(nrec + 1, np.int64)
    seq_off = np.empty(nrec + 1, np.int64)
    got = lib.ig_parse(data, n, hdr_buf.ctypes.data, hdr_off.ctypes.data,
                       seq_buf.ctypes.data, seq_off.ctypes.data, nrec)
    if got < 0:
        raise ValueError("FASTA block overflow (malformed input)")
    md5s = np.empty((got, 16), np.uint8)
    lib.ig_md5(seq_buf.ctypes.data, seq_off.ctypes.data, got,
               md5s.ctypes.data)
    return ParsedBlock(int(got), hdr_buf, hdr_off, seq_buf,
                       seq_off[:got + 1], md5s)


class NativeDedup:
    """md5-digest -> first-occurrence-order map held in C++ (the python
    dict walk was the last per-read host cost of the placement loop).

    ``dedup(md5s[n,16], orders[n]) -> first[n]`` where ``first[i]`` is
    -1 for a first occurrence (the digest is registered with
    ``orders[i]``) or the registered first order for a duplicate."""

    def __init__(self):
        self._lib = _ig_lib()
        self._st = self._lib.dd_new()

    def __call__(self, md5s: np.ndarray, orders: np.ndarray) -> np.ndarray:
        md5s = np.ascontiguousarray(md5s, np.uint8)
        orders = np.ascontiguousarray(orders, np.int64)
        n = orders.shape[0]
        out = np.empty(n, np.int64)
        self._lib.dd_lookup(self._st, md5s.ctypes.data, n,
                            orders.ctypes.data, out.ctypes.data)
        return out

    def __del__(self):
        try:
            self._lib.dd_free(self._st)
        except Exception:
            pass
