"""Native (C++) host components, compiled on demand with g++.

These are the host-side hot loops of the placement path and the DB
build (the reference's equivalents are its Java inner loops):

* ``ingest.cpp`` -- FASTA block parse, md5 dedup keys, padded matrix
  fill and the md5 -> first-occurrence map;
* ``jplacefmt.cpp`` -- jplace ``"p"`` rows, whole placement lines and
  TSV report lines, formatted per batch;
* ``keyprobe.cpp`` -- fused rolling-hash k-mer indexing and the
  postings layout's row lookup (a bucketed sorted-key probe when the
  k-mer space is too big for a direct index, protein k >= 8, else the
  direct index), packing each read's light rows in the same sweep;
* ``wordexplorer.cpp`` -- exact branch-and-bound phylo-kmer enumeration
  incl. gap jumps (bit-identical f32 semantics to the reference
  recursion), used by the DB build where the vectorized numpy frontier
  doesn't apply; parallelised over ghost nodes from Python threads
  (ctypes releases the GIL).

Each library is built at first use into ``rappas_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by the hash of its source; no network
or pip involved.  g++ is required: the placement path and the DB build
call these libraries with no Python fallback, and a host that cannot
build one gets :class:`NativeUnavailable` from :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from rappas_tpu_torch.utils import count

_DIR = Path(__file__).parent
_BUILD = _DIR.parent / "_build"
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    """A native library could not be built (no g++, or a compile error)."""


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
    # note: no -ffast-math -- float formatting and the explorer's f32
    # sums must stay IEEE-exact
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(
            f"could not build {src} with g++: "
            f"{e.stderr.decode(errors='replace')}") from e
    except FileNotFoundError as e:
        raise NativeUnavailable(
            f"could not build {src}: g++ is required ({e})") from e
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
    rows are ``text[out_off[i]:out_off[i+1]]``.
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
# fused k-mer index + key probe (protein big-key-space host path)
# ------------------------------------------------------------------ #

def _kp_lib() -> ctypes.CDLL:
    lib = load("keyprobe")
    if not getattr(lib, "_kp_configured", False):
        c = ctypes
        lib.kp_rows.restype = None
        lib.kp_rows.argtypes = [
            c.c_void_p, c.c_void_p, c.c_longlong, c.c_longlong,
            c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_longlong,
            c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_int,
            c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p]
        lib._kp_configured = True
    return lib


def _ptr(a) -> int | None:
    return None if a is None else a.ctypes.data


def _kp_rows(codes, lengths, k, n_states, miss, n_threads, keys=None,
             vals=None, lo=None, shift=0, direct=None, light=None):
    lib = _kp_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if direct is None:
        keys = np.ascontiguousarray(keys, np.int64)
        vals = np.ascontiguousarray(vals, np.int32)
        lo = np.ascontiguousarray(lo, np.int32)
    else:
        direct = np.ascontiguousarray(direct, np.int32)
    B, L = codes.shape
    Q = max(L - k + 1, 0)
    out = np.empty((B, Q), np.int32)
    nl, counts, packed = 0, None, (None, None, None, None)
    if light is not None:
        nl, counts = light
        counts = np.ascontiguousarray(counts, np.int32)
        packed = (np.empty((B, Q), np.int32), np.zeros(B, np.int32),
                  np.zeros(B, np.int64), np.zeros(1, np.int64))
    if Q:
        if n_threads <= 0:
            n_threads = min(4, os.cpu_count() or 1)
        lib.kp_rows(codes.ctypes.data, lengths.ctypes.data, B, L, k,
                    n_states, _ptr(keys), _ptr(vals),
                    0 if keys is None else keys.shape[0], _ptr(lo), shift,
                    miss, out.ctypes.data, n_threads, _ptr(direct), nl,
                    _ptr(counts), *map(_ptr, packed))
        # calls of the native row sweep (a run can show which row lookup
        # it took)
        count("native.probe_rows")
    return (out,) + packed


def probe_rows(codes: np.ndarray, lengths: np.ndarray, k: int,
               n_states: int, keys: np.ndarray, vals: np.ndarray,
               lo: np.ndarray, shift: int, miss: int,
               n_threads: int = 0) -> np.ndarray:
    """Fused rolling-hash k-mer indexing + bucketed key probe: one
    native sweep replaces the numpy Horner + HostKeyIndex passes.
    ``keys``/``vals``/``lo``/``shift`` follow the HostKeyIndex layout;
    returns int32 [B, Q] encoded rows (``miss`` for absent/ambiguous/
    past-length windows)."""
    return _kp_rows(codes, lengths, k, n_states, miss, n_threads, keys,
                    vals, lo, shift)[0]


def probe_light_rows(codes: np.ndarray, lengths: np.ndarray, k: int,
                     n_states: int, nl: int, light_counts: np.ndarray,
                     keys=None, vals=None, lo=None, shift: int = 0,
                     direct=None, n_threads: int = 0):
    """The postings layout's rows of a batch in one native sweep (the
    GIL released): :func:`probe_rows` over the keys, or ``direct[v]``
    for a direct index table ``direct`` int32[S^k + 1] (its last entry
    the miss), and each read's light rows (``r < nl``) with them.
    Returns ``(rof, lrows, hits, pairs, n_heavy)``: the encoded rows
    int32[B, Q]; the light rows left-packed in window order with ``nl``
    pads, int32[B, Q]; their count per read, int32[B]; their real
    postings per read (``light_counts[r]`` summed), int64[B]; and the
    batch's windows on heavy rows (``r > nl``)."""
    miss = nl if direct is None else int(direct[-1])
    *rows, n_heavy = _kp_rows(codes, lengths, k, n_states, miss, n_threads,
                              keys, vals, lo, shift, direct,
                              (nl, light_counts))
    return (*rows, int(n_heavy[0]))


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
    md5 dedup keys, all in native code."""
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


# ------------------------------------------------------------------ #
# wordexplorer wrapper
# ------------------------------------------------------------------ #

def _we_lib() -> ctypes.CDLL:
    lib = load("wordexplorer")
    if not getattr(lib, "_we_configured", False):
        c = ctypes
        lib.we_explore.restype = c.c_void_p
        lib.we_explore.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_float,
            c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int]
        lib.we_count.restype = c.c_int64
        lib.we_count.argtypes = [c.c_void_p]
        lib.we_codes.restype = c.POINTER(c.c_int64)
        lib.we_codes.argtypes = [c.c_void_p]
        lib.we_sums.restype = c.POINTER(c.c_float)
        lib.we_sums.argtypes = [c.c_void_p]
        lib.we_free.argtypes = [c.c_void_p]
        lib._we_configured = True
    return lib


def gap_intervals_csr(gap_intervals: dict | None, n_cols: int):
    """dict(col -> [lengths]) -> CSR (offsets int32[n_cols+1], lens)."""
    offsets = np.zeros(n_cols + 1, np.int32)
    lens: list[int] = []
    gi = gap_intervals or {}
    for c in range(n_cols):
        offsets[c] = len(lens)
        lens.extend(gi.get(c, ()))
    offsets[n_cols] = len(lens)
    return offsets, np.array(lens, np.int32)


def explore_node_exact_native(states_sorted: np.ndarray,
                              pp_sorted: np.ndarray, k: int, thr,
                              gap_intervals: dict | None = None,
                              do_gap_jumps: bool = False,
                              limit_to_1_jump: bool = True):
    """Drop-in native replacement for
    ``rappas_tpu_torch.build.explorer.explore_node_exact``."""
    lib = _we_lib()
    st = np.ascontiguousarray(states_sorted, np.int8)
    pp = np.ascontiguousarray(pp_sorted, np.float32)
    L, S = pp.shape
    offsets, lens = gap_intervals_csr(gap_intervals, L)
    handle = lib.we_explore(
        st.ctypes.data, pp.ctypes.data, L, S, k,
        np.float32(thr),
        offsets.ctypes.data, lens.ctypes.data, L,
        1 if do_gap_jumps else 0, 1 if limit_to_1_jump else 0)
    try:
        n = lib.we_count(handle)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        codes = np.ctypeslib.as_array(lib.we_codes(handle),
                                      (n,)).copy()
        sums = np.ctypeslib.as_array(lib.we_sums(handle), (n,)).copy()
    finally:
        lib.we_free(handle)
    return codes.astype(np.int64), sums.astype(np.float32)
