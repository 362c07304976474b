"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at first use, into ``rappas_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by the hash of the sources and the
flags, so a changed source builds anew and an unchanged one loads the
earlier build.

There is no ``--use_fast_math``: it would flush ``DELTA_TINY`` (1e-30, a
normal float32 that marks a matched edge) to zero under ``-ftz`` and
trade ``exp2f``/``log2f`` accuracy for speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
SOURCES = ("accumulate.cu", "finalize.cu", "ambiguous.cu", "postings.cu",
           "merge.cu")
#: headers the sources include (part of the build's hash)
HEADERS = ("parts.cuh", "loads.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _tag() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"kernels_{_tag()}.so"


def build_log() -> str:
    """``nvcc``'s output of the build (``-Xptxas -v``: registers, shared
    memory and spills of every kernel)."""
    return library_path().with_suffix(".log").read_text()


def build() -> Path:
    """Compile and link the kernels unless a build of these sources
    exists; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    # a directory per process: concurrent builds never share files
    tmp = BUILD / f"tmp_{out.stem}_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = tmp / f"{name}.o"
        procs.append((name, obj, subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for name, _, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {name}\n{text}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise KernelBuildError(f"nvcc failed on {', '.join(failed)}:\n" +
                               "\n".join(logs))
    so = tmp / "kernels.so"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(so),
                           *(str(obj) for _, obj, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise KernelBuildError(f"linking the kernels failed:\n"
                               f"{link.stdout}{link.stderr}")
    log_path = out.with_suffix(".log")
    (tmp / "build.log").write_text("\n".join(logs))
    os.replace(tmp / "build.log", log_path)
    os.replace(so, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)
            sigs = {
                "rp_accumulate_packed": [p, i, i, i, p, i64, p, i, i, i, f,
                                         p, p, i, i, i, i, i, p],
                "rp_accumulate_codes": [p, i, i, i, p, i, i, i, i, f, p, p,
                                        i, i, i, i, i, p],
                "rp_accumulate_compact": [p, i, i, p, i, p, i, i, i, i, f,
                                          p, p, i, i, i, i, i, p],
                "rp_accumulate_rows": [p, i, i, i, p, i, i, f, p, i, i, i,
                                       i, i, p],
                "rp_accumulate_rows_range": [p, i, p, i, i, i, i, p, i, i, i,
                                             i, i, p],
                "rp_finalize_wire": [p, i, i, p, f, i, i, i, i, p, p],
                "rp_ambiguous_pass": [p, i, i, f, p, p, p, p, p, i, p, i, i,
                                      p],
                "rp_dense_side": [p, i, p, p, i, p, p],
                "rp_ambiguous_postings": [p, i, i, p, i, p, p, p, p, p, p,
                                          i, i, p, p],
                "rp_finalize_postings": [p, i, i, p, i, i, p, i, p, p, f, i,
                                         i, i, i, p, p, p, p, i, i, i, i, p,
                                         p],
                "rp_merge_candidates": [p, i, i, i, i, i, i, i, p, p],
                "rp_finalize_postings_split": [i, p, i, i, i, p, i, i, p, i,
                                               p, p, f, i, i, i, i, p, p, p,
                                               p, i, i, i, i, p, p],
                "rp_gather_compact": [p, i, i, p, p, i, p, p],
                "rp_routed_accumulate": [p, i, i, i, p, i, i, f, p, i, i, p],
                "rp_ambiguous_pass_split": [p, i, i, i, f, p, p, p, p, p, i,
                                            p, i, i, p],
                "rp_ambiguous_postings_parts": [p, i, i, p, i, i, p, p, p, p,
                                                p, p, i, p, p],
            }
            for name, argtypes in sigs.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.rp_error_string.argtypes = [ctypes.c_int]
            handle.rp_error_string.restype = ctypes.c_char_p
            _LIB = handle
        return _LIB
