#!/usr/bin/env python3
"""Time the shape alternatives of two CUDA kernels of the PyTorch port on
one GPU: M1 ``merge_candidates_wire`` (``csrc/merge.cu``: lanes per read,
threads per block) and G1 ``gather_compact`` (``csrc/postings.cu``: rows
in flight per thread, threads per block).

Each alternative is the kernel's source with its shape constants replaced,
built by its own ``nvcc`` (all started together) into a library of its
own.  Every alternative is held bitwise against the wrapper's plain
version, then timed in ``chip_smoke.device_ms``'s harness (a CUDA graph of
20 calls replayed) at the shapes of ``chip_smoke.py``'s main path: M1 at
a mesh row's 4,096 reads of 2 shards x 7 candidates (and 4 x 20, keep
20), G1 on 2 parts of 1,000,000 rows of 8 (and 7) postings, 400,000
unique rows, also with L2 flushed before each call.  The package's own
kernel is timed beside them.  The kernels keep one shape each; this
script records how it was chosen.  Run from the repository root on a machine with the card and
the CUDA toolkit:

    python3 scripts/torch_kernel_shapes.py [--json-out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: source -> the constants each alternative sets (the committed shape is
#: one of them)
VARIANTS = {
    "merge.cu": [{"kGroup": g, "kThreads": t}
                 for g, t in ((8, 128), (16, 128), (32, 128), (16, 256))],
    "postings.cu": [{"kRowsInFlight": r, "kGatherThreads": t}
                    for r, t in ((1, 256), (2, 256), (4, 256), (8, 256),
                                 (4, 128), (4, 512))],
}
ENTRY = {"merge.cu": "rp_merge_candidates",
         "postings.cu": "rp_gather_compact"}


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name}: {n} definitions in the source")
    return text


def build_all(work: Path) -> dict:
    """Every alternative's library, keyed by (source, constants)."""
    from rappas_tpu_torch import _kernels

    nvcc = _kernels._nvcc()
    procs = []
    for src, variants in VARIANTS.items():
        for i, consts in enumerate(variants):
            d = work / f"{src}_{i}"
            shutil.copytree(_kernels.CSRC, d)
            (d / src).write_text(variant_source((d / src).read_text(),
                                                consts))
            so = d / "lib.so"
            procs.append(((src, tuple(consts.items())), so, subprocess.Popen(
                [nvcc, *_kernels.ARCH, *_kernels.FLAGS, "-shared", "-o",
                 str(so), str(d / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for key, so, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, ENTRY[key[0]])
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, i, i, i, i, i, i, i, p, p] if key[0] == "merge.cu"
                       else [p, i, i, p, p, i, p, p])
        fn.restype = i
        libs[key] = fn
    return libs


def merge_inputs(rng, mp: int, B: int, K: int, E: int):
    """Shard wires as P3 writes them: descending scores on a 0.25 grid
    (ties across shards), -inf tails, distinct edges of each range."""
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as T

    bounds = np.linspace(0, E, mp + 1).astype(np.int64)
    stride = (np.diff(bounds) // K)[:, None, None]
    ts = -np.sort(-(rng.integers(0, 40, (mp, B, K)) * 0.25 - 30.0)
                  .astype(np.float32), axis=2)
    ts[np.arange(K) >= rng.integers(0, K + 1, (mp, B))[..., None]] = -np.inf
    te = bounds[:-1, None, None] + np.arange(K) * stride + \
        rng.integers(0, 1 << 30, (mp, B, K)) % stride
    te = np.where(np.isfinite(ts), rng.permuted(te, axis=2), -1)
    nm = rng.integers(0, 50, (mp, B))
    return torch.stack([T.pack_wire(
        torch.from_numpy(te[j].astype(np.int32)), torch.from_numpy(ts[j]),
        None, torch.from_numpy(nm[j].astype(np.int32)))
        for j in range(mp)]).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_shapes: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, device_ms, launch_floor_ms
    from rappas_tpu_torch.place import kernels as T

    card = card_line()
    print(card, flush=True)
    rng = np.random.default_rng(0)
    results = {"card": card, "launch_floor_ms": launch_floor_ms()}
    with tempfile.TemporaryDirectory(prefix="kernel_shapes_") as tmp:
        libs = build_all(Path(tmp))

        def stream():   # the capturing stream while a graph is captured
            return torch.cuda.current_stream().cuda_stream

        # M1 -------------------------------------------------------- #
        for mp, K_in, keep in ((2, 7, 7), (4, 20, 20)):
            wires = merge_inputs(rng, mp, 4096, K_in, 7999)
            B, w_in = wires.shape[1:]
            fields = [T.wire_fields(wires[j], K_in) for j in range(mp)]
            want = T.pack_wire(*T.merge_candidates(
                torch.cat([f[0] for f in fields], 1),
                torch.cat([f[1] for f in fields], 1),
                torch.stack([f[2] for f in fields]), keep))
            out = torch.empty_like(want)
            rows = {}
            for key, fn in libs.items():
                if key[0] != "merge.cu":
                    continue

                def run(fn=fn):
                    err = fn(wires.data_ptr(), mp, B, K_in, w_in, keep,
                             out.shape[1], 0, out.data_ptr(), stream())
                    assert err == 0, err
                out.fill_(0)
                run()
                torch.cuda.synchronize()
                assert torch.equal(out, want), key
                rows[str(dict(key[1]))] = device_ms(run)
            rows["package"] = device_ms(lambda: T.merge_candidates_wire(
                wires, K_in, keep, False))
            results[f"merge_candidates_wire mp={mp} K_in={K_in} keep={keep}"] \
                = rows

        # G1 -------------------------------------------------------- #
        for P in (8, 7):
            tables = tuple(torch.randint(-2 ** 31, 2 ** 31 - 1,
                                         (1_000_000, 2 * P),
                                         dtype=torch.int32, device="cuda")
                           for _ in range(2))
            parts = T.make_parts(tables, [t.shape[0] for t in tables])
            runs = [torch.sort(torch.randperm(t.shape[0], device="cuda")
                               [:200_000])[0].to(torch.int32)
                    for t in tables]
            uniq = torch.cat(runs)
            off = torch.tensor([0, 200_000, 400_000], dtype=torch.int32,
                               device="cuda")
            want = T.gather_compact(tables, tuple(r.long() for r in runs))
            out = torch.empty_like(want)
            rows = {}
            for key, fn in libs.items():
                if key[0] != "postings.cu":
                    continue

                def run(fn=fn):
                    err = fn(parts.meta.data_ptr(), 2, 2 * P,
                             uniq.data_ptr(), off.data_ptr(), uniq.numel(),
                             out.data_ptr(), stream())
                    assert err == 0, err
                out.fill_(0)
                run()
                torch.cuda.synchronize()
                assert torch.equal(out, want), key
                ms = device_ms(run)
                nbytes = uniq.numel() * (4 + 2 * 2 * P * 4) + off.numel() * 4
                rows[str(dict(key[1]))] = {
                    "ms": ms, "tb_s": nbytes / (ms * 1e-3) / 1e12}
            # the package's kernel, warm (the graph's 20 calls re-read the
            # same rows) and with L2 flushed before each call by a 256 MB
            # read (its time subtracted): what L2 hits save
            def package():
                return T.gather_compact_(parts, uniq, off)

            def flush():
                return junk.sum()
            junk = torch.ones(1 << 26, dtype=torch.int32, device="cuda")
            rows["package"] = {
                "ms": device_ms(package),
                "cold_ms": device_ms(lambda: (flush(), package())) -
                device_ms(flush)}
            results[f"gather_compact P={P} U=400000 parts=2"] = rows
    for name, rows in results.items():
        print(f"{name}: {json.dumps(rows)}", flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
