#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rappas_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--cli-reads 100000] [--json-out F]

It needs one card, builds the CUDA kernels from ``rappas_tpu_torch/csrc``
(into ``rappas_tpu_torch/_build/``) and drives ``-p p`` placement at the
width of BASELINE config 1 (k=8, E=300 edge slots, a direct table
``D[4^8 + 1, 300]`` f32 of 79 MB, 150 bp reads) on a DB made from the
seed:

1. kernel phase -- every kernel of the path (K1 accumulate_packed, K2
   accumulate_codes, K3 finalize_wire, K4 ambiguous_pass) at B=16384
   against its plain PyTorch version on the card, with CUDA-event times
   beside the plain version's, one library call's where PyTorch has one,
   and the least time the card could take (its bound);
2. engine phase -- 20 batches of 16384 reads (1% carry one N) through
   ``PlacementEngine.score_async``; every kernel must launch; 512 reads
   are held against the same engine on the CPU;
3. CLI phase -- ``python -m rappas_tpu_torch.cli -p p`` on 100k reads with
   duplicates and N's; the jplace is parsed and its placements held
   against the CPU engine.

Standard output ends with the card's name and power limit, one JSON line
of kernel results and one JSON line ``{"ok": true, "device": ...}``.  Any
failure exits non-zero without that last line; so does a machine with no
CUDA device, or a directory without the ``rappas_tpu_torch`` package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor f32 peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

B_KERNEL = 16384
READ_LEN = 150
K_KEEP = 7


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def config1_db(seed: int):
    """BASELINE config 1 widths from the seed (``bench.py:60-84``'s
    recipe): k=8, 300 edge slots, 60% of the 4^8 k-mers present with 5
    postings each, deltas uniform in (0, 2.5]."""
    import numpy as np

    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    k, n_edges, per_kmer, occupancy = 8, 300, 5, 0.6
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.1" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    n_keys = int(4 ** k * occupancy)
    codes = rng.choice(4 ** k, size=n_keys, replace=False).astype(np.int64)
    codes = np.repeat(codes, per_kmer)
    edges = rng.integers(1, n_edges, codes.size).astype(np.int32)
    scores = (thr + rng.random(codes.size) * 2.5).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


def random_reads(rng, n: int, n_ambiguous: int, short_share: float = 0.0):
    """ASCII reads uint8[n, READ_LEN] (0xFF padded) and lengths;
    ``n_ambiguous`` random reads carry one N; a ``short_share`` of the
    reads is cut to 120..149 bp."""
    import numpy as np

    mat = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n, READ_LEN))].copy()
    lens = np.full(n, READ_LEN, np.int32)
    short = np.flatnonzero(rng.random(n) < short_share)
    lens[short] = rng.integers(120, READ_LEN, short.size)
    for i, ln in zip(short, lens[short]):
        mat[i, ln:] = 0xFF
    amb = rng.choice(n, n_ambiguous, replace=False)
    mat[amb, (rng.random(n_ambiguous) * lens[amb]).astype(np.int64)] = \
        ord("N")
    return mat, lens


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_placements(a, b, tol_score=2e-4, tol_lwr=1e-4) -> str | None:
    """None when two BatchResults agree (|L| exact, edge sets exact apart
    from near-ties at the K-th slot, scores and LWR within tolerance),
    else a description of the first difference."""
    import numpy as np

    if not np.array_equal(a.n_matched, b.n_matched):
        i = int(np.flatnonzero(a.n_matched != b.n_matched)[0])
        return f"read {i}: |L| {a.n_matched[i]} vs {b.n_matched[i]}"
    for i in range(a.n_matched.shape[0]):
        va, vb = a.top_edges[i] >= 0, b.top_edges[i] >= 0
        if va.sum() != vb.sum():
            return f"read {i}: {va.sum()} vs {vb.sum()} valid slots"
        sa, sb = a.top_scores[i][va], b.top_scores[i][vb]
        if not np.allclose(sa, sb, atol=tol_score, rtol=0):
            return f"read {i}: scores {sa} vs {sb}"
        ea, eb = set(a.top_edges[i][va]), set(b.top_edges[i][vb])
        if ea != eb and abs(float(sa[-1]) - float(sb[-1])) > tol_score:
            return f"read {i}: edges {sorted(ea)} vs {sorted(eb)}"
        if ea == eb:
            la = dict(zip(a.top_edges[i][va], a.top_lwr[i][va]))
            lb = dict(zip(b.top_edges[i][vb], b.top_lwr[i][vb]))
            if any(abs(float(la[e]) - float(lb[e])) > tol_lwr for e in ea):
                return f"read {i}: LWR differs"
    return None


# ---------------------------------------------------------------------- #
def kernel_phase(db, seed: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from rappas_tpu_torch.convert import device_tables
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (PlacementEngine, pack_reads,
                                               window_offsets)

    dev = torch.device(device)
    D, scale_t, thr_t = device_tables(db, dev)
    scale, thr = float(scale_t), float(thr_t)
    E = D.shape[1]
    k = db.k
    miss = D.shape[0] - 1
    rng = np.random.default_rng(seed + 1)
    host = PlacementEngine(db, device="cpu")   # host codec + expansion
    mat, lens = random_reads(rng, B_KERNEL, B_KERNEL // 100)
    codes = host.encode_batch(mat)
    pure_mat, _ = random_reads(rng, B_KERNEL, 0)
    packed = torch.from_numpy(pack_reads(host.encode_batch(pure_mat))).to(dev)
    codes_d = torch.from_numpy(codes).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    out = {}

    # K1 ------------------------------------------------------------ #
    rows1 = K.kmer_rows_packed(packed, lens_d, k, 4, D.shape[0], READ_LEN)
    got = K.accumulate_packed(D, packed, lens_d, READ_LEN, k, scale)
    want = K.accumulate(D, rows1) * scale
    torch.cuda.synchronize()
    err1 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"K1 accumulate_packed disagrees with its plain version "
          f"(max abs err {err1})")
    rows1_long = rows1.long()
    touched = torch.unique(rows1[rows1 != miss])
    n_win = int((rows1 != miss).sum())
    b, why = bound(packed.numel() + lens_d.numel() * 4 +
                   touched.numel() * E * 4 + B_KERNEL * E * 4,
                   (n_win + B_KERNEL) * E)
    out["accumulate_packed"] = dict(
        max_abs_err=err1, bound_ms=b, bound_by=why,
        ms=cuda_ms(lambda: K.accumulate_packed(D, packed, lens_d, READ_LEN,
                                               k, scale, acc=got)),
        plain_ms=cuda_ms(lambda: K.accumulate(D, K.kmer_rows_packed(
            packed, lens_d, k, 4, D.shape[0], READ_LEN)) * scale, reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows1_long, D, mode="sum")))
    acc_pure = got

    # K2 ------------------------------------------------------------ #
    rows2 = K.kmer_rows(codes_d, k, 4, D.shape[0])
    got = K.accumulate_codes(D, codes_d, k, 4, scale)
    want = K.accumulate(D, rows2) * scale
    torch.cuda.synchronize()
    err2 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"K2 accumulate_codes disagrees with its plain version "
          f"(max abs err {err2})")
    rows2_long = rows2.long()
    touched = torch.unique(rows2[rows2 != miss])
    n_win = int((rows2 != miss).sum())
    b, why = bound(codes_d.numel() + touched.numel() * E * 4 +
                   B_KERNEL * E * 4, (n_win + B_KERNEL) * E)
    out["accumulate_codes"] = dict(
        max_abs_err=err2, bound_ms=b, bound_by=why,
        ms=cuda_ms(lambda: K.accumulate_codes(D, codes_d, k, 4, scale,
                                              acc=got)),
        plain_ms=cuda_ms(lambda: K.accumulate(D, K.kmer_rows(
            codes_d, k, 4, D.shape[0])) * scale, reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows2_long, D, mode="sum")))
    acc_amb = got

    # K3 ------------------------------------------------------------ #
    got = K.finalize_wire(acc_pure, lens_d, thr, k, K_KEEP)
    te, ts, lwr, nm = K.finalize(acc_pure, lens_d, thr_t, k, K_KEEP)
    want = K.pack_wire(te, ts, lwr, nm)
    torch.cuda.synchronize()
    g_nm, w_nm = got[:, -1], want[:, -1]
    check(torch.equal(g_nm, w_nm), "K3 finalize_wire: |L| differs")
    g_s = got[:, :K_KEEP].view(torch.float32)
    fin = torch.isfinite(ts)
    err3 = float((g_s - ts)[fin].abs().max()) if bool(fin.any()) else 0.0
    same_bits = torch.equal(got[:, :K_KEEP], want[:, :K_KEEP])
    # edges must agree exactly where the score bits do (no tie reordering)
    check(same_bits and torch.equal(got, want),
          f"K3 finalize_wire: wire words differ from the plain version "
          f"(scores bitwise equal: {same_bits}, max abs err {err3})")
    Qs = (lens_d - (k - 1)).to(torch.float32)[:, None] * thr_t
    masked = torch.where(acc_pure > 0, Qs + acc_pure,
                         torch.full_like(acc_pure, float("-inf")))
    b, why = bound(acc_pure.numel() * 4 + lens_d.numel() * 4 +
                   got.numel() * 4, 3 * acc_pure.numel())
    out["finalize_wire"] = dict(
        max_abs_err=err3, bound_ms=b, bound_by=why,
        ms=cuda_ms(lambda: K.finalize_wire(acc_pure, lens_d, thr, k,
                                           K_KEEP)),
        plain_ms=cuda_ms(lambda: K.pack_wire(*K.finalize(
            acc_pure, lens_d, thr_t, k, K_KEEP))),
        library_ms=cuda_ms(lambda: torch.topk(masked, K_KEEP, dim=1)))

    # K4 ------------------------------------------------------------ #
    errs = []
    for with_max in (False, True):
        host.ambiguities_with_max = with_max
        kidx, alt_win, win_read, inv_w, is_mean = \
            host._expand_ambiguities_host(codes, mat, lens)
        spec = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            kidx.astype(np.int32), window_offsets(alt_win, win_read.size),
            win_read.astype(np.int32), inv_w.astype(np.float32),
            is_mean.astype(np.uint8))]
        alt_win_d = torch.from_numpy(alt_win.astype(np.int64)).to(dev)
        got = K.ambiguous_pass_(acc_amb.clone(), D, scale, *spec)
        want = K.ambiguous_pass(K.alt_delta_rows(D, scale, spec[0]),
                                alt_win_d, spec[2], spec[3], spec[4],
                                acc_amb)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(errs[-1] <= 2e-4, f"K4 ambiguous_pass (max mode {with_max}) "
              f"disagrees with its plain version (max abs err {errs[-1]})")
        check(torch.equal(got > 0, want > 0),
              "K4 ambiguous_pass: matched edges differ")
        if not with_max:
            mean_spec, mean_alt_win = spec, alt_win_d
    alt_rows, win_off, win_read_d, inv_w_d, is_mean_d = mean_spec
    n_alt, n_w = alt_rows.numel(), win_read_d.numel()
    reads_touched = torch.unique(win_read_d).numel()
    b, why = bound(torch.unique(alt_rows).numel() * E * 4 + n_alt * 4 +
                   n_w * 13 + 4 + 2 * reads_touched * E * 4,
                   (n_alt + n_w) * E * 4)
    scratch = acc_amb.clone()
    out["ambiguous_pass"] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why,
        ms=cuda_ms(lambda: K.ambiguous_pass_(scratch, D, scale,
                                             *mean_spec)),
        plain_ms=cuda_ms(lambda: K.ambiguous_pass(
            K.alt_delta_rows(D, scale, alt_rows), mean_alt_win, win_read_d,
            inv_w_d, is_mean_d, acc_amb)),
        library_ms=None, windows=n_w, alternatives=n_alt)
    return out


def engine_phase(db, seed: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine, pack_reads

    rng = np.random.default_rng(seed + 2)
    n_batches = 20
    batches = [random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05)
               for _ in range(n_batches)]
    eng = PlacementEngine(db, device=device)
    eng.score(*batches[0])                    # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    pend, results = [], []
    issue_s = 0.0      # host time inside score_async: encode, pack,
    for mat, lens in batches:      # expand, stage, enqueue
        t1 = time.perf_counter()
        pend.append(eng.score_async(mat, lens))
        issue_s += time.perf_counter() - t1
        if len(pend) > 3:
            results.append(pend.pop(0).result())
    results.extend(p.result() for p in pend)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"engine phase: kernel {name} was never launched")
    # host side of score_async on one batch, step by step
    mat, lens = batches[1]
    steps = {}
    t1 = time.perf_counter()
    codes = eng.encode_batch(mat)
    steps["encode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    coded = ((codes < 0) & (np.arange(mat.shape[1])[None, :] <
                            lens[:, None])).any(axis=1)
    sel = np.flatnonzero(~coded)
    pack_reads(codes[sel])
    codes[np.flatnonzero(coded)]
    steps["split_and_pack"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    eng._expand_ambiguities_host(codes, mat, lens)
    steps["ambiguity_expansion"] = time.perf_counter() - t1
    cpu = PlacementEngine(db, device="cpu")
    mat, lens = batches[0]
    ref = cpu.score(mat[:512], lens[:512])
    r0 = results[0]
    sub = type(r0)(*(x[:512] for x in r0))
    diff = same_placements(sub, ref)
    check(diff is None, f"engine phase: card vs CPU engine: {diff}")
    return {"reads_per_s": n_batches * B_KERNEL / dt, "seconds": dt,
            "score_async_s": issue_s, "host_steps_s": steps,
            "batches": n_batches,
            "batch_size": B_KERNEL, "launches": launches}


def cli_phase(db, db_path: Path, work: Path, n_reads: int, seed: int,
              device: str = "cuda") -> dict:
    import numpy as np

    from rappas_tpu_torch import cli
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine

    rng = np.random.default_rng(seed + 3)
    n_unique = n_reads - n_reads // 10
    mat, lens = random_reads(rng, n_unique, n_unique // 100, 0.05)
    src = np.concatenate([np.arange(n_unique),
                          rng.integers(0, n_unique, n_reads - n_unique)])
    fasta = work / "reads.fasta"
    with open(fasta, "wb") as f:
        for i, s in enumerate(src.tolist()):
            f.write(b">r%d src=%d\n" % (i, s) +
                    mat[s, :lens[s]].tobytes() + b"\n")
    wd = work / "cli"
    K.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-p", "p", "-d", str(db_path), "-q", str(fasta),
                   "-w", str(wd), "--device", device])
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(rc == 0, f"CLI exited with {rc}")
    for name, n in launches.items():
        check(n > 0, f"CLI phase: kernel {name} was never launched")

    jp = json.loads((wd / "placements_reads.fasta.jplace").read_text())
    check(jp["version"] == 3 and jp["fields"] == [
        "edge_num", "likelihood", "like_weight_ratio", "distal_length",
        "pendant_length"], "jplace header")
    n_named = sum(len(p["nm"]) for p in jp["placements"])
    unplaced = (wd / "logs" / "notplaced_reads.fasta.tsv").read_text()
    n_unplaced = len(unplaced.splitlines())
    check(n_named + n_unplaced == n_reads,
          f"jplace names {n_named} + unplaced {n_unplaced} != {n_reads}")
    check(len(jp["placements"]) <= n_unique, "more placements than "
          "distinct reads")
    # the first 512 placements against the CPU engine, read by read
    arr = db.arrays
    first = jp["placements"][:512]
    idx = np.array([int(p["nm"][0][0].split()[1][4:]) for p in first])
    ref = PlacementEngine(db, device="cpu").score(mat[idx], lens[idx])
    for i, p in enumerate(first):
        best = p["p"][0]
        node = int(ref.top_edges[i, 0])
        check(node >= 0, f"CLI placement {i}: the CPU engine leaves the "
              "read unplaced")
        near_tie = abs(float(ref.top_scores[i, 0]) -
                       float(ref.top_scores[i, 1])) <= 2e-4
        check(best[0] == int(arr.jplace_edge_id[node]) or near_tie,
              f"CLI placement {i}: best edge {best[0]} vs CPU "
              f"{arr.jplace_edge_id[node]}")
        check(abs(best[1] - float(ref.top_scores[i, 0])) <= 2e-4,
              f"CLI placement {i}: likelihood {best[1]} vs CPU "
              f"{ref.top_scores[i, 0]}")
    return {"reads_per_s": n_reads / dt, "seconds": dt, "reads": n_reads,
            "placements": len(jp["placements"]), "unplaced": n_unplaced,
            "launches": launches}


# ---------------------------------------------------------------------- #
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cli-reads", type=int, default=100_000)
    ap.add_argument("--json-out", default=None,
                    help="also write the results to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rappas_tpu_torch import _kernels
        from rappas_tpu_torch.db import PhyloKmerDB
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _kernels.build_log().splitlines():
        if ("Compiling entry" in line or "registers" in line or
                "spill" in line):
            print(line.strip())

    results = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        db = config1_db(args.seed)
        db_path = work / "config1.rptpu"
        db.save(db_path)
        db = PhyloKmerDB.load(db_path)
        print(f"DB: k={db.k}, {db.n_edge_slots} edge slots, "
              f"{db.n_kmers} k-mers, {db.nnz} postings "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        kern = kernel_phase(db, args.seed)
        for name, r in kern.items():
            print(f"kernel {name}: {json.dumps(r)}", flush=True)
        eng = engine_phase(db, args.seed)
        print(f"engine: {eng['reads_per_s']:.0f} reads/s "
              f"({json.dumps(eng)})", flush=True)
        cl = cli_phase(db, db_path, work, args.cli_reads, args.seed)
        print(f"cli: {cl['reads_per_s']:.0f} reads/s ({json.dumps(cl)})",
              flush=True)
    results.update(kernels=kern, engine=eng, cli=cl)

    sources = {"accumulate_packed": ("accumulate.cu",
                                     "rappas_tpu/place/engine.py:253,195"),
               "accumulate_codes": ("accumulate.cu",
                                    "rappas_tpu/place/engine.py:175,195"),
               "finalize_wire": ("finalize.cu",
                                 "rappas_tpu/place/engine.py:453,68"),
               "ambiguous_pass": ("ambiguous.cu",
                                  "rappas_tpu/place/engine.py:907,967,1005")}
    rows = []
    for name, (src, replaces) in sources.items():
        r = kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"rappas_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": cl["launches"][name],
            "engine_launches": eng["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(results, indent=1))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
