#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rappas_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--cli-reads 50000] [--json-out F]

It needs one card, builds the CUDA kernels from ``rappas_tpu_torch/csrc``
(into ``rappas_tpu_torch/_build/``) and drives ``-p p`` placement on DBs
made from the seed, at the widths of five configurations, in every table
layout, precision and height split a single device resolves to:

* config 1, the direct layout (k=8, E=300 edge slots, a table
  ``D[4^8 + 1, 300]`` f32 of 79 MB, 150 bp reads):
  1. kernel phase -- K1 accumulate_packed, K2 accumulate_codes, K3
     finalize_wire and K4 ambiguous_pass at B=16384 against their plain
     PyTorch versions on the card, with each kernel's device time (a
     CUDA graph of its calls replayed between CUDA events) and its time
     per back-to-back call (host enqueue included) beside the plain
     version's, one library call's where PyTorch has one, and the least
     time the card could take (its bound);
  2. engine phase -- 10 batches of 16384 reads (1% carry one N) through
     ``PlacementEngine.score_async``; every kernel must launch; 512 reads
     are held against the same engine on the CPU;
  3. CLI phase -- ``python -m rappas_tpu_torch.cli -p p`` on 50k reads
     with duplicates and N's; the jplace is parsed and its placements
     held against the CPU engine;
  4. u16 (``precision="u16"``: ``D`` uint16 ``[4^8 + 1, 300]``, 39 MB)
     -- K1, K2 and K4 on the uint16 table against their plain versions,
     an engine phase whose 512 reads are also held against the card's
     f32 engine within 5e-3, and a CLI phase (``--precision u16``, 20k
     reads);
  5. compact f32 (``table="compact"``: ``D[39,322, 300]``, 47 MB, the
     int32 keys on the card) -- C1 accumulate_compact at B=16384 against
     its plain version (2 slabs: the rows resolved once by a resolve
     pass, then summed slab by slab), and an engine phase through C1
     whose placements must equal the direct engine's;
* config 2, the direct table height-split (``bench.py:60-84``'s recipe
  at k=10, 5% of the k-mers present: ``D[4^10 + 1, 300]``, 1.26 GB f32
  in 13 parts of 96 MB, 629 MB u16 in 7; ``DIRECT_SPLIT_MIN`` lowered on
  a subclass, as the JAX default never splits): D1 routed_accumulate and
  A1 ambiguous_pass_split (f32 and u16) against their plain versions,
  then engine phases of the unsplit direct engine and of the split f32
  and u16 engines on the same batches, the split ones held against the
  unsplit; half of each batch from a chain of DB k-mers;
* config 5, the postings layout (k=12, a 4000-taxon star: E=7999; 2M
  light k-mers with 1-7 postings, 10k heavy ones with 32-199, as
  ``scripts/scale_check.py:21-48`` builds it, with every 12-mer of a
  400 kb reference among the keys): kernel phases for P1 dense_side,
  P2 ambiguous_postings and P3 finalize_postings_wire on the one light
  table, and for R1 (routed and part-select), G1 gather_compact and A1
  ambiguous_postings_parts on the default engine's 2 parts (B=8192; R1's
  and the two-stage wires bitwise P3's); engine phases of the default
  engine (its 128 MB light table past the 96 MB budget: 2 routed parts),
  the one-table engine, the two-stage and pipelined paths, 4 routed
  parts (a 32 MB budget), the select fallback after the unique-overflow
  halving, and max-mode ambiguity reads over the parts, each held
  against the one-table engine and checked for its path (parts, handle
  type, launches); the CLI with ``--table auto`` (routed); half of each
  batch is sampled from the reference (every window hits), half is
  uniform;
* the sharded phases, on a (dp=2, mp=2) mesh of four distinct cards or
  of the one card repeated (``smoke_mesh``):
  1. config 1 through ``ShardedEngine`` (two 150-column shards of the
     direct table): an engine phase (K1-K4 per shard, the gather, K3)
     and ``place_queries`` on 20k reads through it and through the single
     card engine, the two jplace files held against each other;
  2. config 5 through ``ShardedEngine`` (postings in two edge ranges of
     4,000 edges): P2 and P3 on shard 1 (a non-zero edge offset) and M1
     over both shards' wires against their plain versions at a mesh row's
     slice (4,096 reads), then an engine phase at B=8192 (P1-P3 per
     shard, M1);
  3. config 6 through ``KmerShardedPlacement`` (the 2.4 GB f32 compact
     table in two k-mer ranges): C3 against its plain version, an engine
     phase held against the single compact engine; then ``ShardedEngine``
     on the compact table's two column shards (C1, K4, K3);
* config 4, protein postings (amino k=8, E=150, 500k keys with 4
  postings, as ``bench.py:447-479``; no direct index: rows come from the
  native key probe): an engine phase of 16384-read batches of 100 aa;
  then the compact table (``precision="u16"`` resolves to it: ``D``
  uint16 ``[500,001, 150]``, 150 MB; 20^8 > 2^31, so the host searches
  the keys): C2 accumulate_rows on f32 and u16 tables against its plain
  version, and engine phases at u16 and at compact f32, half of each
  batch sampled from a chain of DB keys;
* config 6, k=12 DNA on config 1's 300 edge slots (config 5's recipe
  otherwise): f32 resolves to postings, u16 to the compact table with
  the keys searched on the card (the dense u16 table would take 10.1
  GB, the compact one ``[2,010,001, 300]`` takes 1.2 GB): C1 on the f32
  (2.4 GB) and u16 tables against its plain version, an engine phase and
  a CLI phase (``--precision u16``, 20k reads).

Each row-sum kernel line (K1, K2, C1, C2, C3, and D1, which launches the
row-sum template once per part) also reports the row bytes it moved
(valid windows times the slab row bytes, summed over the slabs), their
rate in TB/s and the slab plan its wrapper launched (C1: whether the
resolve pass ran; D1: one plan per part).  Each P3/R1 line reports its
slots, postings per read and how many reads took the warp, block and
scratch paths; P3 also times the block path alone, every read on it, in
the same run.  The P2/A1 postings lines report the light-only windows and
the largest light pairs one window stages; the K4 and A1 split lines
their load width and threads per window.

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
B_POSTINGS = 8192
READ_LEN = 150
K_KEEP = 7
#: bases of the config-5 reference whose 12-mers are all DB keys
REF_LEN = 400_000


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
    return bench_db(seed, 8, 0.6)


def config2_db(seed: int):
    """BASELINE config 2's table size from the seed (``bench.py:60-84``'s
    recipe at k=10 and an occupancy of 0.05, as ``bench.py:384``): 300
    edge slots, 52,428 k-mers with 5 postings each; its direct table
    ``D[4^10 + 1, 300]`` takes 1.26 GB in f32, 629 MB in u16."""
    return bench_db(seed, 10, 0.05)


def bench_db(seed: int, k: int, occupancy: float):
    """``bench.py:60-84``'s synthetic DB: 300 edge slots, a share
    ``occupancy`` of the 4^k k-mers present with 5 postings each."""
    import numpy as np

    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    n_edges, per_kmer = 300, 5
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


def config5_reference(seed: int):
    """The config-5 reference sequence, ASCII uint8[REF_LEN]: every one of
    its 12-mers is a key of :func:`config5_db`, so a read sampled from it
    hits on every window, as a read of the placed clade does."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, REF_LEN)]


def config5_db(seed: int):
    """BASELINE config 5 widths from the seed (the recipe of
    ``scripts/scale_check.py:21-48``): k=12, a 4000-taxon star tree
    (E = 7999 edge slots), 2,000,000 light k-mers with 1-7 postings and
    10,000 heavy ones with 32-199 (about 9.15M postings).  The keys are
    the 12-mers of :func:`config5_reference` and, for the rest, uniform
    draws; which keys are heavy is drawn uniformly over all of them."""
    return k12_db(seed, 2 * 4000 - 1)


def config6_db(seed: int):
    """Config 6: :func:`config5_db`'s k-mers on config 1's tree of 300
    edge slots -- a sparse k=12 DB whose dense u16 table (10.1 GB) is
    past the direct budget, so ``precision="u16"`` takes the compact
    table."""
    return k12_db(seed, 300)


def k12_db(seed: int, E: int):
    """The k=12 recipe of :func:`config5_db` on a star tree of ``E`` edge
    slots."""
    import numpy as np

    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    k, n_light, n_heavy = 12, 2_000_000, 10_000
    rng = np.random.default_rng(seed)
    labels = ",".join(f"T{i}:0.1" for i in range(E - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    ref = DNA.char_to_code[config5_reference(seed)].astype(np.int64)
    ref_keys = np.unique(np.lib.stride_tricks.sliding_window_view(ref, k)
                         @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64)))
    drawn = rng.choice(4 ** k, size=n_light + n_heavy, replace=False)
    drawn = drawn[~np.isin(drawn, ref_keys)]
    keys = np.concatenate([ref_keys,
                           drawn[:n_light + n_heavy - ref_keys.size]])
    rng.shuffle(keys)
    lens = np.concatenate([rng.integers(1, 8, n_light),
                           rng.integers(32, 200, n_heavy)])
    codes = np.repeat(keys, lens)
    edges = rng.integers(1, E, codes.shape[0]).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.shape[0]) * 2.5
              ).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes.astype(np.int64), edges,
                                         scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


def config4_db(seed: int):
    """BASELINE config 4 widths from the seed (``bench.py:447-479``'s
    recipe): amino k=8 (a 20^8 key space), 150 edge slots, 500,000 keys
    with 4 postings each."""
    import numpy as np

    from rappas_tpu_torch.alphabet import AA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    rng = np.random.default_rng(seed + 11)
    n_edges, n_keys, mean_post = 150, 500_000, 4
    labels = ",".join(f"L{i}:0.1" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(8, 1.5, 20)
    keys = np.unique(rng.integers(0, 20 ** 8, int(n_keys * 1.2),
                                  np.int64))[:n_keys]
    codes = np.repeat(keys, mean_post)
    edges = rng.integers(1, n_edges, codes.shape[0]).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.shape[0]) * 2.5
              ).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=8, omega=1.5, alphabet=AA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


def key_chain(db, seed: int, n_keys: int = 50_000):
    """ASCII uint8: the letters of ``n_keys`` random DB keys one after
    another, so a read sampled from it hits on every window that starts
    at a key's first letter (one in k), as reads of a placed clade hit
    where a uniform protein read almost never does (500k keys in 20^8)."""
    import numpy as np

    rng = np.random.default_rng(seed + 13)
    S, k = db.alphabet.n_states, db.k
    keys = db.keys[rng.integers(0, db.n_kmers, n_keys)]
    digits = keys[:, None] // S ** np.arange(k - 1, -1, -1, dtype=np.int64) % S
    letters = np.frombuffer(db.alphabet.letters.encode(), np.uint8)
    return letters[digits.reshape(-1)]


def random_reads(rng, n: int, n_ambiguous: int, short_share: float = 0.0,
                 length: int = READ_LEN, letters: bytes = b"ACGT",
                 ref=None):
    """ASCII reads uint8[n, length] (0xFF padded) and lengths: uniform
    letters, or with a reference ``ref`` (ASCII) half of them sampled
    from it at random offsets; ``n_ambiguous`` random reads carry one N
    (X for protein); a ``short_share`` of the reads is cut to 80-99% of
    ``length``."""
    import numpy as np

    mat = np.frombuffer(letters, np.uint8)[
        rng.integers(0, len(letters), (n, length))].copy()
    if ref is not None:
        pick = rng.choice(n, n // 2, replace=False)
        start = rng.integers(0, ref.size - length + 1, pick.size)
        mat[pick] = ref[start[:, None] + np.arange(length)]
    lens = np.full(n, length, np.int32)
    short = np.flatnonzero(rng.random(n) < short_share)
    lens[short] = rng.integers(int(length * 0.8), length, short.size)
    for i, ln in zip(short, lens[short]):
        mat[i, ln:] = 0xFF
    amb = rng.choice(n, n_ambiguous, replace=False)
    mat[amb, (rng.random(n_ambiguous) * lens[amb]).astype(np.int64)] = \
        ord("N" if letters == b"ACGT" else "X")
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


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of a kernel wrapper: ``reps`` calls
    captured in one CUDA graph (the wrapper's host work runs once, at
    capture), the graph replayed ``replays`` times between CUDA events.
    Back-to-back calls (:func:`cuda_ms`) time the host's enqueue instead
    wherever a kernel takes less time than its wrapper's Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm up on a side stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def timed(fn) -> dict:
    """A kernel wrapper's times: ``ms``, the device time per call
    (:func:`device_ms`), and ``call_ms``, back-to-back calls between CUDA
    events (:func:`cuda_ms`), the host's enqueue included."""
    return {"ms": device_ms(fn), "call_ms": cuda_ms(fn)}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_traffic(D, name: str, n_windows: int, ms: float) -> dict:
    """What the row-sum kernel ``name`` (K1, K2, C1, C2, C3) moved in its
    last launch, timed at ``ms``: ``row_bytes``, the valid windows times
    the slab row bytes summed over the slabs (each window reads its row's
    E columns once, slab by slab), its rate ``row_tb_s`` in TB/s, and the
    slab plan that its wrapper launched."""
    from rappas_tpu_torch.place import kernels as K

    plan = K.SLABS[name]
    nbytes = n_windows * D.shape[1] * D.element_size()
    return {"row_bytes": nbytes, "row_tb_s": nbytes / (ms * 1e-3) / 1e12,
            "slabs": plan.n_slabs, "slab_cols": plan.cols,
            "load_bytes": plan.vec * D.element_size(),
            "reads_per_block": plan.reads_per_block,
            "evict_last": plan.keep}


def p3_paths(plan, counts, n_slots: int) -> dict:
    """A P3/R1 call's read paths (warp, block, scratch) from its plan, its
    slots and real light postings per read."""
    return {"slots": n_slots, "postings_per_read_mean": float(counts.mean()),
            "postings_per_read_max": int(counts.max()),
            "paths": plan.paths(len(counts))}


def window_stats(win_off, alt_hrows, nh: int, P: int) -> dict:
    """The windows of a P2/A1 launch: how many are light-only (every
    alternative's heavy row the zero row ``nh``: the kernel scores only
    the columns their light postings hit) and the largest ``n_alt * P``
    light pairs one window stages."""
    import torch

    heavy = torch.cat([alt_hrows.new_zeros(1),
                       (alt_hrows != nh).to(torch.int64).cumsum(0)])
    lo, hi = win_off[:-1].long(), win_off[1:].long()
    n_alt = hi - lo
    return {"light_only_windows": int(((heavy[hi] - heavy[lo]) == 0).sum()),
            "max_pairs_per_window": int(n_alt.max()) * P
            if n_alt.numel() else 0}


def ambiguous_launch(E: int, item: int, ptrs) -> dict:
    """K4's and A1 split's load plan: bytes per load and threads per window
    (``kernels.ambiguous_plan``; nothing where the kernels module has no
    such plan)."""
    from rappas_tpu_torch.place import kernels as K

    if not hasattr(K, "ambiguous_plan"):
        return {}
    vec, group = K.ambiguous_plan(E, item, tuple(ptrs))
    return {"load_bytes": vec * item, "threads_per_window": group}


def held(got, want, exact: bool) -> bool:
    """A kernel's f32 sums against its plain version's: bitwise on a uint16
    table (sums of quantised values below 2^24 are exact in f32 in any
    order), within 1e-5 relative on an f32 one (summation order)."""
    import torch

    if exact:
        return torch.equal(got, want)
    return torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def same_placements(a, b, tol_score=2e-4, tol_lwr=1e-4) -> str | None:
    """None when two BatchResults agree (|L| exact, edge sets exact apart
    from near-ties at the K-th slot, scores and LWR within tolerance; LWR
    not held when ``tol_lwr`` is None), else a description of the first
    difference."""
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
        if ea == eb and tol_lwr is not None:
            la = dict(zip(a.top_edges[i][va], a.top_lwr[i][va]))
            lb = dict(zip(b.top_edges[i][vb], b.top_lwr[i][vb]))
            if any(abs(float(la[e]) - float(lb[e])) > tol_lwr for e in ea):
                return f"read {i}: LWR differs"
    return None


# ---------------------------------------------------------------------- #
def kernel_phase(db, seed: int, precision: str = "f32",
                 device: str = "cuda") -> dict:
    """K1, K2 and K4 on the direct table in ``precision`` (their ``_u16``
    instances on a uint16 one), and K3 on f32, at B=16384."""
    import numpy as np
    import torch

    from rappas_tpu_torch.convert import device_tables
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (PlacementEngine, pack_reads,
                                               window_offsets)

    dev = torch.device(device)
    tabs = device_tables(db, dev, "direct", precision)
    D, scale = tabs.D, float(tabs.scale)
    u16 = D.dtype == torch.uint16
    sfx = "_u16" if u16 else ""
    D32 = D.float()             # embedding_bag takes no uint16 table
    E, item = D.shape[1], D.element_size()
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
    check(held(got, want, u16),
          f"K1 accumulate_packed{sfx} disagrees with its plain version "
          f"(max abs err {err1})")
    rows1_long = rows1.long()
    touched = torch.unique(rows1[rows1 != miss])
    n_win = int((rows1 != miss).sum())
    b, why = bound(packed.numel() + lens_d.numel() * 4 +
                   touched.numel() * E * item + B_KERNEL * E * 4,
                   (n_win + B_KERNEL) * E)
    t = timed(lambda: K.accumulate_packed(D, packed, lens_d, READ_LEN, k,
                                          scale, acc=got))
    out["accumulate_packed" + sfx] = dict(
        max_abs_err=err1, bound_ms=b, bound_by=why, **t,
        **row_traffic(D, "accumulate_packed" + sfx, n_win, t["ms"]),
        plain_ms=cuda_ms(lambda: K.accumulate(D, K.kmer_rows_packed(
            packed, lens_d, k, 4, D.shape[0], READ_LEN)) * scale, reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows1_long, D32, mode="sum")))
    acc_pure = got

    # K2 ------------------------------------------------------------ #
    rows2 = K.kmer_rows(codes_d, k, 4, D.shape[0])
    got = K.accumulate_codes(D, codes_d, k, 4, scale)
    want = K.accumulate(D, rows2) * scale
    torch.cuda.synchronize()
    err2 = float((got - want).abs().max())
    check(held(got, want, u16),
          f"K2 accumulate_codes{sfx} disagrees with its plain version "
          f"(max abs err {err2})")
    rows2_long = rows2.long()
    touched = torch.unique(rows2[rows2 != miss])
    n_win = int((rows2 != miss).sum())
    b, why = bound(codes_d.numel() + touched.numel() * E * item +
                   B_KERNEL * E * 4, (n_win + B_KERNEL) * E)
    t = timed(lambda: K.accumulate_codes(D, codes_d, k, 4, scale,
                                         acc=got))
    out["accumulate_codes" + sfx] = dict(
        max_abs_err=err2, bound_ms=b, bound_by=why, **t,
        **row_traffic(D, "accumulate_codes" + sfx, n_win, t["ms"]),
        plain_ms=cuda_ms(lambda: K.accumulate(D, K.kmer_rows(
            codes_d, k, 4, D.shape[0])) * scale, reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows2_long, D32, mode="sum")))
    acc_amb = got
    if not u16:
        out.update(finalize_phase(acc_pure, lens_d, tabs.thr, k))

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
        check(errs[-1] <= 2e-4, f"K4 ambiguous_pass{sfx} (max mode "
              f"{with_max}) disagrees with its plain version (max abs err "
              f"{errs[-1]})")
        check(torch.equal(got > 0, want > 0),
              f"K4 ambiguous_pass{sfx}: matched edges differ")
        if not with_max:
            mean_spec, mean_alt_win = spec, alt_win_d
    alt_rows, win_off, win_read_d, inv_w_d, is_mean_d = mean_spec
    n_alt, n_w = alt_rows.numel(), win_read_d.numel()
    reads_touched = torch.unique(win_read_d).numel()
    b, why = bound(torch.unique(alt_rows).numel() * E * item + n_alt * 4 +
                   n_w * 13 + 4 + 2 * reads_touched * E * 4,
                   (n_alt + n_w) * E * 4)
    scratch = acc_amb.clone()
    out["ambiguous_pass" + sfx] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why,
        **timed(lambda: K.ambiguous_pass_(scratch, D, scale, *mean_spec)),
        plain_ms=cuda_ms(lambda: K.ambiguous_pass(
            K.alt_delta_rows(D, scale, alt_rows), mean_alt_win, win_read_d,
            inv_w_d, is_mean_d, acc_amb)),
        library_ms=None, windows=n_w, alternatives=n_alt,
        **ambiguous_launch(E, item, (D.data_ptr(),)))
    return out


def finalize_phase(acc_pure, lens_d, thr_t, k: int) -> dict:
    """K3 on config 1's batch of K1 sums."""
    import torch

    from rappas_tpu_torch.place import kernels as K

    thr = float(thr_t)
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
    return {"finalize_wire": dict(
        max_abs_err=err3, bound_ms=b, bound_by=why,
        **timed(lambda: K.finalize_wire(acc_pure, lens_d, thr, k, K_KEEP)),
        plain_ms=cuda_ms(lambda: K.pack_wire(*K.finalize(
            acc_pure, lens_d, thr_t, k, K_KEEP))),
        library_ms=cuda_ms(lambda: torch.topk(masked, K_KEEP, dim=1)))}


def compact_kernel_phase(eng, seed: int, ref=None, length: int = READ_LEN,
                         letters: bytes = b"ACGT", tag: str = "") -> dict:
    """C1 (keys on the card) or C2 (rows from the host search) on the
    compact table of the card engine ``eng`` at B=16384, half of the
    reads sampled from ``ref``, against its plain version; its line is
    named after the kernel, then ``tag``.  C1 reports whether its resolve
    pass ran (a launch of more than one slab)."""
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import host_kmer_indices

    D, keys, scale = eng.D, eng.keys_dev, eng.scale
    dev = D.device
    u16 = D.dtype == torch.uint16
    E, item, n, k = D.shape[1], D.element_size(), D.shape[0] - 1, eng.k
    S = eng.alphabet.n_states
    D32 = D.float()             # embedding_bag takes no uint16 table
    rng = np.random.default_rng(seed + 6)
    mat, lens = random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05, length,
                             letters, ref)
    codes = eng.encode_batch(mat)
    if keys is not None:                    # C1: the card searches
        name = "accumulate_compact"
        codes_d = torch.from_numpy(codes).to(dev)
        idx = K.kmer_indices64(codes_d, k, S)
        rows = K.compact_rows(keys, idx)

        def run():
            return K.accumulate_compact(D, keys, codes_d, k, S, scale)

        def plain():
            return K.accumulate(D, K.compact_rows(
                keys, K.kmer_indices64(codes_d, k, S))) * scale
        # inputs: the codes, and at most every key once for the probes
        n_valid = int((idx >= 0).sum())
        probes = n_valid * int(np.ceil(np.log2(n + 1)))
        in_bytes = codes_d.numel() + min(n, probes) * 4
        keys_long = keys.long()

        def library():
            pos = torch.searchsorted(keys_long, idx.long())
            hit = (pos < n) & (keys_long[pos.clamp_max(n - 1)] == idx)
            return torch.nn.functional.embedding_bag(
                torch.where(hit, pos, n), D32, mode="sum")
    else:                                   # C2: the host searched
        name = "accumulate_rows"
        rows = torch.from_numpy(eng._db_lookup(
            host_kmer_indices(codes, lens, k, S))).to(dev)
        probes = 0

        def run():
            return K.accumulate_rows(D, rows, scale)

        def plain():
            return K.accumulate(D, rows) * scale
        in_bytes = rows.numel() * 4
        rows_long = rows.long()

        def library():
            return torch.nn.functional.embedding_bag(rows_long, D32,
                                                     mode="sum")
    launched = name + ("_u16" if u16 else "")
    name = launched + tag
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(held(got, want, u16), f"{name} disagrees with its plain version "
          f"(max abs err {err})")
    check(bool((want > 0).any()), f"{name}: no window hit the table")
    hit = rows[rows != n]
    b, why = bound(in_bytes + torch.unique(hit).numel() * E * item +
                   B_KERNEL * E * 4, probes + (hit.numel() + B_KERNEL) * E)
    t = timed(run)
    traffic = row_traffic(D, launched, hit.numel(), t["ms"])
    if keys is not None:
        traffic["resolve_pass"] = traffic["slabs"] > 1
    return {name: dict(
        max_abs_err=err, bound_ms=b, bound_by=why, hit_windows=hit.numel(),
        distinct_rows=torch.unique(hit).numel(), table_bytes=D.nbytes,
        **t, **traffic, plain_ms=cuda_ms(plain, reps=5),
        library_ms=cuda_ms(library, reps=5))}


def postings_kernel_phase(eng, seed: int, ref, device: str = "cuda") -> dict:
    """P1-P3 at B=8192 on one batch of the engine's own host inputs (half
    the reads sampled from the reference ``ref``), each against its plain
    version on the card."""
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import unpack_wire

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 4)
    mat, lens = random_reads(rng, B_POSTINGS, B_POSTINGS // 100, ref=ref)
    host, plan = eng.postings_inputs(eng.encode_batch(mat), mat, lens)
    host.pop("scratch_off", None)
    plan = plan.to(dev)
    d = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for n, a in host.items()}
    H, pairs = eng.heavy_dense, eng.pairs
    E, P = H.shape[1], pairs.shape[1] // 2
    miss = pairs.shape[0] - 1
    out = {}

    # P1 ------------------------------------------------------------ #
    n_slots = d["hoff"].numel() - 1
    slots = torch.repeat_interleave(torch.arange(n_slots, device=dev),
                                    (d["hoff"][1:] - d["hoff"][:-1]).long())
    acc_c = K.dense_side(H, d["hrows"], d["hoff"])
    want = K.scatter_slots(K.gather_rows(H, d["hrows"]), slots, n_slots)
    torch.cuda.synchronize()
    err = float((acc_c - want).abs().max()) if n_slots else 0.0
    check(torch.allclose(acc_c, want, rtol=1e-5, atol=1e-6),
          f"P1 dense_side disagrees with its plain version "
          f"(max abs err {err})")
    n_h = d["hrows"].numel()
    b, why = bound(n_h * 4 + (n_slots + 1) * 4 +
                   torch.unique(d["hrows"]).numel() * E * 4 +
                   n_slots * E * 4, n_h * E)
    hrows_long, hoff_long = d["hrows"].long(), d["hoff"][:-1].long()
    out["dense_side"] = dict(
        max_abs_err=err, bound_ms=b, bound_by=why, slots=n_slots,
        heavy_hits=n_h,
        **timed(lambda: K.dense_side(H, d["hrows"], d["hoff"])),
        plain_ms=cuda_ms(lambda: K.scatter_slots(
            K.gather_rows(H, d["hrows"]), slots, n_slots)),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            hrows_long, H, hoff_long, mode="sum")))

    # P2 ------------------------------------------------------------ #
    spec = [d[n] for n in ("alt_lrows", "alt_hrows", "win_off", "win_slot",
                           "win_inv_w", "win_is_mean")]
    alt_win = torch.repeat_interleave(
        torch.arange(spec[3].numel(), device=dev),
        (spec[2][1:] - spec[2][:-1]).long())
    errs = []
    for mean in (1, 0):
        spec[5] = torch.full_like(d["win_is_mean"], mean)
        got = K.ambiguous_postings_(acc_c.clone(), H, pairs, *spec)
        want = K.ambiguous_pass(
            K.alt_delta_rows_postings(pairs, H, spec[0], spec[1]), alt_win,
            spec[3], spec[4], spec[5], acc_c)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(errs[-1] <= 2e-4, f"P2 ambiguous_postings (mean {mean}) "
              f"disagrees with its plain version (max abs err {errs[-1]})")
        check(torch.equal(got > 0, want > 0),
              "P2 ambiguous_postings: matched edges differ")
        if mean:
            acc_amb = got
    spec[5] = d["win_is_mean"]
    n_alt, n_w = spec[0].numel(), spec[3].numel()
    lr, hr = spec[0][spec[0] != miss], spec[1][spec[1] != H.shape[0] - 1]
    # operations the function needs: P scatter adds onto an alternative's
    # heavy row, then exp2, add and max per alternative and column, and
    # about 3 per window and column (log, floor, add into the slot); the
    # kernel's scan of every posting per column is its own cost, not work
    # the function needs
    b, why = bound(torch.unique(hr).numel() * E * 4 +
                   torch.unique(lr).numel() * 2 * P * 4 + n_alt * 8 +
                   n_w * 13 + 4 +
                   2 * torch.unique(spec[3]).numel() * E * 4,
                   (n_alt * 3 + 3 * n_w) * E + n_alt * P)
    scratch = acc_c.clone()
    out["ambiguous_postings"] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why, windows=n_w,
        alternatives=n_alt,
        **window_stats(spec[2], spec[1], H.shape[0] - 1, P),
        **timed(lambda: K.ambiguous_postings_(scratch, H, pairs, *spec)),
        plain_ms=cuda_ms(lambda: K.ambiguous_pass(
            K.alt_delta_rows_postings(pairs, H, spec[0], spec[1]), alt_win,
            spec[3], spec[4], spec[5], acc_c)),
        library_ms=None)

    # P3 ------------------------------------------------------------ #
    args = (pairs, d["lrows"], acc_amb, d["slot_of"], d["lengths"])
    thr_t = torch.tensor(np.float32(eng.thr), device=dev)
    Kk = min(K_KEEP, E)
    want = K.pack_wire(*K.finalize_postings(*args, thr_t, eng.k, K_KEEP),
                       wide=eng.wide)
    ref = unpack_wire(want.cpu().numpy(), Kk, eng.wide)
    counts = eng._light_counts[host["lrows"]].sum(axis=1)
    block_plan = K.postings_plan(counts, warp_pairs=0).to(dev)
    errs = []
    for name, pl in (("plan", plan), ("block path", block_plan),
                     ("global scratch",
                      K.postings_plan(counts, 0, 0).to(dev))):
        got = K.finalize_postings_wire(*args, eng.thr, eng.k, K_KEEP, pl)
        torch.cuda.synchronize()
        res = unpack_wire(got.cpu().numpy(), Kk, eng.wide)
        diff = same_placements(res, ref)
        check(diff is None, f"P3 finalize_postings_wire ({name}) vs its "
              f"plain version: {diff}")
        fin = np.isfinite(ref.top_scores)
        errs.append(float(np.abs(res.top_scores - ref.top_scores)[fin].max())
                    if fin.any() else 0.0)
    lrows_real = d["lrows"][d["lrows"] != miss]
    n_b = counts[counts > 1].astype(np.float64)
    b, why = bound(torch.unique(lrows_real).numel() * 2 * P * 4 +
                   d["lrows"].numel() * 4 + B_POSTINGS * 8 +
                   n_slots * E * 4 + got.numel() * 4,
                   float((n_b * np.ceil(np.log2(n_b))).sum()) +
                   n_slots * E)
    out["finalize_postings_wire"] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why,
        window_columns=int(host["lrows"].shape[1]),
        **p3_paths(plan, counts, n_slots), smem_pairs=plan.smem_pairs,
        **timed(lambda: K.finalize_postings_wire(
            *args, eng.thr, eng.k, K_KEEP, plan)),
        # every read on the block path (the earlier design), this run
        block_path_ms=device_ms(lambda: K.finalize_postings_wire(
            *args, eng.thr, eng.k, K_KEEP, block_plan)),
        plain_ms=cuda_ms(lambda: K.pack_wire(*K.finalize_postings(
            *args, thr_t, eng.k, K_KEEP), wide=eng.wide), reps=5),
        library_ms=None)
    return out


def sharded_postings_kernel_phase(sp, eng, seed: int, ref) -> dict:
    """P2 and P3 on edge-range shard 1 (a non-zero edge offset) and M1 over
    both shards' wires, at the shapes of a mesh row's slice of one
    B=8192 batch through ``sp`` (the card's ``PostingsShardedPlacement``
    at dp=2, mp=2), each against its plain version on the card; ``eng``
    gives the host codec."""
    import numpy as np
    import torch

    from rappas_tpu_torch.parallel.postings_sharded import \
        slice_ambiguities
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (alt_rows_of,
                                               host_kmer_indices,
                                               postings_batch, unpack_wire)

    rng = np.random.default_rng(seed + 8)
    mat, lens = random_reads(rng, B_POSTINGS, B_POSTINGS // 100, ref=ref)
    codes = eng.encode_batch(mat)
    amb = eng._expand_ambiguities_host(codes, mat, lens)
    S, k = eng.alphabet.n_states, eng.k
    Bl = B_POSTINGS // sp.mesh.shape["dp"]
    kidx = host_kmer_indices(codes[:Bl], lens[:Bl], k, S)
    kidx = np.where(kidx >= 0, kidx, S ** k)
    amb = slice_ambiguities(amb, 0, Bl)
    dev = sp.mesh.devices[0, 1]
    thr_t = torch.tensor(np.float32(sp.thr), device=dev)
    out, wires = {}, []
    for j, sh in enumerate(sp._shards):
        host, plan = postings_batch(
            sh["rof"][kidx], sh["nl"], sh["light_counts"], lens[:Bl], amb,
            alt_rows_of(sh["rof"][amb[0]], sh["nl"], sh["nh"]))
        host.pop("scratch_off", None)
        plan = plan.to(dev)
        d = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for n, a in host.items()}
        H, pairs = sh["heavy_dense"][dev], sh["pairs"][dev]
        E, P, off = H.shape[1], pairs.shape[1] // 2, sh["offset"]
        acc_c = K.dense_side(H, d["hrows"], d["hoff"])
        spec = [d[n] for n in ("alt_lrows", "alt_hrows", "win_off",
                               "win_slot", "win_inv_w", "win_is_mean")]
        alt_win = torch.repeat_interleave(
            torch.arange(spec[3].numel(), device=dev),
            (spec[2][1:] - spec[2][:-1]).long())

        def p2(acc):
            return K.ambiguous_postings_(acc, H, pairs, *spec, off)

        def p2_plain():
            return K.ambiguous_pass(K.alt_delta_rows_postings(
                pairs, H, spec[0], spec[1], off), alt_win, *spec[3:],
                acc_c)
        got, want = p2(acc_c.clone()), p2_plain()
        torch.cuda.synchronize()
        err2 = float((got - want).abs().max()) if got.numel() else 0.0
        check(err2 <= 2e-4 and torch.equal(got > 0, want > 0),
              f"P2 ambiguous_postings (edge offset {off}) disagrees with "
              f"its plain version (max abs err {err2})")
        acc_c = got
        args = (pairs, d["lrows"], acc_c, d["slot_of"], d["lengths"])

        def p3():
            return K.finalize_postings_wire(*args, sp.thr, k, K_KEEP, plan,
                                            off, sp.n_edges)

        def p3_plain():
            return K.pack_wire(*K.finalize_postings(
                *args, thr_t, k, K_KEEP, off), wide=sp.wide)
        wire, want = p3(), p3_plain()
        torch.cuda.synchronize()
        res = unpack_wire(wire.cpu().numpy(), sp._k_shard, sp.wide)
        ref_res = unpack_wire(want.cpu().numpy(), sp._k_shard, sp.wide)
        diff = same_placements(res, ref_res)
        check(diff is None, f"P3 finalize_postings_wire (edge offset {off})"
              f" vs its plain version: {diff}")
        check(bool((res.top_edges >= off).any()), "P3 with an edge offset: "
              "no global edge id past the offset")
        wires.append(wire)
        if j == 0:
            continue
        fin = np.isfinite(ref_res.top_scores)
        err3 = float(np.abs(res.top_scores - ref_res.top_scores)[fin].max())
        n_alt, n_w = spec[0].numel(), spec[3].numel()
        miss = pairs.shape[0] - 1
        lr, hr = spec[0][spec[0] != miss], spec[1][spec[1] != H.shape[0] - 1]
        b, why = bound(torch.unique(hr).numel() * E * 4 +
                       torch.unique(lr).numel() * 2 * P * 4 + n_alt * 8 +
                       n_w * 13 + 4 +
                       2 * torch.unique(spec[3]).numel() * E * 4,
                       (n_alt * 3 + 3 * n_w) * E + n_alt * P)
        scratch = acc_c.clone()
        out["ambiguous_postings_offset"] = dict(
            max_abs_err=err2, bound_ms=b, bound_by=why, edge_offset=off,
            windows=n_w, alternatives=n_alt, reads=Bl,
            **window_stats(spec[2], spec[1], H.shape[0] - 1, P),
            **timed(lambda: p2(scratch)), plain_ms=cuda_ms(p2_plain),
            library_ms=None)
        counts = sh["light_counts"][host["lrows"]].sum(axis=1)
        n_b = counts[counts > 1].astype(np.float64)
        n_slots = d["hoff"].numel() - 1
        lrows_real = d["lrows"][d["lrows"] != miss]
        b, why = bound(torch.unique(lrows_real).numel() * 2 * P * 4 +
                       d["lrows"].numel() * 4 + Bl * 8 +
                       n_slots * E * 4 + wire.numel() * 4,
                       float((n_b * np.ceil(np.log2(n_b))).sum()) +
                       n_slots * E)
        out["finalize_postings_wire_offset"] = dict(
            max_abs_err=err3, bound_ms=b, bound_by=why, edge_offset=off,
            shard_width=E, reads=Bl, **p3_paths(plan, counts, n_slots),
            **timed(p3),
            plain_ms=cuda_ms(p3_plain, reps=5), library_ms=None)

    # M1 over the two shards' wires ------------------------------------ #
    stacked = torch.stack(wires)
    mp, K_in = stacked.shape[0], sp._k_shard

    def m1():
        return K.merge_candidates_wire(stacked, K_in, sp.wire_k, sp.wide)

    def m1_plain():
        parts = [K.wire_fields(stacked[j], K_in, sp.wide) for j in range(mp)]
        return K.pack_wire(*K.merge_candidates(
            torch.cat([q[0] for q in parts], 1),
            torch.cat([q[1] for q in parts], 1),
            torch.stack([q[2] for q in parts]), sp.wire_k), wide=sp.wide)
    got, want = m1(), m1_plain()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "M1 merge_candidates_wire: wire words "
          "differ from the plain version")
    ts_all = torch.cat([stacked[j][:, :K_in].view(torch.float32)
                        for j in range(mp)], 1)
    te_all = torch.cat([K.wire_fields(stacked[j], K_in, sp.wide)[0]
                        for j in range(mp)], 1)

    def library():
        v, i = torch.topk(ts_all, sp.wire_k, dim=1)
        return v, te_all.gather(1, i)
    b, why = bound(stacked.numel() * 4 + got.numel() * 4,
                   Bl * sp.wire_k * mp * K_in)
    out["merge_candidates_wire"] = dict(
        max_abs_err=0.0, bound_ms=b, bound_by=why, shards=mp, reads=Bl,
        candidates=mp * K_in, **timed(m1), plain_ms=cuda_ms(m1_plain),
        library_ms=cuda_ms(library))
    return out


def split_postings_kernel_phase(eng, one, seed: int, ref,
                                device: str = "cuda") -> dict:
    """R1 (routed and part-select), G1 and A1's P2 instance at B=8192 on
    one batch of the split engine ``eng``'s host inputs (half the reads
    sampled from ``ref``), each against its plain version on the card;
    R1's wires and P3's on G1's compact table must equal the one-table P3
    wire of ``one`` (the same DB unsplit) bitwise."""
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import unpack_wire

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 12)
    mat, lens = random_reads(rng, B_POSTINGS, B_POSTINGS // 100, ref=ref)
    host, plan = eng.postings_inputs(eng.encode_batch(mat), mat, lens)
    host.pop("scratch_off", None)
    plan = plan.to(dev)
    routed_np = eng._route_windows(host["lrows"])
    d = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for n, a in host.items()}
    routed = torch.from_numpy(routed_np).to(dev)
    H, parts, tables = eng.heavy_dense, eng._light, eng.light_parts
    E, P = H.shape[1], tables[0].shape[1] // 2
    nl = eng._nl
    out = {}

    # A1, P2 over the parts ------------------------------------------- #
    acc_c = K.dense_side(H, d["hrows"], d["hoff"])
    spec = [d[n] for n in ("alt_lrows", "alt_hrows", "win_off", "win_slot",
                           "win_inv_w", "win_is_mean")]
    alt_win = torch.repeat_interleave(
        torch.arange(spec[3].numel(), device=dev),
        (spec[2][1:] - spec[2][:-1]).long())

    def a1(acc):
        return K.ambiguous_postings_parts_(acc, H, parts, *spec)

    def a1_plain():
        return K.ambiguous_pass(K.alt_delta_rows_postings(
            tables, H, spec[0], spec[1]), alt_win, *spec[3:], acc_c)
    got, want = a1(acc_c.clone()), a1_plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(err <= 2e-4 and torch.equal(got > 0, want > 0),
          f"A1 ambiguous_postings_parts disagrees with its plain version "
          f"(max abs err {err})")
    n_alt, n_w = spec[0].numel(), spec[3].numel()
    lr, hr = spec[0][spec[0] != nl], spec[1][spec[1] != H.shape[0] - 1]
    b, why = bound(torch.unique(hr).numel() * E * 4 +
                   torch.unique(lr).numel() * 2 * P * 4 + n_alt * 8 +
                   n_w * 13 + 4 + 2 * torch.unique(spec[3]).numel() * E * 4,
                   (n_alt * 3 + 3 * n_w) * E + n_alt * P)
    scratch = acc_c.clone()
    out["ambiguous_postings_parts"] = dict(
        max_abs_err=err, bound_ms=b, bound_by=why, windows=n_w,
        alternatives=n_alt, parts=len(tables),
        **window_stats(spec[2], spec[1], H.shape[0] - 1, P),
        **timed(lambda: a1(scratch)), plain_ms=cuda_ms(a1_plain),
        library_ms=None)
    acc_c = got

    # R1 and G1 --------------------------------------------------------- #
    args = (acc_c, d["slot_of"], d["lengths"], eng.thr, eng.k, K_KEEP, plan)
    thr_t = torch.tensor(np.float32(eng.thr), device=dev)
    Kk = min(K_KEEP, E)
    one_wire = K.finalize_postings_wire(one.pairs, d["lrows"], *args)
    counts = eng._light_counts[host["lrows"]].sum(axis=1)
    n_b = counts[counts > 1].astype(np.float64)
    sort_ops = float((n_b * np.ceil(np.log2(n_b))).sum())
    n_slots = d["hoff"].numel() - 1
    distinct = torch.unique(d["lrows"][d["lrows"] != nl]).numel()

    def plain_wire(**source):
        return K.pack_wire(*K.finalize_postings(
            None, source.pop("lrows", None), acc_c, d["slot_of"],
            d["lengths"], thr_t, eng.k, K_KEEP, light_parts=tables,
            **source), wide=eng.wide)
    r1 = {
        "finalize_postings_wire_routed": (
            lambda: K.finalize_postings_wire_routed(parts, routed, *args),
            lambda: plain_wire(routed_lrows=tuple(routed)), routed.numel()),
        "finalize_postings_wire_parts": (
            lambda: K.finalize_postings_wire_parts(parts, d["lrows"], *args,
                                                   miss=nl),
            lambda: plain_wire(lrows=d["lrows"]), d["lrows"].numel())}
    for name, (run, plain, n_rows) in r1.items():
        got, want = run(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, one_wire), f"R1 {name}: wire differs from "
              "the one-table P3's")
        res = unpack_wire(got.cpu().numpy(), Kk, eng.wide)
        ref_res = unpack_wire(want.cpu().numpy(), Kk, eng.wide)
        diff = same_placements(res, ref_res)
        check(diff is None, f"R1 {name} vs its plain version: {diff}")
        fin = np.isfinite(ref_res.top_scores)
        b, why = bound(distinct * 2 * P * 4 + n_rows * 4 + B_POSTINGS * 8 +
                       n_slots * E * 4 + got.numel() * 4,
                       sort_ops + n_slots * E)
        out[name] = dict(
            max_abs_err=float(np.abs(res.top_scores - ref_res.top_scores)
                              [fin].max()) if fin.any() else 0.0,
            wire_equals_one_table_p3=True, bound_ms=b, bound_by=why,
            parts=len(tables), window_columns=int(n_rows // B_POSTINGS),
            **p3_paths(plan, counts, n_slots),
            **timed(run), plain_ms=cuda_ms(plain, reps=5),
            library_ms=None)

    # G1 on the two-stage path's unique rows (the budget of this batch) -- #
    two = dict(host)
    eng.enable_routed_windows(False)
    src = eng._light_source(two)
    eng.enable_routed_windows(True)
    check(src[0] == "compact", f"G1: the batch took {src}, not the "
          "two-stage path")
    uniq = torch.from_numpy(two["uniq"]).to(dev)
    uniq_off = torch.from_numpy(two["uniq_off"]).to(dev)
    inv = torch.from_numpy(two["lrows"]).to(dev)
    bounds = two["uniq_off"].tolist()
    runs = [uniq[a:c].long() for a, c in zip(bounds[:-1], bounds[1:])]
    got = K.gather_compact_(parts, uniq, uniq_off)
    want = K.gather_compact(tables, tuple(runs))
    wire = K.finalize_postings_wire(got, inv, *args, miss=src[1])
    torch.cuda.synchronize()
    check(torch.equal(got, want), "G1 gather_compact: rows differ from the "
          "plain version")
    check(torch.equal(wire, one_wire), "P3 on G1's compact table: wire "
          "differs from the one-table P3's")
    U = uniq.numel()
    b, why = bound(U * 4 + uniq_off.numel() * 4 + 2 * U * 2 * P * 4, 0)
    out["gather_compact"] = dict(
        max_abs_err=0.0, bound_ms=b, bound_by=why, compact_rows=U,
        parts=len(tables),
        **timed(lambda: K.gather_compact_(parts, uniq, uniq_off)),
        plain_ms=cuda_ms(lambda: K.gather_compact(tables, tuple(runs))),
        library_ms=cuda_ms(lambda: torch.cat([
            t.index_select(0, r) for t, r in zip(tables, runs)])))
    return out


def split_direct_kernel_phase(eng, whole, seed: int, ref,
                              device: str = "cuda") -> dict:
    """D1 and A1's K4 instance on the split direct table of ``eng`` (f32
    or uint16) at B=16384 (half the reads from ``ref``), against their
    plain versions on the card; D1 also within 1e-5 relative of the
    unsplit engine ``whole``'s sums (bitwise on uint16)."""
    import numpy as np
    import torch

    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (host_kmer_indices,
                                               window_offsets)

    dev = torch.device(device)
    parts, tables, scale = eng._direct, eng.direct_parts, eng.scale
    u16 = tables[0].dtype == torch.uint16
    sfx = "_u16" if u16 else ""
    E, item = tables[0].shape[1], tables[0].element_size()
    rng = np.random.default_rng(seed + 14)
    mat, lens = random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05, ref=ref)
    codes = eng.encode_batch(mat)
    kidx = host_kmer_indices(codes, lens, eng.k, 4)
    miss = eng.n_rows - 1
    rows_np = np.where(kidx >= 0, kidx, miss).astype(np.int32)
    routed = torch.from_numpy(eng._route_direct(rows_np)).to(dev)
    rows = torch.from_numpy(rows_np).to(dev)
    out = {}

    def d1():
        return K.routed_accumulate_(parts, routed, scale)

    def d1_plain():
        return K.routed_accumulate(tables, tuple(routed)) * scale
    got, want = d1(), d1_plain()
    whole_acc = K.accumulate(whole.D, rows) * whole.scale
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(held(got, want, u16) and held(got, whole_acc, u16),
          f"D1 routed_accumulate{sfx} disagrees with its plain version "
          f"(max abs err {err}) or the unsplit table's sums")
    hit = rows[rows != miss]
    D32 = whole.D.float()               # embedding_bag takes no uint16
    rows_long = rows.long()
    b, why = bound(routed.numel() * 4 + torch.unique(hit).numel() * E * item +
                   B_KERNEL * E * 4, (hit.numel() + B_KERNEL) * E)
    codes_d = torch.from_numpy(codes).to(dev)
    plan = K.SLABS.get("routed_accumulate" + sfx)
    t = timed(d1)
    row_bytes = hit.numel() * E * item
    out["routed_accumulate" + sfx] = dict(
        max_abs_err=err, bound_ms=b, bound_by=why, parts=len(tables),
        window_columns=int(routed.shape[2]), hit_windows=hit.numel(),
        # the slab plan the wrapper launched (none recorded: one slab)
        **({} if plan is None else {
            "slabs": plan.n_slabs, "slab_cols": plan.cols,
            "load_bytes": plan.vec * item, "evict_last": plan.keep}),
        row_bytes=row_bytes, row_tb_s=row_bytes / (t["ms"] * 1e-3) / 1e12,
        # K2 on the unsplit table, the same reads: what the split saves
        unsplit_k2_ms=device_ms(lambda: K.accumulate_codes(
            whole.D, codes_d, eng.k, 4, whole.scale)),
        **t, plain_ms=cuda_ms(d1_plain, reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows_long, D32, mode="sum")))
    acc = got
    del D32

    kidx_a, alt_win, win_read, inv_w, is_mean = eng._expand_ambiguities_host(
        codes, mat, lens)
    errs = []
    for mean in (True, False):
        spec = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            kidx_a.astype(np.int32), window_offsets(alt_win, win_read.size),
            win_read.astype(np.int32), inv_w.astype(np.float32),
            np.full(win_read.size, mean, np.uint8))]
        alt_win_d = torch.from_numpy(alt_win.astype(np.int64)).to(dev)
        got = K.ambiguous_pass_split_(acc.clone(), parts, scale, *spec)
        want = K.ambiguous_pass(K.alt_delta_rows_split(tables, scale,
                                                       spec[0]),
                                alt_win_d, *spec[2:], acc)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(errs[-1] <= 2e-4 and torch.equal(got > 0, want > 0),
              f"A1 ambiguous_pass_split{sfx} (mean {mean}) disagrees with "
              f"its plain version (max abs err {errs[-1]})")
        if mean:
            mean_spec, mean_alt_win = spec, alt_win_d
    alt_rows = mean_spec[0]
    n_alt, n_w = alt_rows.numel(), mean_spec[2].numel()
    b, why = bound(torch.unique(alt_rows).numel() * E * item + n_alt * 4 +
                   n_w * 13 + 4 +
                   2 * torch.unique(mean_spec[2]).numel() * E * 4,
                   (n_alt + n_w) * E * 4)
    scratch = acc.clone()
    out["ambiguous_pass_split" + sfx] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why, windows=n_w,
        alternatives=n_alt, parts=len(tables),
        **ambiguous_launch(E, item, (t.data_ptr() for t in tables)),
        **timed(lambda: K.ambiguous_pass_split_(scratch, parts, scale,
                                                *mean_spec)),
        plain_ms=cuda_ms(lambda: K.ambiguous_pass(K.alt_delta_rows_split(
            tables, scale, alt_rows), mean_alt_win, *mean_spec[2:], acc)),
        library_ms=None)
    return out


def kmer_sharded_phase(db, mesh, seed: int, ref, n_batches: int = 10,
                       device: str = "cuda") -> tuple:
    """``KmerShardedPlacement`` on ``mesh``: C3 on shard 1 at a mesh row's
    slice of a B=16384 batch against its plain version, then
    ``n_batches`` batches back to back (launches counted), the first
    batch's first 512 reads held against the card's single compact engine
    (KmerShardedPlacement scores no ambiguity windows, so that engine runs
    with ``treat_ambiguities=False``)."""
    import numpy as np
    import torch

    from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (PlacementEngine,
                                               host_kmer_indices)

    t0 = time.perf_counter()
    ksp = KmerShardedPlacement(db, mesh)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 9)
    batches = [random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05, ref=ref)
               for _ in range(n_batches)]
    # PlacementEngine.encode_batch on these reads: ACGT -> 0-3, N -> -1
    # (ambiguous), the 0xFF padding -> -2
    tab = np.full(256, -2, np.int8)
    tab[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    tab[ord("N")] = -1
    coded = [(tab[m], ln) for m, ln in batches]

    # C3 on shard 1 ---------------------------------------------------- #
    dp, per = mesh.shape["dp"], ksp._per
    Bl = B_KERNEL // dp
    codes, lens = coded[0]
    rows = torch.from_numpy(ksp._lookup(host_kmer_indices(
        codes[:Bl], lens[:Bl], db.k, 4))).to(mesh.devices[0, 1])
    D = ksp.D[1][mesh.devices[0, 1]]
    E = D.shape[1]
    got = K.accumulate_rows_range(D, rows, per, per)
    want = K.accumulate_range(D, rows, per, per)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(held(got, want, False), f"C3 accumulate_rows_range disagrees with "
          f"its plain version (max abs err {err})")
    local = rows - per
    hit = local[(local >= 0) & (local < per)]
    check(hit.numel() > 0, "C3: no window hit shard 1")
    b, why = bound(rows.numel() * 4 + torch.unique(hit).numel() * E * 4 +
                   Bl * E * 4, (hit.numel() + Bl) * E)
    t = timed(lambda: K.accumulate_rows_range(D, rows, per, per))
    kern = {"accumulate_rows_range": dict(
        max_abs_err=err, bound_ms=b, bound_by=why, reads=Bl,
        hit_windows=hit.numel(), distinct_rows=torch.unique(hit).numel(),
        shard_bytes=D.nbytes, **t,
        **row_traffic(D, "accumulate_rows_range", hit.numel(), t["ms"]),
        plain_ms=cuda_ms(lambda: K.accumulate_range(D, rows, per, per),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            torch.where((rows - per >= 0) & (rows - per < per), rows - per,
                        per).long(), D, mode="sum"), reps=5))}

    # the main path: batches back to back ------------------------------ #
    ksp.score(*coded[0])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    results = [ksp.score(c, ln) for c, ln in coded]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: K.LAUNCHES[n] for n in ("accumulate_rows_range",
                                           "finalize_wire")}
    for name, n in launches.items():
        check(n > 0, f"k-mer-sharded phase: kernel {name} was never "
              "launched")
    codes, lens = coded[1]
    t1 = time.perf_counter()
    kidx = host_kmer_indices(codes, lens, db.k, 4)
    steps = {"kmer_indices": time.perf_counter() - t1}
    t1 = time.perf_counter()
    ksp._lookup(kidx)
    steps["key_search"] = time.perf_counter() - t1
    mat, lens = batches[0]
    single = PlacementEngine(db, device=device, table="compact",
                             treat_ambiguities=False)
    r0 = results[0]
    diff = same_placements(type(r0)(*(x[:512] for x in r0)),
                           single.score(mat[:512], lens[:512]))
    check(diff is None, f"k-mer-sharded phase vs the single compact "
          f"engine: {diff}")
    # the single engine on the same batches, for its reads/s
    t0 = time.perf_counter()
    pend = [single.score_async(m, ln) for m, ln in batches]
    for x in pend:
        x.result()
    single_dt = time.perf_counter() - t0
    return kern, {"reads_per_s": n_batches * B_KERNEL / dt, "seconds": dt,
                  "single_compact_reads_per_s": n_batches * B_KERNEL /
                  single_dt,
                  "setup_s": setup_s, "batches": n_batches,
                  "batch_size": B_KERNEL, "mesh": dict(mesh.shape),
                  "shard_rows": per + 1, "launches": launches,
                  "host_steps_s": steps}


def sharded_place_phase(db, mesh, work: Path, n_reads: int, seed: int,
                        names, device: str = "cuda") -> dict:
    """``place_queries`` (the pipeline behind the CLI, which on one card
    can only ask for a one-device engine) through the sharded engine on
    ``mesh`` and through the single card engine on the same reads file:
    the jplace files must hold the same placements (edge sets, scores
    within 2e-4, LWR within 1e-4)."""
    import numpy as np

    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.pipeline import (PlacementConfig,
                                                 place_queries)

    rng = np.random.default_rng(seed + 10)
    mat, lens = random_reads(rng, n_reads, n_reads // 100, 0.05)
    fasta = work / "sharded_reads.fasta"
    with open(fasta, "wb") as f:
        for i in range(n_reads):
            f.write(b">s%d\n" % i + mat[i, :lens[i]].tobytes() + b"\n")
    out = {}
    for tag, make in (("sharded", lambda: ShardedEngine(db, mesh)),
                      ("single", lambda: PlacementEngine(db, device=device))):
        eng = make()
        K.reset_launches()
        t0 = time.perf_counter()
        path = place_queries(db, fasta, work / f"place_{tag}",
                             PlacementConfig(batch_size=1024), engine=eng)
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "reads_per_s": n_reads / (time.perf_counter() - t0),
                    "launches": {n: K.LAUNCHES[n] for n in names},
                    "jplace": json.loads(path.read_text())}
        del eng
    for name, n in out["sharded"]["launches"].items():
        check(n > 0, f"sharded place phase: kernel {name} was never "
              "launched")
    a, b = out["sharded"].pop("jplace"), out["single"].pop("jplace")
    check(a["tree"] == b["tree"] and a["fields"] == b["fields"] and
          len(a["placements"]) == len(b["placements"]) > 0,
          "sharded place phase: jplace header or placement count differs")
    for pa, pb in zip(a["placements"], b["placements"]):
        check(pa["nm"] == pb["nm"], "sharded place phase: nm differs")
        ra = {r[0]: r for r in pa["p"]}
        rb = {r[0]: r for r in pb["p"]}
        near_tie = abs(pa["p"][-1][1] - pb["p"][-1][1]) <= 2e-4
        check(ra.keys() == rb.keys() or near_tie,
              f"sharded place phase: edges {sorted(ra)} vs {sorted(rb)}")
        for e in ra.keys() & rb.keys():
            check(abs(ra[e][1] - rb[e][1]) <= 2e-4 and
                  abs(ra[e][2] - rb[e][2]) <= 1e-4,
                  f"sharded place phase: edge {e} scores differ")
    out["reads"] = n_reads
    out["placements"] = len(a["placements"])
    return out


def engine_phase(db, seed: int, names, batch: int = B_KERNEL,
                 n_batches: int = 10, length: int = READ_LEN,
                 letters: bytes = b"ACGT", n_ambiguous: int | None = None,
                 ref=None, engine_kw=None, against=None,
                 device: str = "cuda", mesh=None, engine=None,
                 engine_cls=None, prepare=None, inspect=None,
                 absent=()) -> dict:
    """``n_batches`` batches back to back through ``score_async`` (a few
    in flight) of ``engine_cls(db, **engine_kw)`` (default
    ``PlacementEngine``; with ``mesh``: ``ShardedEngine(db, mesh,
    **engine_kw)``), ``prepare(engine)`` applied first; every kernel in
    ``names`` must launch and none in ``absent``; ``inspect(engine,
    handles)`` (the type names of the ``score_async`` handles) checks the
    path that ran and returns what to report.  The first batch's first
    512 reads are held against the one-device engine of the same class on
    the CPU and, with ``against = (kw, tol_score[, cls])``, against the
    card's ``cls(db, **kw)`` with scores within ``tol_score`` (LWR not
    held when it passes 2e-4).  An ``engine`` already built on ``mesh``
    is driven as it is."""
    import numpy as np
    import torch

    from rappas_tpu_torch import native
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine

    kw = engine_kw or {}
    cls = engine_cls or PlacementEngine
    rng = np.random.default_rng(seed + 2)
    n_amb = batch // 100 if n_ambiguous is None else n_ambiguous
    batches = [random_reads(rng, batch, n_amb, 0.05, length, letters, ref)
               for _ in range(n_batches)]
    t0 = time.perf_counter()
    eng = engine or (cls(db, device=device, **kw) if mesh is None
                     else ShardedEngine(db, mesh, **kw))
    if prepare is not None:
        prepare(eng)
    setup_s = time.perf_counter() - t0
    eng.score(*batches[0])                    # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    native.PROBE_CALLS["probe_rows"] = 0
    t0 = time.perf_counter()
    pend, results, handles = [], [], set()
    issue_s = 0.0      # host time inside score_async: encode, lookups,
    for mat, lens in batches:      # expansion, stage, enqueue
        t1 = time.perf_counter()
        pend.append(eng.score_async(mat, lens))
        issue_s += time.perf_counter() - t1
        handles.add(type(pend[-1]).__name__)
        if len(pend) > 3:
            results.append(pend.pop(0).result())
    results.extend(p.result() for p in pend)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: K.LAUNCHES[n] for n in names + tuple(absent)}
    probes = native.PROBE_CALLS["probe_rows"]
    for name in names:
        check(launches[name] > 0,
              f"engine phase: kernel {name} was never launched")
    for name in absent:
        check(launches[name] == 0, f"engine phase: kernel {name} was "
              f"launched {launches[name]} times off this path")
    path = inspect(eng, handles) if inspect is not None else None
    steps = {}
    if eng.table == "postings" and mesh is None:
        # the postings host side on one batch, each step timed once on
        # the host clock: encode, window -> row lookup, ambiguity
        # expansion, and all of postings_inputs (which repeats both)
        mat, lens = batches[1]
        t1 = time.perf_counter()
        codes = eng.encode_batch(mat)
        steps["encode"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        eng._rows_from_codes(codes, lens)
        steps["row_lookup"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        eng._expand_ambiguities_host(codes, mat, lens)
        steps["ambiguity_expansion"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host, _ = eng.postings_inputs(codes, mat, lens)
        steps["postings_inputs"] = time.perf_counter() - t1
        per_read = eng._light_counts[host["lrows"]].sum(axis=1)
        steps["postings_per_read_mean"] = float(per_read.mean())
        steps["postings_per_read_max"] = int(per_read.max())
        if eng._light_slow or len(eng.light_parts) > 1:
            # the split table's row source: routing, or the batch-unique
            # rows and their inverse map
            t1 = time.perf_counter()
            eng._light_source(host)
            steps["light_source"] = time.perf_counter() - t1
    elif eng.table == "postings":
        steps = sharded_postings_host_steps(eng, *batches[1])
    elif getattr(eng, "direct_parts", None) is not None:
        steps = direct_split_host_steps(eng, *batches[1])
    table, keys_on_card = eng.table, getattr(eng, "keys_dev", None) is not None
    del eng
    mat, lens = batches[0]
    r0 = results[0]
    sub = type(r0)(*(x[:512] for x in r0))
    cpu = cls(db, device="cpu", **kw)
    if prepare is not None:
        prepare(cpu)
    diff = same_placements(sub, cpu.score(mat[:512], lens[:512]))
    del cpu
    check(diff is None, f"engine phase: card vs CPU engine: {diff}")
    same_bits = None
    if against is not None:
        other_kw, tol, *other_cls = against
        other = (other_cls[0] if other_cls else PlacementEngine)(
            db, device=device, **other_kw).score(mat[:512], lens[:512])
        diff = same_placements(sub, other, tol,
                               1e-4 if tol <= 2e-4 else None)
        check(diff is None, f"engine phase: {cls.__name__}({kw}) vs "
              f"{other_kw} on the card: {diff}")
        same_bits = bool(np.array_equal(sub.top_edges, other.top_edges) and
                         np.array_equal(sub.top_scores.view(np.uint32),
                                        other.top_scores.view(np.uint32)))
    return {"table": table, "keys_on_card": keys_on_card,
            "engine": cls.__name__,
            "mesh": None if mesh is None else dict(mesh.shape),
            "reads_per_s": n_batches * batch / dt,
            "seconds": dt, "score_async_s": issue_s, "setup_s": setup_s,
            "batches": n_batches, "batch_size": batch, "launches": launches,
            "handles": sorted(handles), "path": path,
            "bitwise_vs_against": same_bits,
            "probe_rows_calls": probes, "host_steps_s": steps}


def direct_split_host_steps(eng, mat, lens) -> dict:
    """The split direct engine's host steps on one batch, each timed once
    on the host clock: encode, the k-mer indices, the routing of the
    windows to the parts, the ambiguity expansion."""
    import numpy as np

    from rappas_tpu_torch.place.engine import host_kmer_indices

    steps = {}
    t1 = time.perf_counter()
    codes = eng.encode_batch(mat)
    steps["encode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    kidx = host_kmer_indices(codes, lens, eng.k, eng.alphabet.n_states)
    steps["kmer_indices"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    eng._route_direct(np.where(kidx >= 0, kidx, eng.n_rows - 1))
    steps["route"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    eng._expand_ambiguities_host(codes, mat, lens)
    steps["ambiguity_expansion"] = time.perf_counter() - t1
    return steps


def sharded_postings_host_steps(eng, mat, lens) -> dict:
    """The sharded postings engine's host steps on one batch, each timed
    on the host clock: encode, ambiguity expansion, the batch's k-mer
    indices (once), and summed over the (slice, shard) pairs the shard's
    row lookup (one fancy index into its direct row table) and
    ``postings_batch``."""
    import numpy as np

    from rappas_tpu_torch.parallel.mesh import dp_slices
    from rappas_tpu_torch.parallel.postings_sharded import \
        slice_ambiguities
    from rappas_tpu_torch.place.engine import (alt_rows_of,
                                               host_kmer_indices,
                                               postings_batch)

    S, k = eng.alphabet.n_states, eng.k
    steps = {}
    t1 = time.perf_counter()
    codes = eng.encode_batch(mat)
    steps["encode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    amb = eng._expand_ambiguities_host(codes, mat, lens)
    steps["ambiguity_expansion"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    kidx = host_kmer_indices(codes, lens, k, S)
    kidx = np.where(kidx >= 0, kidx, S ** k)
    steps["kmer_indices"] = time.perf_counter() - t1
    steps["shard_row_lookup"] = steps["postings_batch"] = 0.0
    for _, sl in dp_slices(eng.mesh, mat.shape[0]):
        a = slice_ambiguities(amb, sl.start, sl.stop)
        for sh in eng._postings._shards:
            t1 = time.perf_counter()
            rof = sh["rof"][kidx[sl]]
            steps["shard_row_lookup"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            postings_batch(rof, sh["nl"], sh["light_counts"], lens[sl], a,
                           None if a is None else alt_rows_of(
                               sh["rof"][a[0]], sh["nl"], sh["nh"]))
            steps["postings_batch"] += time.perf_counter() - t1
    return steps


def host_steps(db, seed: int) -> dict:
    """The direct engine's host steps on one 16384-read batch, each timed
    once on the host clock: ASCII encode, the per-read split and 2-bit
    packing, the ambiguity expansion."""
    import numpy as np

    from rappas_tpu_torch.place.engine import PlacementEngine, pack_reads

    eng = PlacementEngine(db, device="cpu")
    mat, lens = random_reads(np.random.default_rng(seed + 5), B_KERNEL,
                             B_KERNEL // 100, 0.05)
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
    return steps


def cli_phase(db, db_path: Path, work: Path, n_reads: int, seed: int,
              names, ref=None, precision: str = "f32",
              device: str = "cuda") -> dict:
    import numpy as np

    from rappas_tpu_torch import cli
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine

    rng = np.random.default_rng(seed + 3)
    n_unique = n_reads - n_reads // 10
    mat, lens = random_reads(rng, n_unique, n_unique // 100, 0.05, ref=ref)
    src = np.concatenate([np.arange(n_unique),
                          rng.integers(0, n_unique, n_reads - n_unique)])
    fasta = work / "reads.fasta"
    with open(fasta, "wb") as f:
        for i, s in enumerate(src.tolist()):
            f.write(b">r%d src=%d\n" % (i, s) +
                    mat[s, :lens[s]].tobytes() + b"\n")
    wd = work / f"cli_{db_path.stem}_{precision}"
    K.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-p", "p", "-d", str(db_path), "-q", str(fasta),
                   "-w", str(wd), "--table", "auto", "--precision",
                   precision, "--device", device])
    dt = time.perf_counter() - t0
    launches = {n: K.LAUNCHES[n] for n in names}
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
    ref = PlacementEngine(db, device="cpu", precision=precision).score(
        mat[idx], lens[idx])
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
#: the kernels each main-path run must launch
DIRECT = ("accumulate_packed", "accumulate_codes", "finalize_wire",
          "ambiguous_pass")
DIRECT_U16 = ("accumulate_packed_u16", "accumulate_codes_u16",
              "finalize_wire", "ambiguous_pass_u16")
POSTINGS = ("dense_side", "ambiguous_postings", "finalize_postings_wire")
COMPACT = ("accumulate_compact", "finalize_wire", "ambiguous_pass")
COMPACT_U16 = ("accumulate_compact_u16", "finalize_wire",
               "ambiguous_pass_u16")
HOST_ROWS = ("accumulate_rows", "finalize_wire", "ambiguous_pass")
HOST_ROWS_U16 = ("accumulate_rows_u16", "finalize_wire",
                 "ambiguous_pass_u16")
POSTINGS_SHARDED = POSTINGS + ("merge_candidates_wire",)
#: the split light table's paths: routed (the default), two-stage (and
#: pipelined), the select fallback; the split direct table
POSTINGS_ROUTED = ("dense_side", "ambiguous_postings_parts",
                   "finalize_postings_wire_routed")
TWO_STAGE = ("dense_side", "ambiguous_postings_parts", "gather_compact",
             "finalize_postings_wire")
SELECT = ("dense_side", "ambiguous_postings_parts",
          "finalize_postings_wire_parts")
SPLIT_POSTINGS = ("ambiguous_postings_parts", "finalize_postings_wire_routed",
                  "gather_compact", "finalize_postings_wire_parts")
SPLIT_DIRECT = ("routed_accumulate", "ambiguous_pass_split", "finalize_wire")
SPLIT_DIRECT_U16 = ("routed_accumulate_u16", "ambiguous_pass_split_u16",
                    "finalize_wire")
#: kernel instance -> (source in csrc/, the JAX functions it replaces,
#: the main-path run whose launches its line reports)
_E = "rappas_tpu/place/engine.py:"
_KS = "rappas_tpu/parallel/kmer_sharded.py:"
_PS = "rappas_tpu/parallel/postings_sharded.py:"
SOURCES = {
    "accumulate_packed": ("accumulate.cu", _E + "253,195", "config1", "cli"),
    "accumulate_codes": ("accumulate.cu", _E + "175,195", "config1", "cli"),
    "finalize_wire": ("finalize.cu", _E + "453,68", "config1", "cli"),
    "ambiguous_pass": ("ambiguous.cu", _E + "907,967,1005", "config1",
                       "cli"),
    "dense_side": ("postings.cu", _E + "484,773", "config5", "cli"),
    "ambiguous_postings": ("ambiguous.cu", _E + "950,967,1433",
                           "config5_one", "engine"),
    "finalize_postings_wire": ("postings.cu", _E + "654,684,68",
                               "config5_one", "engine"),
    "accumulate_packed_u16": ("accumulate.cu", _E + "253,195",
                              "config1_u16", "cli"),
    "accumulate_codes_u16": ("accumulate.cu", _E + "175,195", "config1_u16",
                             "cli"),
    "ambiguous_pass_u16": ("ambiguous.cu", _E + "907,967,1005",
                           "config1_u16", "cli"),
    "accumulate_compact": ("accumulate.cu", _E + "278,300,195",
                           "config1_compact", "engine"),
    "accumulate_compact_config1": ("accumulate.cu", _E + "278,300,195",
                                   "config1_compact", "engine"),
    "accumulate_compact_u16": ("accumulate.cu", _E + "278,300,195",
                               "config6", "cli"),
    "accumulate_rows": ("accumulate.cu", _E + "195", "config4_compact",
                        "engine"),
    "accumulate_rows_u16": ("accumulate.cu", _E + "195", "config4_u16",
                            "engine"),
    "accumulate_rows_range": ("accumulate.cu", _KS + "84,76-80,82",
                              "config6_kmer_sharded", "engine"),
    "ambiguous_postings_offset": ("ambiguous.cu", _PS + "223,170-180",
                                  "config5_sharded", "engine"),
    "finalize_postings_wire_offset": ("postings.cu", _PS + "217,223,188",
                                      "config5_sharded", "engine"),
    "merge_candidates_wire": ("merge.cu", _PS + "217,223,192-206",
                              "config5_sharded", "engine"),
    "finalize_postings_wire_routed": ("postings.cu", _E + "609,632,68",
                                      "config5", "cli"),
    "finalize_postings_wire_parts": ("postings.cu", _E + "654-681,535,68",
                                     "config5_select", "engine"),
    "gather_compact": ("postings.cu", _E + "557,566", "config5_two_stage",
                       "engine"),
    "ambiguous_postings_parts": ("ambiguous.cu", _E + "950,654-681,967",
                                 "config5", "cli"),
    "routed_accumulate": ("accumulate.cu", _E + "915", "config2_split",
                          "engine"),
    "routed_accumulate_u16": ("accumulate.cu", _E + "915",
                              "config2_split_u16", "engine"),
    "ambiguous_pass_split": ("ambiguous.cu", _E + "931,967,1005",
                             "config2_split", "engine"),
    "ambiguous_pass_split_u16": ("ambiguous.cu", _E + "931,967,1005",
                                 "config2_split_u16", "engine"),
}
#: kernel-line rows of an instance counted under its kernel's name
LAUNCH_KEY = {"accumulate_compact_config1": "accumulate_compact",
              "ambiguous_postings_offset": "ambiguous_postings",
              "finalize_postings_wire_offset": "finalize_postings_wire"}
PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
#: reads of the u16 CLI phases (configs 1 and 6) and of the config-1
#: sharded place_queries phase
CLI_READS_U16 = 20_000


def engine_class(name: str, **consts):
    """A ``PlacementEngine`` with other values of its constants (the split
    budgets have no CLI flag, as in JAX)."""
    from rappas_tpu_torch.place.engine import PlacementEngine
    return type(name, (PlacementEngine,), consts)


def path_check(handle: str, light_parts=None, direct_parts=None):
    """An ``engine_phase`` inspection: every handle of the run is a
    ``handle``, the light or direct table is in that many parts, and a
    pipeline's tail was flushed."""
    def inspect(eng, handles):
        check(handles == {handle}, f"the run's handles are {handles}, not "
              f"{handle}")
        got = {"light_parts": len(eng.light_parts),
               "direct_parts": len(eng.direct_parts or ())}
        want = {"light_parts": light_parts, "direct_parts": direct_parts}
        for key, n in want.items():
            check(n is None or got[key] == n, f"{key}: {got[key]}, not {n}")
        check(eng._pp_tail is None, "the pipeline's tail was not flushed")
        return dict(got, handle=handle, routed=eng._routed_windows,
                    pipelined=eng._pp_enabled)
    return inspect


def smoke_mesh():
    """The (dp=2, mp=2) mesh of the sharded phases: four distinct cards
    where the machine has them, else the one card repeated."""
    import torch

    from rappas_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if n >= 4 else ["cuda:0"] * 4
    return make_mesh(devices, dp=2, mp=2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cli-reads", type=int, default=50_000)
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
        from rappas_tpu_torch.parallel.engine import ShardedEngine
        from rappas_tpu_torch.place.engine import PlacementEngine
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

    def make_db(name, recipe, work):
        t0 = time.perf_counter()
        db = recipe(args.seed)
        path = work / f"{name}.rptpu"
        db.save(path)
        db = PhyloKmerDB.load(path)
        print(f"{name} DB: k={db.k}, {db.n_edge_slots} edge slots, "
              f"{db.n_kmers} k-mers, {db.nnz} postings "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return db, path

    def show(tag, r):
        print(f"{tag}: {json.dumps(r)}", flush=True)

    results = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        # config 1: direct layout ---------------------------------- #
        db, path = make_db("config1", config1_db, work)
        kern = kernel_phase(db, args.seed)
        for name, r in kern.items():
            show(f"kernel {name}", r)
        eng = engine_phase(db, args.seed, DIRECT)
        eng["host_steps_s"] = host_steps(db, args.seed)
        show("config1 engine", eng)
        cl = cli_phase(db, path, work, args.cli_reads, args.seed, DIRECT)
        show("config1 cli", cl)
        results["config1"] = {"engine": eng, "cli": cl}

        # config 1 at u16 (direct) and compact f32 ------------------ #
        ku = kernel_phase(db, args.seed, "u16")
        for name, r in ku.items():
            show(f"kernel {name}", r)
        kern.update(ku)
        eng = engine_phase(db, args.seed, DIRECT_U16,
                           engine_kw={"precision": "u16"},
                           against=({}, 5e-3))
        check(eng["table"] == "direct", f"config 1 u16: {eng['table']}")
        show("config1 u16 engine", eng)
        cl = cli_phase(db, path, work, CLI_READS_U16, args.seed, DIRECT_U16,
                       precision="u16")
        show("config1 u16 cli", cl)
        results["config1_u16"] = {"engine": eng, "cli": cl}
        ceng = PlacementEngine(db, device="cuda", table="compact")
        ck = compact_kernel_phase(ceng, args.seed, tag="_config1")
        del ceng
        check(ck["accumulate_compact_config1"]["resolve_pass"],
              "config 1 compact: C1 launched one slab, no resolve pass")
        for name, r in ck.items():
            show(f"kernel {name}", r)
        kern.update(ck)
        eng = engine_phase(db, args.seed, COMPACT,
                           engine_kw={"table": "compact"},
                           against=({}, 2e-4))
        check(eng["keys_on_card"], "config 1 compact: keys not on the card")
        show("config1 compact engine", eng)
        results["config1_compact"] = {"engine": eng}

        # config 1 on a (dp=2, mp=2) mesh: two 150-column shards -------- #
        mesh = smoke_mesh()
        eng = engine_phase(db, args.seed, DIRECT, mesh=mesh)
        check(eng["table"] == "direct", f"config 1 sharded: {eng['table']}")
        show("config1 sharded engine", eng)
        pl = sharded_place_phase(db, mesh, work, CLI_READS_U16, args.seed,
                                 DIRECT)
        show("config1 sharded place_queries", pl)
        results["config1_sharded"] = {"engine": eng, "place": pl}

        # config 2: the direct table height-split (k=10) ------------ #
        db, path = make_db("config2", config2_db, work)
        chain2 = key_chain(db, args.seed)
        Split2 = engine_class("DirectSplit", DIRECT_SPLIT_MIN=0)
        for precision, n_parts in (("f32", 13), ("u16", 7)):
            t0 = time.perf_counter()
            whole = PlacementEngine(db, device="cuda", table="direct",
                                    precision=precision)
            split = Split2(db, device="cuda", table="direct",
                           precision=precision)
            check(len(split.direct_parts) == n_parts and split.D is None,
                  f"config 2 {precision}: {len(split.direct_parts)} parts, "
                  f"not {n_parts}")
            print(f"config2 {precision} set-up {time.perf_counter() - t0:.1f}"
                  f" s: table {tuple(whole.D.shape)} "
                  f"{whole.D.nbytes / 1e6:.0f} MB whole, "
                  f"{len(split.direct_parts)} parts of "
                  f"{split.direct_parts[0].nbytes / 1e6:.0f} MB", flush=True)
            k2 = split_direct_kernel_phase(split, whole, args.seed, chain2)
            del whole, split
            for name, r in k2.items():
                show(f"kernel {name}", r)
            kern.update(k2)
        e2 = engine_phase(db, args.seed, DIRECT, ref=chain2,
                          engine_kw={"table": "direct"})
        show("config2 engine", e2)
        e2s = engine_phase(db, args.seed, SPLIT_DIRECT, ref=chain2,
                           engine_cls=Split2, engine_kw={"table": "direct"},
                           against=({"table": "direct"}, 2e-4),
                           absent=("accumulate_packed", "accumulate_codes",
                                   "ambiguous_pass"),
                           inspect=path_check("PendingBatch",
                                              direct_parts=13))
        show("config2 split engine", e2s)
        kw16 = {"table": "direct", "precision": "u16"}
        e2u = engine_phase(db, args.seed, SPLIT_DIRECT_U16, ref=chain2,
                           engine_cls=Split2, engine_kw=kw16,
                           against=(kw16, 2e-4),
                           absent=("accumulate_packed_u16",
                                   "accumulate_codes_u16",
                                   "ambiguous_pass_u16"),
                           inspect=path_check("PendingBatch",
                                              direct_parts=7))
        show("config2 split u16 engine", e2u)
        results["config2"] = {"engine": e2}
        results["config2_split"] = {"engine": e2s}
        results["config2_split_u16"] = {"engine": e2u}
        del db

        # config 5: postings layout, large tree --------------------- #
        db, path = make_db("config5", config5_db, work)
        OneTable = engine_class("OneTable", LIGHT_SPLIT_BYTES=1 << 62)
        t0 = time.perf_counter()
        peng = OneTable(db, device="cuda")
        check(peng.table == "postings" and peng._rof_np is not None and
              len(peng.light_parts) == 1,
              f"config 5 resolved to {peng.table}, not postings on one "
              "light table with a direct index")
        print(f"config5 engine set-up {time.perf_counter() - t0:.1f} s: "
              f"light table {tuple(peng.pairs.shape)} "
              f"{peng.pairs.nbytes / 1e6:.0f} MB, heavy_dense "
              f"{tuple(peng.heavy_dense.shape)} "
              f"{peng.heavy_dense.nbytes / 1e6:.0f} MB on the card, "
              f"direct index {peng._rof_np.nbytes / 1e6:.0f} MB on the "
              "host", flush=True)
        ref = config5_reference(args.seed)
        pk = postings_kernel_phase(peng, args.seed, ref)
        # the default engine: the 128 MB light table in 2 routed parts
        deng = PlacementEngine(db, device="cuda")
        check(len(deng.light_parts) == 2 and deng._routed_windows,
              f"config 5 default: {len(deng.light_parts)} light parts, "
              f"routed {deng._routed_windows}")
        pk.update(split_postings_kernel_phase(deng, peng, args.seed, ref))
        del peng, deng
        for name, r in pk.items():
            show(f"kernel {name}", r)
        kern.update(pk)
        against = ({}, 2e-4, OneTable)
        two_parts = path_check("PendingBatch", light_parts=2)
        eng5 = engine_phase(db, args.seed, POSTINGS_ROUTED, batch=B_POSTINGS,
                            ref=ref, against=against, inspect=two_parts,
                            absent=("ambiguous_postings",
                                    "finalize_postings_wire",
                                    "gather_compact"))
        show("config5 engine", eng5)
        one5 = engine_phase(db, args.seed, POSTINGS, batch=B_POSTINGS,
                            ref=ref, engine_cls=OneTable,
                            absent=SPLIT_POSTINGS,
                            inspect=path_check("PendingBatch",
                                               light_parts=1))
        show("config5 one-table engine", one5)
        cl5 = cli_phase(db, path, work, args.cli_reads, args.seed,
                        POSTINGS_ROUTED, ref)
        show("config5 cli", cl5)
        results["config5"] = {"engine": eng5, "cli": cl5}
        results["config5_one"] = {"engine": one5}
        for tag, names, cls, prep, inspect, kw in (
                ("two_stage", TWO_STAGE, None,
                 lambda e: e.enable_routed_windows(False), two_parts, {}),
                ("pipelined", TWO_STAGE, None, lambda e: e.enable_pipeline(),
                 path_check("PipelinedBatch", light_parts=2), {}),
                ("four_parts", POSTINGS_ROUTED,
                 engine_class("FourParts", LIGHT_SPLIT_BYTES=32 << 20), None,
                 path_check("PendingBatch", light_parts=4), {}),
                ("select", SELECT,
                 engine_class("SelectFallback", TWO_STAGE_MAX_UNIQUE=0),
                 lambda e: e.enable_routed_windows(False),
                 path_check("SplitPending", light_parts=2),
                 {"n_batches": 3}),
                ("ambiguity_max", POSTINGS_ROUTED, None, None, two_parts,
                 {"n_batches": 3, "n_ambiguous": B_POSTINGS // 10,
                  "engine_kw": {"ambiguities_with_max": True}})):
            other = kw.get("engine_kw", {})
            e = engine_phase(db, args.seed, names, batch=B_POSTINGS, ref=ref,
                             engine_cls=cls, prepare=prep, inspect=inspect,
                             against=(other, 2e-4, OneTable), **kw)
            show(f"config5 {tag} engine", e)
            results[f"config5_{tag}"] = {"engine": e}

        # config 5 on the mesh: two edge ranges of 4,000 edges --------- #
        t0 = time.perf_counter()
        seng = ShardedEngine(db, mesh)
        setup = time.perf_counter() - t0
        check(seng.table == "postings", f"config 5 sharded: {seng.table}")
        shapes = [(tuple(t.shape) for t in (sh["pairs"][dev],
                                             sh["heavy_dense"][dev]))
                  for sh, dev in zip(seng._postings._shards,
                                     mesh.devices[0])]
        print(f"config5 sharded set-up {setup:.1f} s: edge ranges "
              f"{seng._postings._bounds.tolist()}, (light, heavy) tables "
              f"{[tuple(x) for x in shapes]}", flush=True)
        sk = sharded_postings_kernel_phase(seng._postings, seng, args.seed,
                                           ref)
        for name, r in sk.items():
            show(f"kernel {name}", r)
        kern.update(sk)
        e5s = engine_phase(db, args.seed, POSTINGS_SHARDED,
                           batch=B_POSTINGS, ref=ref, mesh=mesh,
                           engine=seng)
        e5s["setup_s"] = setup
        del seng
        show("config5 sharded engine", e5s)
        results["config5_sharded"] = {"engine": e5s}
        del db

        # config 6: k=12 on 300 edge slots, u16 -> compact ---------- #
        db, path = make_db("config6", config6_db, work)
        limit = PlacementEngine.DIRECT_BYTE_LIMIT
        got = {p: PlacementEngine.resolve_table(db, "auto", p, limit)
               for p in ("f32", "u16")}
        check(got == {"f32": "postings", "u16": "compact"},
              f"config 6 resolves to {got}")
        for precision in ("f32", "u16"):
            t0 = time.perf_counter()
            ceng = PlacementEngine(db, device="cuda", table="compact",
                                   precision=precision)
            print(f"config6 compact {precision} set-up "
                  f"{time.perf_counter() - t0:.1f} s: table "
                  f"{tuple(ceng.D.shape)} {ceng.D.nbytes / 1e6:.0f} MB, "
                  f"keys {ceng.keys_dev.nbytes / 1e6:.0f} MB on the card",
                  flush=True)
            ck = compact_kernel_phase(ceng, args.seed, ref)
            del ceng
            for name, r in ck.items():
                show(f"kernel {name}", r)
            kern.update(ck)
        eng6 = engine_phase(db, args.seed, COMPACT_U16, ref=ref,
                            engine_kw={"precision": "u16"})
        check(eng6["table"] == "compact" and eng6["keys_on_card"],
              f"config 6 u16: table {eng6['table']}, keys on the card "
              f"{eng6['keys_on_card']}")
        show("config6 engine", eng6)
        cl6 = cli_phase(db, path, work, CLI_READS_U16, args.seed,
                        COMPACT_U16, ref, precision="u16")
        show("config6 cli", cl6)
        results["config6"] = {"engine": eng6, "cli": cl6}

        # config 6 on the mesh: k-mer ranges, and compact columns ------ #
        kk, ke = kmer_sharded_phase(db, mesh, args.seed, ref)
        for name, r in kk.items():
            show(f"kernel {name}", r)
        kern.update(kk)
        show("config6 k-mer-sharded engine", ke)
        results["config6_kmer_sharded"] = {"engine": ke}
        e6s = engine_phase(db, args.seed, COMPACT, ref=ref, mesh=mesh,
                           engine_kw={"table": "compact"})
        check(e6s["table"] == "compact" and e6s["keys_on_card"],
              f"config 6 sharded: table {e6s['table']}, keys on the card "
              f"{e6s['keys_on_card']}")
        show("config6 sharded compact engine", e6s)
        results["config6_sharded"] = {"engine": e6s}
        del db

        # config 4: protein postings, native key probe -------------- #
        db, path = make_db("config4", config4_db, work)
        eng4 = engine_phase(db, args.seed, ("finalize_postings_wire",),
                            n_batches=4, length=100, letters=PROTEIN)
        check(eng4["table"] == "postings" and eng4["probe_rows_calls"] > 0,
              f"config 4: table {eng4['table']}, probe_rows calls "
              f"{eng4['probe_rows_calls']}")
        show("config4 engine", eng4)
        results["config4"] = {"engine": eng4}

        # config 4 compact: 20^8 > 2^31, the host searches the keys - #
        chain = key_chain(db, args.seed)
        for precision in ("f32", "u16"):
            ceng = PlacementEngine(db, device="cuda", table="compact",
                                   precision=precision)
            ck = compact_kernel_phase(ceng, args.seed, chain, 100, PROTEIN)
            del ceng
            for name, r in ck.items():
                show(f"kernel {name}", r)
            kern.update(ck)
        for tag, names, kw in (("u16", HOST_ROWS_U16, {"precision": "u16"}),
                               ("compact", HOST_ROWS, {"table": "compact"})):
            e = engine_phase(db, args.seed, names, n_batches=4, length=100,
                             letters=PROTEIN, ref=chain, engine_kw=kw)
            check(e["table"] == "compact" and not e["keys_on_card"],
                  f"config 4 {tag}: table {e['table']}, keys on the card "
                  f"{e['keys_on_card']}")
            show(f"config4 {tag} engine", e)
            results[f"config4_{tag}"] = {"engine": e}
    results["kernels"] = kern

    rows = []
    for name, (src, replaces, cfg, phase) in SOURCES.items():
        r = kern[name]
        key = LAUNCH_KEY.get(name, name)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"rappas_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": results[cfg][phase]["launches"][key],
            "engine_launches": results[cfg]["engine"]["launches"][key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in ("call_ms", "row_tb_s", "slabs",
                                       "evict_last",
                                       "resolve_pass", "paths",
                                       "light_only_windows",
                                       "max_pairs_per_window",
                                       "load_bytes", "threads_per_window")
               if key in r}})
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
