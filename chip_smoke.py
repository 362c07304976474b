#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rappas_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--cli-reads 50000] [--json-out F]

It needs one card, builds the CUDA kernels from ``rappas_tpu_torch/csrc``
(into ``rappas_tpu_torch/_build/``), drives ``-p b`` (the DB build) and
``-p p`` placement on DBs made from the seed, at the widths of five
configurations, in every table layout, precision and height split a
single device resolves to:

* the build phase, first:
  1. ``python -m rappas_tpu_torch.cli -p b --ardir`` on the canned
     RAxML-ng fixture (``tests/fixtures/raxmlng_ardir``) in a
     subprocess: its DB must equal ``expected_db.npz`` bitwise;
  2. ``synthetic_ardir`` at config 1's widths (150 taxa x 1,500 sites,
     596 ghost nodes tested, E = 299) through ``-p b --ardir
     --calibration`` on the card: the build's stages timed, the
     reference protocol's 1,000,000 random reads of mean length 150
     scored on the compact table ``table="auto"`` takes, by C1
     accumulate_compact and K3 finalize_wire (both must launch, K1 and
     K2 never), the header bound finite;
  3. ``calibrate`` on that DB at 65,536 reads on the card and on the
     CPU: the bounds within two f32 ulps (the distance they had when
     calibration ran K1 on the direct table), C1 and K3 launched; then
     C1, K1 (on the direct table) and K3 timed at calibration's own
     shape, its first 8,192 reads of width 225, C1's sums held to K1's;
  4. a CLI phase (``-p p``, 20k reads, half from the leaf sequences, the
     calibrated bound switched off so that every read is counted) on it:
     such reads hit every window, their accumulators reach ~440, where
     two f32 summation orders differ by more than 2e-4, so the first 512
     placements of the card's jplace and of the CPU engine are each held
     against the f64 sums of the same postings
     (``rappas_tpu_torch.place.oracle.exact_scores``), with the f64 top
     edges apart from near ties at the cut: the CPU engine within 2e-4,
     the card within 2e-4 plus its f32 running sums' error bound
     (``card_tolerance``);
  5. 128 clean reads cut from the leaves through the card's engine, the
     CPU engine and the port's serial oracle, each against f64 with the
     same gates; the oracle's distance (Java's f32 order) is reported;
* config 1, the direct layout asked for (k=8, E=300 edge slots, a table
  ``D[4^8 + 1, 300]`` f32 of 79 MB, 150 bp reads; ``table="auto"`` takes
  the compact table, step 8):
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
  3. CLI phase -- ``python -m rappas_tpu_torch.cli -p p --table direct``
     on 50k reads with duplicates and N's; the jplace is parsed and its
     placements held against the CPU engine;
  4. oracle phase -- the engine phase's first 512 reads on the card's
     ``auto`` engine against the port's serial oracle
     (``place/oracle.py``) with the tests' gate: ``|L|`` and edge sets
     identical, scores within 2e-4, LWR within 1e-4;
  5. profile phase -- the CLI on 20k reads without and with ``--profile
     DIR``: the ``*.pt.trace.json`` must account for every launch of
     K1-K4 the wrappers counted (its kernel record, or its runtime launch
     record where the profiler lost the kernel record), and the card's
     busy share (the union of kernel and copy intervals over the profiled
     window) and its kernels' share are reported beside both runs'
     reads/s;
  6. u16 (``precision="u16"``: ``D`` uint16 ``[4^8 + 1, 300]``, 39 MB)
     -- K1, K2 and K4 on the uint16 table against their plain versions,
     an engine phase whose 512 reads are also held against the card's
     f32 engine within 5e-3, and a CLI phase (``--precision u16``, 20k
     reads);
  7. compact f32 (``table="compact"``: ``D[39,322, 300]``, 47 MB, the
     int32 keys on the card) -- C1 accumulate_compact at B=16384 against
     its plain version (2 slabs: the rows resolved once by a resolve
     pass, then summed slab by slab), and an engine phase through C1
     whose placements must equal the direct engine's;
  8. layout phase -- engine phases through ``table="auto"`` (compact,
     the layout ``PlacementEngine.resolve_table``'s H100 rule takes) and
     through the layout the rule took before (direct), the auto engine's
     512 reads held against the CPU engine and against the other layout
     on the card (``|L|`` and edge sets identical, scores within 2e-4);
     each layout's set-up seconds, MB on the card and engine reads/s
     printed, no time asserted;
* config 2, the direct table height-split (``bench.py:60-84``'s recipe
  at k=10, 5% of the k-mers present: ``D[4^10 + 1, 300]``, 1.26 GB f32
  in 13 parts of 100 MB, 629 MB u16 in 7; ``DIRECT_SPLIT_MIN`` and
  ``DIRECT_PART_BYTES`` set on a subclass, as the default never splits):
  D1 routed_accumulate and A1 ambiguous_pass_split (f32 and u16) against
  their plain versions, then engine phases of the unsplit direct engine
  and of the split f32 and u16 engines on the same batches, the split
  ones held against the unsplit; half of each batch from a chain of DB
  k-mers; then a layout phase, auto (compact) against postings;
* config 5, the postings layout (k=12, a 4000-taxon star: E=7999; 2M
  light k-mers with 1-7 postings, 10k heavy ones with 32-199, as
  ``scripts/scale_check.py:21-48`` builds it, with every 12-mer of a
  400 kb reference among the keys): kernel phases for P1 dense_side,
  P2 ambiguous_postings and P3 finalize_postings_wire on the one light
  table the default engine holds, and for R1 (routed and part-select),
  G1 gather_compact and A1 ambiguous_postings_parts on the 128 MB light
  table split in 2 parts (``LIGHT_PART_BYTES`` set on a subclass; B=8192;
  R1's and the two-stage wires bitwise P3's); engine phases of the
  default engine (one table), the 2 routed parts, the two-stage and
  pipelined paths, 4 routed parts, the select fallback after the
  unique-overflow halving (``MIN_SPLIT_B`` set), and max-mode ambiguity
  reads over the parts, each held against the one-table engine and
  checked for its path (parts, handle type, launches); the CLI with
  ``--table auto`` (one table), and its profile phase (P1, P2, P3
  counted in the trace); half of each batch is sampled from the
  reference (every window hits), half is uniform;
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
  otherwise): f32 and u16 resolve to the compact table with the keys
  searched on the card (``[2,010,001, 300]``: 2.4 GB f32, 1.2 GB u16;
  the dense u16 table would take 10.1 GB): C1 on the f32 and u16 tables
  against its plain version, an engine phase and a CLI phase
  (``--precision u16``, 20k reads), then a layout phase, auto (compact)
  against postings.

* the mp axis across processes, last: two rank processes (``chip_smoke.py
  --mp-rank R``, started by the script) join a gloo group on localhost
  and form the transposed (dp=2, mp=2) mesh whose mp pairs hold one
  device of each rank (``cuda:0`` repeated; with two or more cards also a
  run with one card per rank, whose row groups take NCCL): config 1's
  ``ShardedPlacement`` (one 150-column shard per rank, 3 batches of
  16,384 reads; the tiles all-gathered), config 6's
  ``KmerShardedPlacement`` (one 1.2 GB k-mer range per rank, 10 batches
  of 16,384 reads; the psum an all-reduce) and config 5's postings
  ``ShardedEngine`` (one 4,000-edge range per rank, 3 batches of 8,192;
  the wires all-gathered); each rank's results must equal the
  single-process mesh's above bitwise, and each rank must launch K2, C3,
  K3, P1-P3 and M1.

Each row-sum kernel line (K1, K2, C1, C2, C3, and D1, which launches the
row-sum template once per part) also reports the row bytes it moved
(valid windows times the slab row bytes, summed over the slabs), their
rate in TB/s and the slab plan its wrapper launched (C1: whether the
resolve pass ran; D1: one plan per part).  Each P3/R1 line reports its
slots, postings per read and how many reads took the warp, block and
scratch paths; P3 also times the block path alone, every read on it, in
the same run.  The P2/A1 postings lines report the light-only windows and
the largest light pairs one window stages; the K4 and A1 split lines
their load width and threads per window.  K3 is timed at keep 7 (each
lane's candidates in registers) and keep 20 (the scanning rounds), each
line with its path, reads per warp and per block, rate over the bytes
it must move and the rows' matched columns.  P1 is held bitwise against
the sums in CSR order (also on an edge-range shard) and reports its
slots, heavy hits, distinct rows, longest slot and the rate of its
heavy-row bytes (``row_tb_s``).
M1 and G1 report the rate of the bytes they must move (``tb_s``), and
the run measures once the launch floor (``launch_floor_ms``, a
one-element ``fill_`` in the same graph harness) that M1's and K4's
device times are read against.

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


def launches(names) -> dict:
    """The kernel launches counted since the last ``utils.trace_reset()``
    (counters ``kernel.launch.<name>``), by name."""
    from rappas_tpu_torch import utils
    return {n: utils.counter("kernel.launch." + n) for n in names}


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


def synthetic_ardir(out: Path, n_taxa: int, n_sites: int, seed: int,
                    states: str = "nucl"):
    """Inputs of a ``-p b --ardir`` build, made from the seed with port
    modules only, as an AR program's run would leave them (no AR binary
    is needed): a random rooted tree of ``n_taxa`` taxa (``tree.nwk``),
    an ``n_sites``-column alignment simulated down it under
    Jukes-Cantor (``align.fasta``), and ``ar/`` with the extended tree
    unrooted as RAxML-ng writes it (``ancestralTree``, every internal
    node labelled) and its ``ancestralProbs``: for each (internal node,
    site), the simulated state with a probability drawn from Beta(8, 1),
    the rest split by a flat Dirichlet draw.  Returns the three paths.
    Config 1's widths are 150 taxa x 1,500 sites (BASELINE config 1:
    E = 299 edges)."""
    import numpy as np

    from rappas_tpu_torch.alphabet import get_alphabet
    from rappas_tpu_torch.extend import extend_tree
    from rappas_tpu_torch.tree import Tree, parse_newick, write_newick

    rng = np.random.default_rng(seed)
    alphabet = get_alphabet(states)
    S = alphabet.n_states
    letters = np.frombuffer(alphabet.letters.encode(), np.uint8)
    # random joins of the pool: a rooted binary tree
    pool = [f"T{i}:{rng.exponential(0.05) + 1e-3:.6f}"
            for i in range(n_taxa)]
    n_inner = 0
    while len(pool) > 2:
        i, j = sorted(rng.choice(len(pool), 2, replace=False))
        b, a = pool.pop(j), pool.pop(i)
        n_inner += 1
        pool.append(f"({a},{b})n{n_inner}:"
                    f"{rng.exponential(0.05) + 1e-3:.6f}")
    newick = f"({pool[0]},{pool[1]})root;"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tree.nwk").write_text(newick + "\n")

    # states down the extended tree (ghosts included), Jukes-Cantor
    ext = extend_tree(parse_newick(newick))
    seq = {ext.root.id: rng.integers(0, S, n_sites)}
    for node in ext.nodes[1:]:                 # pre-order: parents first
        t = float(node.branch_len)
        p = (S - 1) / S * (1 - np.exp(-S / (S - 1) * t))
        change = rng.random(n_sites) < p
        s = seq[node.parent.id].copy()
        s[change] = (s[change] + rng.integers(1, S, int(change.sum()))) % S
        seq[node.id] = s
    with open(out / "align.fasta", "wb") as f:
        for node in ext.nodes:
            if node.is_leaf and not node.is_fake:
                f.write(b">" + node.label.encode() + b"\n" +
                        letters[seq[node.id]].tobytes() + b"\n")

    # the AR program's unrooting: the root's first child takes its place,
    # the second child first among its children (undone by the parser,
    # rappas_tpu_torch.ar.wrappers.reroot_ar_newick)
    a, b = ext.root.children
    b.branch_len = np.float32(a.branch_len + b.branch_len)
    a.children.insert(0, b)
    b.parent, a.parent = a, None
    ar_tree = Tree(a, rooted=False)
    inner = [n for n in ar_tree.nodes if not n.is_leaf]
    width = len(str(max(n.id for n in inner)))
    for n in inner:
        n.label = f"N{n.id:0{width}d}"          # fixed width, like the rows
    ar = out / "ar"
    ar.mkdir(exist_ok=True)
    stem = "extended_align.phylip.raxml."
    (ar / (stem + "ancestralTree")).write_text(
        write_newick(ar_tree, True, True, False, False) + "\n")

    # posteriors as fixed-width rows "label\tsite\tstate\tp_1..p_S":
    # probabilities 0.ddddddddd, sites zero-padded
    top = rng.beta(8, 1, (len(inner), n_sites))
    rest = rng.dirichlet(np.ones(S - 1), (len(inner), n_sites))
    state = np.stack([seq[n.id] for n in inner])
    probs = np.empty((len(inner), n_sites, S))
    others = (state[..., None] + 1 + np.arange(S - 1)) % S
    np.put_along_axis(probs, state[..., None], top[..., None], axis=-1)
    np.put_along_axis(probs, others, (1 - top)[..., None] * rest, axis=-1)
    fixed = np.clip(np.rint(probs * 1e9), 0, 999_999_999).astype(np.int64)
    digits = fixed[..., None] // 10 ** np.arange(8, -1, -1) % 10 + 48
    sw = len(str(n_sites))
    rows = np.empty((len(inner), n_sites, width + sw + S * 12 + 5),
                    np.uint8)
    rows[..., 0] = ord("N")
    ids = np.array([n.id for n in inner])
    rows[..., 1:width + 1] = (ids[:, None] //
                              10 ** np.arange(width - 1, -1, -1) % 10
                              + 48)[:, None, :]
    c = width + 1
    rows[..., c] = 9
    site = np.arange(1, n_sites + 1)
    rows[..., c + 1:c + 1 + sw] = site[:, None] // 10 ** np.arange(
        sw - 1, -1, -1) % 10 + 48
    c += 1 + sw
    rows[..., c] = 9
    rows[..., c + 1] = letters[state]
    c += 2
    for j in range(S):
        rows[..., c] = 9
        rows[..., c + 1] = ord("0")
        rows[..., c + 2] = ord(".")
        rows[..., c + 3:c + 12] = digits[:, :, j]
        c += 12
    rows[..., c] = 10
    header = "\t".join(["Node", "Site", "State"] +
                       [f"p_{ch}" for ch in alphabet.letters])
    with open(ar / (stem + "ancestralProbs"), "wb") as f:
        f.write(header.encode() + b"\n")
        f.write(rows.tobytes())
    return out / "align.fasta", out / "tree.nwk", ar


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


def launch_floor_ms() -> float:
    """The device time of the shortest launch, in :func:`device_ms`'s
    harness: a one-element ``fill_``.  A kernel whose bound lies below it
    (M1, K4) is read against it."""
    import torch

    x = torch.empty(1, device="cuda")
    return device_ms(lambda: x.fill_(0))


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


def result_rows(res, i: int) -> list:
    """Read ``i``'s placements of a BatchResult: [(node id, score)], best
    first."""
    v = res.top_edges[i] >= 0
    return [(int(e), float(x)) for e, x in zip(res.top_edges[i][v],
                                               res.top_scores[i][v])]


def card_tolerance(db, seq: str, exact: dict) -> float:
    """The card's score gate against the f64 sums for one read: 2e-4 plus
    the first-order error bound of its f32 running sums.  K1 adds each
    hit window's delta to one running sum per edge, in window order; for
    n non-negative terms summing to ``acc`` that error is at most ``n *
    2^-24 * |acc|`` (Higham's gamma_n * sum |x_i|), n the read's hit
    windows (an ambiguous window counts as one).  For a 150-bp read, n <=
    143 keeps it under 2e-4 + 1e-5 |acc|."""
    import numpy as np

    codes = db.alphabet.encode(seq).astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(codes, db.k)
    clean = (win >= 0).all(axis=1)
    idx = win[clean] @ (db.alphabet.n_states **
                        np.arange(db.k - 1, -1, -1, dtype=np.int64))
    n = int(np.isin(idx, db.keys).sum()) + int((~clean).sum())
    acc = max(abs(x - len(win) * float(np.float32(db.thr_log10)))
              for x in exact.values())
    return 2e-4 + n * 2.0 ** -24 * acc


def exact_distance(rows, exact: dict, tol: float, what: str) -> tuple:
    """One read's placements ``rows`` [(edge, score)], best first, against
    ``exact`` (every candidate's f64 score,
    ``rappas_tpu_torch.place.oracle.exact_scores``): the edges are the
    f64 top ``len(rows)``, apart from edges whose f64 score lies within
    ``tol`` of the f64 ``len(rows)``-th best (a near tie at the cut), and
    every score lies within ``tol`` of its f64 sum.  Returns (the largest
    distance, whether a near tie changed the edge set)."""
    check(0 < len(rows) <= len(exact), f"{what}: {len(rows)} placements "
          f"of {len(exact)} candidates")
    ranked = sorted(exact, key=exact.get, reverse=True)
    got, want = {e for e, _ in rows}, set(ranked[:len(rows)])
    cut = exact[ranked[len(rows) - 1]]
    check(all(e in exact and abs(exact[e] - cut) <= tol
              for e in got ^ want),
          f"{what}: edges {sorted(got)} vs the f64 top {sorted(want)}")
    d = max(abs(x - exact[e]) for e, x in rows)
    check(d <= tol, f"{what}: a score lies {d} from its f64 sum "
          f"(tolerance {tol})")
    return d, got != want


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


#: K3's second instance: past kLaneTop (8) candidates a lane keeps, the
#: scanning rounds (no phase of the main path runs it: its line is a
#: sub-entry of K3's, without launches)
K_KEEP_SCAN = 20


def finalize_phase(acc_pure, lens_d, thr_t, k: int) -> dict:
    """K3 on config 1's batch of K1 sums, at K_KEEP (each lane's
    candidates in registers) and, as the sub-entry ``keep20``, at
    K_KEEP_SCAN (the scanning rounds): the wire bitwise the plain
    version's and its rate over the bytes it must move."""
    import torch

    from rappas_tpu_torch.place import kernels as K

    thr = float(thr_t)
    out = {}
    for keep in (K_KEEP, K_KEEP_SCAN):
        def run():
            return K.finalize_wire(acc_pure, lens_d, thr, k, keep)

        got = run()
        te, ts, lwr, nm = K.finalize(acc_pure, lens_d, thr_t, k, keep)
        want = K.pack_wire(te, ts, lwr, nm)
        torch.cuda.synchronize()
        check(torch.equal(got[:, -1], want[:, -1]),
              f"K3 at keep {keep}: |L| differs")
        g_s = got[:, :keep].view(torch.float32)
        fin = torch.isfinite(ts)
        err3 = float((g_s - ts)[fin].abs().max()) if bool(fin.any()) \
            else 0.0
        same_bits = torch.equal(got[:, :keep], want[:, :keep])
        # edges must agree exactly where the score bits do (no tie
        # reordering)
        check(same_bits and torch.equal(got, want),
              f"K3 at keep {keep}: wire words differ from the plain "
              f"version (scores bitwise equal: {same_bits}, max abs err "
              f"{err3})")
        Qs = (lens_d - (k - 1)).to(torch.float32)[:, None] * thr_t
        masked = torch.where(acc_pure > 0, Qs + acc_pure,
                             torch.full_like(acc_pure, float("-inf")))
        nbytes = acc_pure.numel() * 4 + lens_d.numel() * 4 + got.numel() * 4
        b, why = bound(nbytes, 3 * acc_pure.numel())
        # csrc/finalize.cu: 8 lanes per read, 256 threads a block
        r = dict(max_abs_err=err3, bound_ms=b, bound_by=why, **timed(run),
                 plain_ms=cuda_ms(lambda: K.pack_wire(*K.finalize(
                     acc_pure, lens_d, thr_t, k, keep))),
                 library_ms=cuda_ms(lambda: torch.topk(masked, keep, dim=1)),
                 path="registers" if keep <= 8 else "scan",
                 reads_per_warp=4, reads_per_block=32,
                 matched_per_row=float((acc_pure > 0).sum(1).float().mean()))
        r["tb_s"] = nbytes / (r["ms"] * 1e-3) / 1e12
        if keep == K_KEEP:
            out["finalize_wire"] = r
        else:
            out["finalize_wire"]["keep20"] = r
    return out


def inorder_slot_sums(H, hrows, hoff):
    """P1's function summed in CSR order: round j adds the j-th source row
    of every slot that has one, from zero (f32 adds on the card, so the
    kernel's sums must match bitwise)."""
    import torch

    n_slots = hoff.numel() - 1
    counts = (hoff[1:] - hoff[:-1]).long()
    acc = torch.zeros((n_slots, H.shape[1]), dtype=torch.float32,
                      device=H.device)
    for j in range(int(counts.max()) if n_slots else 0):
        has = torch.nonzero(counts > j).squeeze(1)
        acc[has] += H[hrows[hoff[has].long() + j].long()]
    return acc


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
    H, pairs, lay = eng.heavy_dense, eng.pairs, eng.light_layout
    E, P = H.shape[1], lay.P
    miss = pairs.shape[0] - 1
    out = {}

    # P1 ------------------------------------------------------------ #
    n_slots = d["hoff"].numel() - 1
    sizes = (d["hoff"][1:] - d["hoff"][:-1]).long()
    slots = torch.repeat_interleave(torch.arange(n_slots, device=dev), sizes)

    def p1():
        return K.dense_side(H, d["hrows"], d["hoff"])

    acc_c = p1()
    want = K.scatter_slots(K.gather_rows(H, d["hrows"]), slots, n_slots)
    inorder = inorder_slot_sums(H, d["hrows"], d["hoff"])
    torch.cuda.synchronize()
    err = float((acc_c - want).abs().max()) if n_slots else 0.0
    check(torch.allclose(acc_c, want, rtol=1e-5, atol=1e-6),
          f"P1 dense_side disagrees with its plain version "
          f"(max abs err {err})")
    check(torch.equal(acc_c, inorder),
          "P1 dense_side: not the in-order sums bitwise")
    n_h = d["hrows"].numel()
    distinct = torch.unique(d["hrows"]).numel()
    b, why = bound(n_h * 4 + (n_slots + 1) * 4 + distinct * E * 4 +
                   n_slots * E * 4, n_h * E)
    hrows_long, hoff_long = d["hrows"].long(), d["hoff"][:-1].long()
    r = dict(
        max_abs_err=err, bound_ms=b, bound_by=why, slots=n_slots,
        heavy_hits=n_h, distinct_rows=distinct,
        longest_slot=int(sizes.max()) if n_slots else 0, **timed(p1),
        plain_ms=cuda_ms(lambda: K.scatter_slots(
            K.gather_rows(H, d["hrows"]), slots, n_slots)),
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            hrows_long, H, hoff_long, mode="sum")))
    r["row_tb_s"] = n_h * E * 4 / (r["ms"] * 1e-3) / 1e12
    out["dense_side"] = r

    # P2 ------------------------------------------------------------ #
    spec = [d[n] for n in ("alt_lrows", "alt_hrows", "win_off", "win_slot",
                           "win_inv_w", "win_is_mean")]
    alt_win = torch.repeat_interleave(
        torch.arange(spec[3].numel(), device=dev),
        (spec[2][1:] - spec[2][:-1]).long())
    errs = []
    for mean in (1, 0):
        spec[5] = torch.full_like(d["win_is_mean"], mean)
        got = K.ambiguous_postings_(acc_c.clone(), H, pairs, *spec,
                                    layout=lay)
        want = K.ambiguous_pass(
            K.alt_delta_rows_postings(pairs, H, spec[0], spec[1],
                                      layout=lay), alt_win,
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
                   torch.unique(lr).numel() * lay.words * 4 + n_alt * 8 +
                   n_w * 13 + 4 +
                   2 * torch.unique(spec[3]).numel() * E * 4,
                   (n_alt * 3 + 3 * n_w) * E + n_alt * P)
    scratch = acc_c.clone()
    out["ambiguous_postings"] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why, windows=n_w,
        alternatives=n_alt,
        **window_stats(spec[2], spec[1], H.shape[0] - 1, P),
        **timed(lambda: K.ambiguous_postings_(scratch, H, pairs, *spec,
                                              layout=lay)),
        plain_ms=cuda_ms(lambda: K.ambiguous_pass(
            K.alt_delta_rows_postings(pairs, H, spec[0], spec[1],
                                      layout=lay), alt_win,
            spec[3], spec[4], spec[5], acc_c)),
        library_ms=None)

    # P3 ------------------------------------------------------------ #
    args = (pairs, d["lrows"], acc_amb, d["slot_of"], d["lengths"])
    thr_t = torch.tensor(np.float32(eng.thr), device=dev)
    Kk = min(K_KEEP, E)
    want = K.pack_wire(*K.finalize_postings(*args, thr_t, eng.k, K_KEEP,
                                            layout=lay), wide=eng.wide)
    ref = unpack_wire(want.cpu().numpy(), Kk, eng.wide)
    counts = eng._light_counts[host["lrows"]].sum(axis=1)
    block_plan = K.postings_plan(counts, warp_pairs=0).to(dev)
    errs = []
    for name, pl in (("plan", plan), ("block path", block_plan),
                     ("global scratch",
                      K.postings_plan(counts, 0, 0).to(dev))):
        got = K.finalize_postings_wire(*args, eng.thr, eng.k, K_KEEP, pl,
                                       layout=lay)
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
    b, why = bound(torch.unique(lrows_real).numel() * lay.words * 4 +
                   d["lrows"].numel() * 4 + B_POSTINGS * 8 +
                   n_slots * E * 4 + got.numel() * 4,
                   float((n_b * np.ceil(np.log2(n_b))).sum()) +
                   n_slots * E)
    out["finalize_postings_wire"] = dict(
        max_abs_err=max(errs), bound_ms=b, bound_by=why,
        window_columns=int(host["lrows"].shape[1]),
        **p3_paths(plan, counts, n_slots), smem_pairs=plan.smem_pairs,
        **timed(lambda: K.finalize_postings_wire(
            *args, eng.thr, eng.k, K_KEEP, plan, layout=lay)),
        # every read on the block path (the earlier design), this run
        block_path_ms=device_ms(lambda: K.finalize_postings_wire(
            *args, eng.thr, eng.k, K_KEEP, block_plan, layout=lay)),
        plain_ms=cuda_ms(lambda: K.pack_wire(*K.finalize_postings(
            *args, thr_t, eng.k, K_KEEP, layout=lay), wide=eng.wide),
            reps=5),
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
        H, pairs, lay = sh["heavy_dense"][dev], sh["pairs"][dev], \
            sp.light_layout
        E, P, off = H.shape[1], lay.P, sh["offset"]
        acc_c = K.dense_side(H, d["hrows"], d["hoff"])
        check(torch.equal(acc_c, inorder_slot_sums(H, d["hrows"],
                                                   d["hoff"])),
              f"P1 dense_side on shard {j} ({E} columns): not the in-order "
              "sums bitwise")
        spec = [d[n] for n in ("alt_lrows", "alt_hrows", "win_off",
                               "win_slot", "win_inv_w", "win_is_mean")]
        alt_win = torch.repeat_interleave(
            torch.arange(spec[3].numel(), device=dev),
            (spec[2][1:] - spec[2][:-1]).long())

        def p2(acc):
            return K.ambiguous_postings_(acc, H, pairs, *spec, off,
                                         layout=lay)

        def p2_plain():
            return K.ambiguous_pass(K.alt_delta_rows_postings(
                pairs, H, spec[0], spec[1], off, layout=lay), alt_win,
                *spec[3:], acc_c)
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
                                            off, sp.n_edges, layout=lay)

        def p3_plain():
            return K.pack_wire(*K.finalize_postings(
                *args, thr_t, k, K_KEEP, off, layout=lay), wide=sp.wide)
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
                       torch.unique(lr).numel() * lay.words * 4 +
                       n_alt * 8 + n_w * 13 + 4 +
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
        b, why = bound(torch.unique(lrows_real).numel() * lay.words * 4 +
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
    nbytes = stacked.numel() * 4 + got.numel() * 4
    b, why = bound(nbytes, Bl * sp.wire_k * mp * K_in)
    t = timed(m1)
    out["merge_candidates_wire"] = dict(
        max_abs_err=0.0, bound_ms=b, bound_by=why, shards=mp, reads=Bl,
        candidates=mp * K_in, **t, tb_s=nbytes / (t["ms"] * 1e-3) / 1e12,
        plain_ms=cuda_ms(m1_plain), library_ms=cuda_ms(library))
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
    lay = eng.light_layout
    E, P = H.shape[1], lay.P
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
        return K.ambiguous_postings_parts_(acc, H, parts, *spec, layout=lay)

    def a1_plain():
        return K.ambiguous_pass(K.alt_delta_rows_postings(
            tables, H, spec[0], spec[1], layout=lay), alt_win, *spec[3:],
            acc_c)
    got, want = a1(acc_c.clone()), a1_plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(err <= 2e-4 and torch.equal(got > 0, want > 0),
          f"A1 ambiguous_postings_parts disagrees with its plain version "
          f"(max abs err {err})")
    n_alt, n_w = spec[0].numel(), spec[3].numel()
    lr, hr = spec[0][spec[0] != nl], spec[1][spec[1] != H.shape[0] - 1]
    b, why = bound(torch.unique(hr).numel() * E * 4 +
                   torch.unique(lr).numel() * lay.words * 4 + n_alt * 8 +
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
    one_wire = K.finalize_postings_wire(one.pairs, d["lrows"], *args,
                                        layout=lay)
    counts = eng._light_counts[host["lrows"]].sum(axis=1)
    n_b = counts[counts > 1].astype(np.float64)
    sort_ops = float((n_b * np.ceil(np.log2(n_b))).sum())
    n_slots = d["hoff"].numel() - 1
    distinct = torch.unique(d["lrows"][d["lrows"] != nl]).numel()

    def plain_wire(**source):
        return K.pack_wire(*K.finalize_postings(
            None, source.pop("lrows", None), acc_c, d["slot_of"],
            d["lengths"], thr_t, eng.k, K_KEEP, layout=lay,
            light_parts=tables, **source), wide=eng.wide)
    r1 = {
        "finalize_postings_wire_routed": (
            lambda: K.finalize_postings_wire_routed(parts, routed, *args,
                                                    layout=lay),
            lambda: plain_wire(routed_lrows=tuple(routed)), routed.numel()),
        "finalize_postings_wire_parts": (
            lambda: K.finalize_postings_wire_parts(parts, d["lrows"], *args,
                                                   miss=nl, layout=lay),
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
        b, why = bound(distinct * lay.words * 4 + n_rows * 4 +
                       B_POSTINGS * 8 +
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
    wire = K.finalize_postings_wire(got, inv, *args, miss=src[1],
                                    layout=lay)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "G1 gather_compact: rows differ from the "
          "plain version")
    check(torch.equal(wire, one_wire), "P3 on G1's compact table: wire "
          "differs from the one-table P3's")
    U = uniq.numel()
    nbytes = U * 4 + uniq_off.numel() * 4 + 2 * U * lay.words * 4
    b, why = bound(nbytes, 0)
    t = timed(lambda: K.gather_compact_(parts, uniq, uniq_off))
    out["gather_compact"] = dict(
        max_abs_err=0.0, bound_ms=b, bound_by=why, compact_rows=U,
        parts=len(tables), **t,
        tb_s=nbytes / (t["ms"] * 1e-3) / 1e12,
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
    with ``treat_ambiguities=False``).  Returns (C3's kernel line, the
    batches' results, the phase's report)."""
    import numpy as np
    import torch

    from rappas_tpu_torch import utils
    from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import (PlacementEngine,
                                               host_kmer_indices)

    t0 = time.perf_counter()
    ksp = KmerShardedPlacement(db, mesh)
    setup_s = time.perf_counter() - t0
    batches, coded = coded_batches(seed, ref, n_batches)

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
    utils.trace_reset()
    t0 = time.perf_counter()
    results = [ksp.score(c, ln) for c, ln in coded]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = launches(("accumulate_rows_range", "finalize_wire"))
    for name, n in launched.items():
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
    return kern, results, {
        "reads_per_s": n_batches * B_KERNEL / dt, "seconds": dt,
        "single_compact_reads_per_s": n_batches * B_KERNEL / single_dt,
        "setup_s": setup_s, "batches": n_batches, "batch_size": B_KERNEL,
        "mesh": dict(mesh.shape), "shard_rows": per + 1,
        "launches": launched, "host_steps_s": steps}


def sharded_place_phase(db, mesh, work: Path, n_reads: int, seed: int,
                        names, device: str = "cuda",
                        table: str = "auto") -> dict:
    """``place_queries`` (the pipeline behind the CLI, which on one card
    can only ask for a one-device engine) through the sharded engine on
    ``mesh`` and through the single card engine on the same reads file:
    the jplace files must hold the same placements (edge sets, scores
    within 2e-4, LWR within 1e-4)."""
    import numpy as np

    from rappas_tpu_torch import utils
    from rappas_tpu_torch.parallel.engine import ShardedEngine
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
    for tag, make in (("sharded", lambda: ShardedEngine(db, mesh,
                                                        table=table)),
                      ("single", lambda: PlacementEngine(db, device=device,
                                                         table=table))):
        eng = make()
        utils.trace_reset()
        t0 = time.perf_counter()
        path = place_queries(db, fasta, work / f"place_{tag}",
                             PlacementConfig(batch_size=1024), engine=eng)
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "reads_per_s": n_reads / (time.perf_counter() - t0),
                    "launches": launches(names),
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

    from rappas_tpu_torch import utils
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.place.engine import PlacementEngine

    kw = engine_kw or {}
    cls = engine_cls or PlacementEngine
    rng = np.random.default_rng(seed + 2)
    n_amb = batch // 100 if n_ambiguous is None else n_ambiguous
    batches = [random_reads(rng, batch, n_amb, 0.05, length, letters, ref)
               for _ in range(n_batches)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = engine or (cls(db, device=device, **kw) if mesh is None
                     else ShardedEngine(db, mesh, **kw))
    if prepare is not None:
        prepare(eng)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    card_mb = (torch.cuda.memory_allocated() - base) / 1e6
    eng.score(*batches[0])                    # warm-up
    torch.cuda.synchronize()
    utils.trace_reset()
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
    counted = launches(names + tuple(absent))
    probes = utils.counter("native.probe_rows")
    for name in names:
        check(counted[name] > 0,
              f"engine phase: kernel {name} was never launched")
    for name in absent:
        check(counted[name] == 0, f"engine phase: kernel {name} was "
              f"launched {counted[name]} times off this path")
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
            "card_mb": card_mb,
            "batches": n_batches, "batch_size": batch, "launches": counted,
            "handles": sorted(handles), "path": path,
            "bitwise_vs_against": same_bits,
            "probe_rows_calls": probes, "host_steps_s": steps}


def layout_phase(db, seed: int, names, old: str, old_names,
                 ref=None) -> dict:
    """A DB placed through ``table="auto"`` (``PlacementEngine.
    resolve_table``'s H100 rule) and through ``old``, the layout the rule
    gave it while its budgets were the JAX engine's: an
    :func:`engine_phase` of each (the kernels ``names`` / ``old_names``
    must launch), the auto engine's first 512 reads held against the CPU
    engine and against the ``old`` engine on the card (``|L|`` and edge
    sets identical, scores within 2e-4, LWR within 1e-4).  Each layout's
    set-up seconds, MB on the card and engine reads/s are reported;
    nothing here asserts a time."""
    auto = engine_phase(db, seed, names, ref=ref,
                        against=({"table": old}, 2e-4))
    prev = engine_phase(db, seed, old_names, ref=ref,
                        engine_kw={"table": old})
    return {"auto": auto, "old": prev}


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

    eng = PlacementEngine(db, device="cpu", table="direct")
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


#: the CLI in a process of its own, its launch counts on the last line
CLI_PROCESS = ("import json, sys\n"
               "from rappas_tpu_torch import cli, utils\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print(json.dumps(utils.trace_totals()['counters']))\n"
               "sys.exit(rc)\n")


def cli_phase(db, db_path: Path, work: Path, n_reads: int, seed: int,
              names, ref=None, precision: str = "f32",
              device: str = "cuda", extra=(), exact: bool = False,
              tag: str = "", fresh: bool = False) -> dict:
    """``python -m rappas_tpu_torch.cli -p p`` (``cli.main``, ``extra``
    appended; with ``fresh`` in a process of its own, as a user runs it,
    the wall time then including the interpreter's start) on ``n_reads``
    reads (10% duplicates, 1% with an N, half
    from ``ref`` when given): every kernel in ``names`` must launch, every
    read be placed or listed unplaced, and the first 512 placements agree
    with the CPU engine's (best edge, or a near tie; likelihood within
    2e-4).  With ``exact`` they are held instead against the f64 sums of
    the same postings (``oracle.exact_scores``), with the f64 top edges
    apart from near ties at the cut: every placement row of the CPU
    engine within 2e-4 of its f64 sum, of the card's jplace within
    :func:`card_tolerance`."""
    import numpy as np

    from rappas_tpu_torch import cli, utils
    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.oracle import exact_scores

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
    wd = work / f"cli_{db_path.stem}_{precision}{tag}"
    argv = ["-p", "p", "-d", str(db_path), "-q", str(fasta), "-w", str(wd),
            "--table", "auto", "--precision", precision, "--device", device,
            *extra]
    utils.trace_reset()
    t0 = time.perf_counter()
    if fresh:
        run = subprocess.run([sys.executable, "-c", CLI_PROCESS, *argv],
                             cwd=Path(__file__).resolve().parent,
                             capture_output=True, text=True, timeout=600)
        rc = run.returncode
        check(rc == 0, f"CLI process exited with {rc}: {run.stderr[-2000:]}")
        counts = json.loads(run.stdout.strip().splitlines()[-1])
    else:
        rc = cli.main(argv)
        counts = utils.trace_totals()["counters"]
    dt = time.perf_counter() - t0
    launched = {n: counts.get("kernel.launch." + n, 0) for n in names}
    check(rc == 0, f"CLI exited with {rc}")
    for name, n in launched.items():
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
    out = {"reads_per_s": n_reads / dt, "seconds": dt, "reads": n_reads,
           "placements": len(jp["placements"]), "unplaced": n_unplaced,
           "launches": launched}
    # the first 512 placements, read by read
    arr = db.arrays
    first = jp["placements"][:512]
    idx = np.array([int(p["nm"][0][0].split()[1][4:]) for p in first])
    ref = PlacementEngine(db, device="cpu", precision=precision).score(
        mat[idx], lens[idx])
    acc = ref.top_scores[:, 0] - (lens[idx] - db.k + 1) * np.float32(
        db.thr_log10)
    out["max_acc"] = float(np.abs(acc).max())
    if exact:
        node_of = {int(j): n for n, j in enumerate(arr.jplace_edge_id)
                   if j >= 0}
        card = cpu = over = 0.0
        ties = 0
        for i, p in enumerate(first):
            seq = mat[idx[i], :lens[idx[i]]].tobytes().decode()
            ex = exact_scores(db, seq)
            tol = card_tolerance(db, seq, ex)
            d, tie = exact_distance([(node_of[r[0]], r[1]) for r in p["p"]],
                                    ex, tol, f"CLI placement {i} (card)")
            card, ties = max(card, d), ties + tie
            over = max(over, d - 2e-4)
            d, tie = exact_distance(result_rows(ref, i), ex, 2e-4,
                                    f"CLI placement {i} (CPU engine)")
            cpu, ties = max(cpu, d), ties + tie
        out.update(card_max_f64_diff=card, cpu_max_f64_diff=cpu,
                   card_past_2e4=max(over, 0.0), near_ties=ties)
        return out
    diff = 0.0
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
        d = abs(best[1] - float(ref.top_scores[i, 0]))
        diff = max(diff, d)
        check(d <= 2e-4, f"CLI placement {i}: likelihood {best[1]} vs "
              f"CPU {ref.top_scores[i, 0]}")
    out["max_score_diff"] = diff
    return out


def build_phase(work: Path, seed: int) -> tuple:
    """``-p b`` on the card's machine: the canned ``--ardir`` fixture
    (a subprocess; its DB must be ``expected_db.npz`` bitwise), then
    :func:`synthetic_ardir` at config 1's widths through ``-p b --ardir
    --calibration`` on the card (1,000,000 reads through K1 and K3, which
    must launch), then ``calibrate`` on the new DB at 65,536 reads on the
    card and on the CPU, the bounds within 2e-4.  Returns (results, DB,
    its path, its reference: the ASCII leaf sequences one after
    another)."""
    import shutil

    import numpy as np

    from rappas_tpu_torch import cli, utils
    from rappas_tpu_torch.build import calibration, pipeline
    from rappas_tpu_torch.db import PhyloKmerDB
    from rappas_tpu_torch.place.engine import PlacementEngine

    repo = Path(__file__).resolve().parent
    fx = repo / "tests" / "fixtures"
    # the canned fixture (a copy: a build writes its id mapping there)
    ar = work / "canned_ar"
    shutil.copytree(fx / "raxmlng_ardir", ar)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "rappas_tpu_torch.cli", "-p", "b",
         "-r", str(fx / "tiny.fasta"), "-t", str(fx / "tiny.tree"),
         "-b", "/fake/raxml-ng", "--ardir", str(ar),
         "-w", str(work / "canned")], cwd=repo, capture_output=True,
        text=True, timeout=600)
    canned_s = time.perf_counter() - t0
    check(run.returncode == 0, f"canned -p b exited with {run.returncode}: "
          f"{run.stderr[-2000:]}")
    db = PhyloKmerDB.load(work / "canned" / "DB_k8_o1.5.rptpu")
    exp = np.load(fx / "raxmlng_ardir" / "expected_db.npz")
    for key in ("keys", "offsets", "edges", "deltas"):
        check(np.array_equal(getattr(db, key).view(np.uint8),
                             exp[key].view(np.uint8)),
              f"canned -p b: {key} differ from expected_db.npz")
    check((ar / "ARtree_id_mapping.tsv").read_bytes() ==
          (fx / "raxmlng_ardir" / "ARtree_id_mapping.tsv").read_bytes(),
          "canned -p b: ARtree_id_mapping.tsv differs")
    out = {"canned": {"seconds": canned_s, "kmers": db.n_kmers,
                      "postings": db.nnz, "bitwise": True}}

    # config 1's widths: 150 taxa x 1,500 sites, calibrated on the card
    n_taxa, n_sites = 150, 1500
    t0 = time.perf_counter()
    align, tree, ar = synthetic_ardir(work / "synthetic", n_taxa, n_sites,
                                      seed)
    gen_s = time.perf_counter() - t0
    wd = work / "synthetic_db"
    utils.trace_reset()
    t0 = time.perf_counter()
    rc = cli.main(["-p", "b", "-r", str(align), "-t", str(tree),
                   "-b", "/fake/raxml-ng", "--ardir", str(ar), "-w", str(wd),
                   "--calibration"])
    cli_s = time.perf_counter() - t0
    launched = launches(BUILD)
    check(rc == 0, f"-p b exited with {rc}")
    for name, n in launched.items():
        check(n > 0, f"build phase: kernel {name} was never launched")
    check(launches(("accumulate_codes", "accumulate_packed")) ==
          {"accumulate_codes": 0, "accumulate_packed": 0},
          "build phase: a calibration read left the compact table")
    stats, cal = dict(pipeline.LAST_BUILD), dict(calibration.LAST_RUN)
    path = wd / "DB_k8_o1.5.rptpu"
    db = PhyloKmerDB.load(path)
    bound = db.meta["calibration_ns_bound"]
    check(np.isfinite(bound), f"calibrated bound {bound} in the header")
    table = PlacementEngine.resolve_table(
        db, "auto", "f32", PlacementEngine.table_budget("cuda"))
    check(table == cal["table"] == "compact",
          f"the synthetic DB resolves to {table}, calibration took "
          f"{cal['table']}")
    check(cal["reads"] == 1_000_000, f"calibration scored {cal['reads']}")
    out["synthetic"] = {
        "taxa": n_taxa, "sites": n_sites, "generate_s": gen_s,
        "ghost_nodes": stats["nodes"], "raw_tuples": stats["raw_tuples"],
        "postings": db.nnz, "kmers": db.n_kmers, "E": db.n_edge_slots,
        "table": table, "db_mb": path.stat().st_size / 1e6,
        "build_s": {key: stats[key] for key in ("inputs_s", "ar_s",
                                                "kmers_s", "save_s")},
        "calibration_s": cal["seconds"],
        "calibration_reads_per_s": cal["reads"] / cal["seconds"],
        "cli_s": cli_s, "bound": bound, "launches": launched}

    # the same reads' bound on the card and on the CPU
    n = 65_536
    utils.trace_reset()
    on_card = calibration.calibrate(db, n_samples=n, device="cuda")
    card_s = calibration.LAST_RUN["seconds"]
    moved = launches(BUILD)
    for name, m in moved.items():
        check(m > 0, f"calibrate on cuda: kernel {name} was never launched")
    on_cpu = calibration.calibrate(db, n_samples=n, device="cpu")
    # two f32 ulps of the bound: the card's distance from the CPU when
    # calibration ran K1 on the direct table (3.05e-5 at -197.37)
    tol = 2 * float(np.spacing(np.float32(abs(on_cpu))))
    check(abs(on_card - on_cpu) <= tol, f"calibration bound on the card "
          f"{on_card} vs the CPU {on_cpu} (more than {tol} apart)")
    out["card_vs_cpu"] = {"reads": n, "card_bound": on_card,
                          "cpu_bound": on_cpu,
                          "abs_diff": abs(on_card - on_cpu), "tol": tol,
                          "card_s": card_s,
                          "cpu_s": calibration.LAST_RUN["seconds"],
                          "launches": moved}
    out["card_vs_cpu"]["table"] = calibration.LAST_RUN["table"]
    out["calibration_kernels"] = calibration_kernel_phase(db)
    seqs = [ln for ln in align.read_bytes().split(b"\n")
            if ln and not ln.startswith(b">")]
    return out, db, path, np.frombuffer(b"".join(seqs), np.uint8)


def calibration_kernel_phase(db) -> dict:
    """The row sum and K3 at calibration's own shape: its first batch of
    reads (``calibration.calibration_reads``, seed 1: 8,192 reads of width
    225 on a DNA DB), on the layout ``calibrate``'s engine takes (C1 on
    the compact table) and on the direct table (K1), each kernel's device
    time in :func:`device_ms`'s harness beside its bound."""
    import numpy as np
    import torch

    from rappas_tpu_torch.build import calibration
    from rappas_tpu_torch.place import kernels as K
    from rappas_tpu_torch.place.engine import PlacementEngine, pack_reads

    cal = PlacementEngine(db, device="cuda", treat_ambiguities=False)
    check(cal.table == "compact" and cal.keys_dev is not None,
          f"calibration's engine took {cal.table}")
    eng = PlacementEngine(db, device="cuda", treat_ambiguities=False,
                          table="direct")
    B, S = 8192, db.alphabet.n_states
    mat, lens = calibration.calibration_reads(
        db, np.random.default_rng(1), B, calibration.DEFAULT_MEAN_LEN)
    L, E = mat.shape[1], eng.D.shape[1]
    codes = eng.encode_batch(mat)
    packed = torch.from_numpy(pack_reads(codes)).cuda()
    codes_d = torch.from_numpy(codes).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    acc = K.accumulate_packed(eng.D, packed, lens_d, L, db.k, eng.scale)
    got = K.accumulate_compact(cal.D, cal.keys_dev, codes_d, db.k, S)
    torch.cuda.synchronize()
    c1_vs_k1 = float((got - acc).abs().max())
    check(c1_vs_k1 <= 2e-4, f"calibration: C1's sums {c1_vs_k1} from K1's")
    rows = K.kmer_rows_packed(packed, lens_d, db.k, 4, eng.D.shape[0], L)
    valid = rows[rows != eng.D.shape[0] - 1]
    out_b = B * E * 4
    touched = torch.unique(valid).numel() * E * 4
    k1 = bound(packed.numel() + B * 4 + touched + out_b,
               (valid.numel() + B) * E)
    c1 = bound(codes_d.numel() + cal.keys_dev.numel() * 4 + touched + out_b,
               (valid.numel() + B) * E)
    wire = K.finalize_wire(acc, lens_d, eng.thr, db.k, eng.keep_at_most)
    k3 = bound(out_b + B * 4 + wire.numel() * 4, acc.numel())
    return {"reads": B, "width": L, "table": cal.table,
            "c1_vs_k1_max_abs": c1_vs_k1,
            "accumulate_compact": dict(timed(lambda: K.accumulate_compact(
                cal.D, cal.keys_dev, codes_d, db.k, S)),
                bound_ms=c1[0], bound_by=c1[1]),
            "accumulate_packed": dict(timed(lambda: K.accumulate_packed(
                eng.D, packed, lens_d, L, db.k, eng.scale, acc=acc)),
                bound_ms=k1[0], bound_by=k1[1]),
            "finalize_wire": dict(timed(lambda: K.finalize_wire(
                acc, lens_d, eng.thr, db.k, eng.keep_at_most)),
                bound_ms=k3[0], bound_by=k3[1])}


def oracle_phase(db, seed: int, n_reads: int = 512) -> dict:
    """The card against the serial reference semantics: the first
    ``n_reads`` reads of the config-1 engine phase's first batch through
    the card's engine and through the port's oracle
    (``rappas_tpu_torch.place.oracle.place_read``), held with the tests'
    gate (``tests/test_engine.py:41-60``): ``|L|`` and edge sets
    identical, scores within 2e-4, LWR within 1e-4."""
    import numpy as np

    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.oracle import place_read

    rng = np.random.default_rng(seed + 2)
    mat, lens = random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05)
    mat, lens = mat[:n_reads], lens[:n_reads]
    res = PlacementEngine(db, device="cuda").score(mat, lens)
    t0 = time.perf_counter()
    score_d = lwr_d = 0.0
    placed = 0
    for i in range(n_reads):
        rows, nm = place_read(db, mat[i, :lens[i]].tobytes().decode())
        check(nm == res.n_matched[i], f"oracle phase read {i}: |L| "
              f"{res.n_matched[i]} on the card, {nm} in the oracle")
        if nm == 0:
            continue
        placed += 1
        v = res.top_edges[i] >= 0
        got = {int(e): (float(x), float(w)) for e, x, w in zip(
            res.top_edges[i][v], res.top_scores[i][v], res.top_lwr[i][v])}
        check(set(got) == {r[0] for r in rows}, f"oracle phase read {i}: "
              f"edges {sorted(got)} vs {sorted(r[0] for r in rows)}")
        for e, x, w in rows:
            score_d = max(score_d, abs(got[e][0] - float(x)))
            lwr_d = max(lwr_d, abs(got[e][1] - w))
    check(score_d <= 2e-4 and lwr_d <= 1e-4, f"oracle phase: scores "
          f"{score_d}, LWR {lwr_d} from the oracle's")
    check(placed > n_reads // 2, f"oracle phase: {placed} reads placed")
    return {"reads": n_reads, "placed": placed, "max_score_diff": score_d,
            "max_lwr_diff": lwr_d,
            "oracle_s": time.perf_counter() - t0}


def exact_phase(db, leaves, n_sites: int, seed: int,
                n_reads: int = 128) -> dict:
    """``n_reads`` clean 150-bp reads cut from the build DB's leaves
    (``leaves``: the leaf sequences one after another, ``n_sites`` each)
    through the card's engine, the CPU engine and the port's oracle, each
    against the f64 sums of the same postings (``exact_scores``), with the
    f64 top edges (near ties at the cut apart): the CPU engine within
    2e-4, the card within :func:`card_tolerance`; the oracle's own
    distance (Java's f32 order) is reported, not gated."""
    import numpy as np

    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.oracle import exact_scores, place_read

    rng = np.random.default_rng(seed + 12)
    start = (rng.integers(0, leaves.size // n_sites, n_reads) * n_sites +
             rng.integers(0, n_sites - READ_LEN + 1, n_reads))
    mat = leaves[start[:, None] + np.arange(READ_LEN)]
    lens = np.full(n_reads, READ_LEN, np.int32)
    res = {dev: PlacementEngine(db, device=dev).score(mat, lens)
           for dev in ("cuda", "cpu")}
    dist = {"cuda": 0.0, "cpu": 0.0, "oracle": 0.0}
    ties = over = 0
    for i in range(n_reads):
        seq = mat[i].tobytes().decode()
        ex = exact_scores(db, seq)
        for dev, r in res.items():
            tol = card_tolerance(db, seq, ex) if dev == "cuda" else 2e-4
            d, tie = exact_distance(result_rows(r, i), ex, tol,
                                    f"exact phase read {i} ({dev})")
            dist[dev], ties = max(dist[dev], d), ties + tie
            over += dev == "cuda" and d > 2e-4
        rows, _ = place_read(db, seq)
        dist["oracle"] = max(dist["oracle"], max(
            abs(float(x) - ex[e]) for e, x, _ in rows))
    acc = res["cuda"].top_scores[:, 0] - (READ_LEN - db.k + 1) * np.float32(
        db.thr_log10)
    return {"reads": n_reads, "card_max_f64_diff": dist["cuda"],
            "cpu_max_f64_diff": dist["cpu"],
            "oracle_max_f64_diff": dist["oracle"], "near_ties": ties,
            "card_reads_past_2e4": over,
            "max_acc": float(np.abs(acc).max())}


#: the ``__global__`` kernel of each wrapper the profile phase counts in a
#: trace (a regex of the demangled name), and the one a call may launch
#: right after it on its stream (P3/R1's block kernel after the warp one)
TRACE_KERNELS = {
    "accumulate_packed": (r"accumulate_kernel<[^,]*PackedRow, float,", None),
    "accumulate_codes": (r"accumulate_kernel<[^,]*CodeRow, float,", None),
    "finalize_wire": (r"finalize_wire_kernel", None),
    "ambiguous_pass": (r"ambiguous_direct_kernel<[^,]*DirectRows<float>",
                       None),
    "dense_side": (r"dense_side_kernel", None),
    "ambiguous_postings": (r"ambiguous_postings_kernel<[^>]*OneLight", None),
    "finalize_postings_wire": (
        r"finalize_postings_warp_kernel<[^>]*OneTable",
        r"finalize_postings_kernel<[^>]*OneTable"),
    "ambiguous_postings_parts": (
        r"ambiguous_postings_kernel<[^>]*PartLight", None),
    "finalize_postings_wire_routed": (
        r"finalize_postings_warp_kernel<[^>]*RoutedRows",
        r"finalize_postings_kernel<[^>]*RoutedRows"),
}


def read_trace(trace_dir: Path, names) -> dict:
    """The ``*.pt.trace.json`` that ``--profile`` wrote into ``trace_dir``:
    the launches of each wrapper in ``names`` counted from its kernel
    events (:data:`TRACE_KERNELS`); ``lost_kernel_records``, the kernel
    launches of the runtime's records (``cudaLaunchKernel``) whose kernel
    record the trace lacks, and ``lost_copy_records`` likewise for
    copies; the card's busy share, the union of its kernel, memcpy and
    memset intervals over the profiled window (the first event's start to
    the last one's end: a lower bound where records were lost), and its
    kernels' share alone."""
    import re

    files = list(trace_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"{trace_dir}: {len(files)} trace files")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]

    def union(cats):
        busy, end = 0.0, float("-inf")
        for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in events if e.get("cat") in cats):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    kern = sorted((e for e in events if e.get("cat") == "kernel"),
                  key=lambda e: (e.get("args", {}).get("stream", 0),
                                 float(e["ts"])))
    check(kern, f"{files[0].name} holds no kernel events (CPU only)")
    counts = {}
    for name in names:
        first, then = (re.compile(p) if p else None
                       for p in TRACE_KERNELS[name])
        n, prev = 0, (None, False)
        for e in kern:
            stream = e.get("args", {}).get("stream", 0)
            is_first = bool(first.search(e["name"]))
            if is_first or (then is not None and then.search(e["name"]) and
                            prev != (stream, True)):
                n += 1
            prev = (stream, is_first)
        counts[name] = n
    def correlations(pred):
        return {e.get("args", {}).get("correlation") for e in events
                if pred(e)}
    launched = correlations(lambda e: e.get("cat") == "cuda_runtime" and
                            "LaunchKernel" in e.get("name", ""))
    recorded = correlations(lambda e: e.get("cat") == "kernel")
    copies = correlations(lambda e: e.get("cat") == "cuda_runtime" and
                          "Memcpy" in e.get("name", ""))
    copied = correlations(lambda e: e.get("cat") == "gpu_memcpy")
    busy = union(("kernel", "gpu_memcpy", "gpu_memset"))
    kernel_busy = union(("kernel",))
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return {"launches": counts,
            "lost_kernel_records": len(launched - recorded),
            "lost_copy_records": len(copies - copied),
            "busy_share": busy / (t1 - t0),
            "idle_share": 1 - busy / (t1 - t0),
            "kernel_share": kernel_busy / (t1 - t0),
            "window_s": (t1 - t0) / 1e6, "device_busy_s": busy / 1e6,
            "kernel_busy_s": kernel_busy / 1e6,
            "kernel_events": len(kern),
            "kernel_names": sorted({e["name"][:120] for e in kern}),
            "trace_mb": files[0].stat().st_size / 1e6}


def profile_phase(db, db_path: Path, work: Path, n_reads: int, seed: int,
                  names, ref=None, extra=()) -> dict:
    """The CLI on ``n_reads`` reads in processes of its own, as a user runs
    it, without and with ``--profile DIR`` (``torch.profiler``, CPU and
    CUDA activity): the trace must account for every launch the profiled
    run counted (``kernel.launch.<name>``) of each wrapper in ``names``, by
    its kernel record or, where the profiler lost that record, by its
    runtime launch record (the trace then holds exactly as many launch
    records without a kernel record as the wrappers' kernel records fall
    short).  Reports the card's busy, idle and kernel shares over the
    profiled window, the records lost, and both runs' reads/s (process
    start, CUDA set-up and, profiled, the profiler's start and the trace's
    export included)."""
    plain = cli_phase(db, db_path, work, n_reads, seed, names, ref,
                      extra=extra, tag="_unprofiled", fresh=True)
    trace_dir = work / f"profile_{db_path.stem}"
    prof = cli_phase(db, db_path, work, n_reads, seed, names, ref,
                     extra=[*extra, "--profile", str(trace_dir)],
                     tag="_profiled", fresh=True)
    tr = read_trace(trace_dir, names)
    short = {n: prof["launches"][n] - tr["launches"][n] for n in names}
    check(min(short.values()) >= 0 and
          sum(short.values()) == tr["lost_kernel_records"],
          f"profile of {db_path.stem}: the trace counts {tr['launches']} "
          f"kernel records and {tr['lost_kernel_records']} launch records "
          f"without one, the wrappers {prof['launches']} launches (kernels "
          f"seen: {tr['kernel_names']})")
    return {"reads": n_reads, "reads_per_s": plain["reads_per_s"],
            "profiled_reads_per_s": prof["reads_per_s"],
            "launches": prof["launches"], "trace": tr}


def coded_batches(seed: int, ref, n: int) -> tuple:
    """``n`` batches of B_KERNEL reads (1% with an N, 5% short, half from
    ``ref`` when given) as ASCII and as ``PlacementEngine.encode_batch``
    gives them (ACGT -> 0-3, N -> -1 (ambiguous), the 0xFF padding -> -2):
    the k-mer-sharded phases' batches, and at ``seed + 1`` without
    ``ref`` the cross-process phase's config-1 batches."""
    import numpy as np

    rng = np.random.default_rng(seed + 9)
    batches = [random_reads(rng, B_KERNEL, B_KERNEL // 100, 0.05, ref=ref)
               for _ in range(n)]
    tab = np.full(256, -2, np.int8)
    tab[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    tab[ord("N")] = -1
    return batches, [(tab[m], ln) for m, ln in batches]


def postings_batches(seed: int, ref, n: int = 3) -> list:
    """The cross-process phase's config-5 batches: ``n`` of B_POSTINGS
    reads, 1% with an N, 5% short, half from ``ref``."""
    import numpy as np

    rng = np.random.default_rng(seed + 11)
    return [random_reads(rng, B_POSTINGS, B_POSTINGS // 100, 0.05, ref=ref)
            for _ in range(n)]


#: each mp pair of the cross-process mesh holds one device of each rank
#: (JAX's ``devs.reshape(2, 2).T`` over two processes, as
#: ``tests/test_multihost_mp.py`` builds it)
MP_RANKS = [[0, 1], [0, 1]]
#: the kernels each rank of the cross-process phase must launch
CROSS_PROCESS = ("accumulate_codes", "accumulate_rows_range",
                 "finalize_wire", "dense_side", "ambiguous_postings",
                 "finalize_postings_wire", "merge_candidates_wire")


def rank_main(rank: int, port: int, work: Path, devices: list,
              seed: int) -> int:
    """One rank of the cross-process phase (run by
    :func:`cross_process_phase` as ``chip_smoke.py --mp-rank R``): joins a
    two-rank gloo group on ``localhost:port``, forms the ``(dp=2, mp=2)``
    mesh with :data:`MP_RANKS`, scores config 1's column shards
    (``ShardedPlacement``, 3 batches of 16,384 reads), config 6's k-mer
    ranges (``KmerShardedPlacement``, 10 batches of 16,384) and config
    5's edge ranges (``ShardedEngine`` on postings, 3 batches of 8,192),
    and writes its results to ``work/rank{rank}.npz`` and its launches
    and seconds per batch to ``work/rank{rank}.json``."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from rappas_tpu_torch import utils
    from rappas_tpu_torch.db import PhyloKmerDB
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
    from rappas_tpu_torch.parallel.mesh import ShardedPlacement, make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=60))
    mesh = make_mesh(devices, dp=2, mp=2, ranks=MP_RANKS)
    check(mesh.local_rows() == [0, 1], f"rank {rank} holds rows "
          f"{mesh.local_rows()}")
    ref = config5_reference(seed)
    out, report = {}, {"rank": rank, "devices": [str(d) for d in devices],
                       "backends": [g[1] for g in mesh._groups.values()]}
    utils.trace_reset()
    for cfg, n in (("config1", 3), ("config6", 10), ("config5", 3)):
        db = PhyloKmerDB.load(work / f"{cfg}.rptpu")
        t0 = time.perf_counter()
        if cfg == "config1":
            eng = ShardedPlacement(db, mesh)
            batches = coded_batches(seed + 1, None, n)[1]
        elif cfg == "config6":
            eng = KmerShardedPlacement(db, mesh)
            batches = coded_batches(seed, ref, n)[1]
        else:
            eng = ShardedEngine(db, mesh)
            check(eng.table == "postings", f"config 5 on {eng.table}")
            batches = postings_batches(seed, ref, n)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [eng.score(*b) for b in batches]
        torch.cuda.synchronize()
        report[cfg] = {"setup_s": setup, "batches": n,
                       "s_per_batch": (time.perf_counter() - t0) / n,
                       "card_mb": torch.cuda.memory_allocated() / 1e6}
        if cfg != "config5":
            # a rank holds its own shard only
            report[cfg]["shards_here"] = [j for j, d in enumerate(eng.D)
                                          if d]
        for name, x in zip(res[0]._fields, zip(*res)):
            out[f"{cfg}/{name}"] = np.concatenate(x)
        del eng, db
    report["launches"] = launches(CROSS_PROCESS)
    np.savez(work / f"rank{rank}.npz", **out)
    (work / f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def cross_process_phase(work: Path, seed: int, want: dict,
                        devices: list) -> dict:
    """Two rank processes (:func:`rank_main`) on the mesh of ``devices``
    (a row group of gloo on one card, NCCL where each rank has a card of
    its own): each rank's results must equal ``want`` (``{cfg: the
    single-process mesh's BatchResults of the same batches}``) bitwise,
    and each rank must launch every kernel of :data:`CROSS_PROCESS`."""
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = Path(__file__).resolve()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--seed", str(seed), "--mp-rank",
         str(r), "--mp-port", str(port), "--mp-work", str(work),
         "--mp-devices", ",".join(devices)], cwd=script.parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"cross-process rank {r} exited with "
              f"{p.returncode}:\n{o[-3000:]}")
    ranks = []
    for r in range(2):
        got = np.load(work / f"rank{r}.npz")
        for cfg, res in want.items():
            for name in res[0]._fields:
                w = np.concatenate([getattr(x, name) for x in res])
                g = got[f"{cfg}/{name}"]
                check(g.dtype == w.dtype and g.shape == w.shape and
                      np.array_equal(g.view(np.uint8), w.view(np.uint8)),
                      f"cross-process rank {r}: {cfg} {name} differs from "
                      "the single-process mesh's")
        rep = json.loads((work / f"rank{r}.json").read_text())
        for name, n in rep["launches"].items():
            check(n > 0, f"cross-process rank {r}: kernel {name} was "
                  "never launched")
        ranks.append(rep)
    return {"wall_s": wall, "bitwise": True, "ranks": ranks}


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
#: the build phase's calibration: clean reads on the compact table
#: ``table="auto"`` takes (C1), then K3
BUILD = ("accumulate_compact", "finalize_wire")
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
                           "config5", "cli"),
    "finalize_postings_wire": ("postings.cu", _E + "654,684,68",
                               "config5", "cli"),
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
                                      "config5_routed", "engine"),
    "finalize_postings_wire_parts": ("postings.cu", _E + "654-681,535,68",
                                     "config5_select", "engine"),
    "gather_compact": ("postings.cu", _E + "557,566", "config5_two_stage",
                       "engine"),
    "ambiguous_postings_parts": ("ambiguous.cu", _E + "950,654-681,967",
                                 "config5_routed", "engine"),
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
    # one rank of the cross-process phase (the script starts them)
    ap.add_argument("--mp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mp-work", help=argparse.SUPPRESS)
    ap.add_argument("--mp-devices", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rappas_tpu_torch import _kernels
        from rappas_tpu_torch.db import PhyloKmerDB
        from rappas_tpu_torch.parallel.engine import ShardedEngine
        from rappas_tpu_torch.parallel.mesh import ShardedPlacement
        from rappas_tpu_torch.place.engine import PlacementEngine
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    if args.mp_rank is not None:
        return rank_main(args.mp_rank, args.mp_port, Path(args.mp_work),
                         args.mp_devices.split(","), args.seed)

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

    def show_layout(name):
        """The layout phase of ``name``: each side's layout, set-up s, MB
        on the card and engine reads/s (asserted nowhere)."""
        show(f"{name} layout", {side: {key: lay[name][side][key] for key in (
            "table", "setup_s", "card_mb", "reads_per_s", "launches")}
            for side in ("auto", "old")})

    results = {"card": card, "launch_floor_ms": launch_floor_ms()}
    show("launch floor", {"launch_floor_ms": results["launch_floor_ms"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        # the DB build: -p b --ardir, calibrated on the card ------- #
        bres, db, path, ref = build_phase(work, args.seed)
        for key, r in bres.items():
            show(f"build {key}", r)
        # the header's calibrated bound would drop reads from both the
        # jplace and the unplaced list, which the phase counts; reads
        # from the leaves hit on every window, so the accumulators reach
        # hundreds, where two f32 summation orders differ by more than
        # 2e-4: the card and the CPU engine are each held against f64
        cl = cli_phase(db, path, work, CLI_READS_U16, args.seed, COMPACT,
                       ref, extra=["--nsbound=-inf"], exact=True)
        show("build cli", cl)
        bres["cli"] = cl
        ex = exact_phase(db, ref, 1500, args.seed)
        show("build exact", ex)
        bres["exact"] = ex
        results["build"] = bres
        del db

        # config 1: direct layout (auto takes compact: layout phase) - #
        db, path = make_db("config1", config1_db, work)
        kern = kernel_phase(db, args.seed)
        for name, r in kern.items():
            show(f"kernel {name}", r)
        direct = {"table": "direct"}
        eng = engine_phase(db, args.seed, DIRECT, engine_kw=direct)
        eng["host_steps_s"] = host_steps(db, args.seed)
        show("config1 engine", eng)
        cl = cli_phase(db, path, work, args.cli_reads, args.seed, DIRECT,
                       extra=["--table", "direct"])
        show("config1 cli", cl)
        orc = oracle_phase(db, args.seed)
        show("config1 oracle", orc)
        pr = profile_phase(db, path, work, CLI_READS_U16, args.seed,
                           DIRECT, extra=["--table", "direct"])
        show("config1 profile", pr)
        results["config1"] = {"engine": eng, "cli": cl, "oracle": orc,
                              "profile": pr}
        lay = {"config1": layout_phase(db, args.seed, COMPACT, "direct",
                                       DIRECT)}
        show_layout("config1")

        # config 1 at u16 (direct) and compact f32 ------------------ #
        ku = kernel_phase(db, args.seed, "u16")
        for name, r in ku.items():
            show(f"kernel {name}", r)
        kern.update(ku)
        eng = engine_phase(db, args.seed, DIRECT_U16,
                           engine_kw={"precision": "u16", **direct},
                           against=(direct, 5e-3))
        check(eng["table"] == "direct", f"config 1 u16: {eng['table']}")
        show("config1 u16 engine", eng)
        cl = cli_phase(db, path, work, CLI_READS_U16, args.seed, DIRECT_U16,
                       precision="u16", extra=["--table", "direct"])
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
        # the cross-process phase's reference: ShardedPlacement (K2 per
        # column shard, the gather, K3) on the same batches here
        sp = ShardedPlacement(db, mesh)
        want = {"config1": [sp.score(c, ln) for c, ln in
                            coded_batches(args.seed + 1, None, 3)[1]]}
        del sp
        eng = engine_phase(db, args.seed, DIRECT, mesh=mesh,
                           engine_kw=direct)
        check(eng["table"] == "direct", f"config 1 sharded: {eng['table']}")
        show("config1 sharded engine", eng)
        pl = sharded_place_phase(db, mesh, work, CLI_READS_U16, args.seed,
                                 DIRECT, table="direct")
        show("config1 sharded place_queries", pl)
        results["config1_sharded"] = {"engine": eng, "place": pl}

        # config 2: the direct table height-split (k=10) ------------ #
        db, path = make_db("config2", config2_db, work)
        chain2 = key_chain(db, args.seed)
        # 100 MB parts: 13 of the f32 table, 7 of the u16 one
        Split2 = engine_class("DirectSplit", DIRECT_SPLIT_MIN=0,
                              DIRECT_PART_BYTES=100_000_000)
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
        lay["config2"] = layout_phase(db, args.seed, COMPACT, "postings",
                                      POSTINGS, chain2)
        show_layout("config2")
        del db

        # config 5: postings layout, large tree --------------------- #
        db, path = make_db("config5", config5_db, work)
        t0 = time.perf_counter()
        peng = PlacementEngine(db, device="cuda")
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
        # the split light table (no light table the card holds is split
        # by default): 2 routed parts, R1
        light_bytes = peng.pairs.nbytes

        def light_split(name, n_parts, **consts):
            return engine_class(name, LIGHT_PART_BYTES=light_bytes //
                                n_parts + 64, **consts)
        TwoParts = light_split("TwoParts", 2)
        deng = TwoParts(db, device="cuda")
        check(len(deng.light_parts) == 2 and deng._routed_windows,
              f"config 5 split: {len(deng.light_parts)} light parts, "
              f"routed {deng._routed_windows}")
        pk.update(split_postings_kernel_phase(deng, peng, args.seed, ref))
        del peng, deng
        for name, r in pk.items():
            show(f"kernel {name}", r)
        kern.update(pk)
        against = ({}, 2e-4, PlacementEngine)
        two_parts = path_check("PendingBatch", light_parts=2)
        one5 = engine_phase(db, args.seed, POSTINGS, batch=B_POSTINGS,
                            ref=ref, absent=SPLIT_POSTINGS,
                            inspect=path_check("PendingBatch",
                                               light_parts=1))
        show("config5 engine", one5)
        eng5 = engine_phase(db, args.seed, POSTINGS_ROUTED, batch=B_POSTINGS,
                            ref=ref, engine_cls=TwoParts, against=against,
                            inspect=two_parts,
                            absent=("ambiguous_postings",
                                    "finalize_postings_wire",
                                    "gather_compact"))
        show("config5 routed engine", eng5)
        cl5 = cli_phase(db, path, work, args.cli_reads, args.seed, POSTINGS,
                        ref)
        show("config5 cli", cl5)
        pr5 = profile_phase(db, path, work, CLI_READS_U16, args.seed,
                            POSTINGS, ref)
        show("config5 profile", pr5)
        results["config5"] = {"engine": one5, "cli": cl5, "profile": pr5}
        results["config5_routed"] = {"engine": eng5}
        for tag, names, cls, prep, inspect, kw in (
                ("two_stage", TWO_STAGE, TwoParts,
                 lambda e: e.enable_routed_windows(False), two_parts, {}),
                ("pipelined", TWO_STAGE, TwoParts,
                 lambda e: e.enable_pipeline(),
                 path_check("PipelinedBatch", light_parts=2), {}),
                ("four_parts", POSTINGS_ROUTED, light_split("FourParts", 4),
                 None, path_check("PendingBatch", light_parts=4), {}),
                ("select", SELECT,
                 light_split("SelectFallback", 2, TWO_STAGE_MAX_UNIQUE=0,
                             MIN_SPLIT_B=1024),
                 lambda e: e.enable_routed_windows(False),
                 path_check("SplitPending", light_parts=2),
                 {"n_batches": 3}),
                ("ambiguity_max", POSTINGS_ROUTED, TwoParts, None, two_parts,
                 {"n_batches": 3, "n_ambiguous": B_POSTINGS // 10,
                  "engine_kw": {"ambiguities_with_max": True}})):
            other = kw.get("engine_kw", {})
            e = engine_phase(db, args.seed, names, batch=B_POSTINGS, ref=ref,
                             engine_cls=cls, prepare=prep, inspect=inspect,
                             against=(other, 2e-4, PlacementEngine), **kw)
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
        # the cross-process phase's reference: the same batches here
        want["config5"] = [seng.score(m, ln) for m, ln in
                           postings_batches(args.seed, ref)]
        del seng
        show("config5 sharded engine", e5s)
        results["config5_sharded"] = {"engine": e5s}
        del db

        # config 6: k=12 on 300 edge slots, u16 -> compact ---------- #
        db, path = make_db("config6", config6_db, work)
        limit = PlacementEngine.table_budget("cuda")
        got = {p: PlacementEngine.resolve_table(db, "auto", p, limit)
               for p in ("f32", "u16")}
        check(got == {"f32": "compact", "u16": "compact"},
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
        lay["config6"] = layout_phase(db, args.seed, COMPACT, "postings",
                                      POSTINGS, ref)
        show_layout("config6")
        results["layout"] = lay

        # config 6 on the mesh: k-mer ranges, and compact columns ------ #
        kk, want["config6"], ke = kmer_sharded_phase(db, mesh, args.seed,
                                                     ref)
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
        del db, chain

        # the mp axis across two processes: config 1's column shards,
        # config 6's k-mer ranges and config 5's edge ranges, each rank
        # bitwise the mesh above ------------------------------------- #
        torch.cuda.empty_cache()
        runs = {"gloo": ["cuda:0"] * 4}
        if torch.cuda.device_count() >= 2:
            runs["nccl"] = ["cuda:0", "cuda:1"] * 2
        cp = {}
        for tag, devices in runs.items():
            cp[tag] = cross_process_phase(work, args.seed, want, devices)
            check(cp[tag]["ranks"][0]["backends"] == [tag, tag],
                  f"cross-process {tag}: row groups "
                  f"{cp[tag]['ranks'][0]['backends']}")
            show(f"cross-process {tag}", cp[tag])
        results["cross_process"] = cp
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
            **({"build_launches": results["build"]["synthetic"]["launches"]
                [name]} if name in BUILD else {}),
            **({"cross_process_launches": [
                rank["launches"][key]
                for rank in results["cross_process"]["gloo"]["ranks"]]}
               if key in CROSS_PROCESS else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in ("call_ms", "row_tb_s", "slabs",
                                       "evict_last",
                                       "resolve_pass", "paths",
                                       "light_only_windows",
                                       "max_pairs_per_window",
                                       "load_bytes", "threads_per_window",
                                       "path", "reads_per_warp",
                                       "reads_per_block", "tb_s",
                                       "slots", "heavy_hits",
                                       "distinct_rows", "longest_slot",
                                       "keep20")
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
