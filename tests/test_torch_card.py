"""On a CUDA card: each kernel of ``rappas_tpu_torch/csrc`` against its
plain PyTorch version.  Skips where no card is present (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it also runs where JAX is not
installed:

    RAPPAS_TPU_DEVICE_TESTS=1 python -m pytest -m cuda tests/test_torch_card.py

(``RAPPAS_TPU_DEVICE_TESTS=1`` keeps ``tests/conftest.py`` from importing
JAX.)  Tolerances as in ``chip_smoke.py``: accumulators within 1e-5
relative (summation order) on f32 tables and bitwise on uint16 ones
(sums of quantised values, exact in f32), the direct wire words
exactly, the ambiguity
passes within 2e-4 (atomic add order); P3 against its plain version with
``|L|`` exact and edges and scores as the engine tests hold them: scores
within 2e-4 (the kernel sums each edge's postings directly, the plain
version by a running cumsum), or two f32 ulps of the score where that is
more (a 3,000 bp read scores about -6,000, where one ulp is 4.9e-4).  The
sharded kernels: C3 as the other f32 accumulators, M1's wire words
bitwise, and the postings kernels on edge-range shards as P3.  P1 is held
bitwise against its sums in CSR order (no atomics,
``chip_smoke.inorder_slot_sums``) and K3's wire bitwise against
``pack_wire(*finalize(...))``.
"""

import numpy as np
import pytest
import torch
from torch_cases import (LIGHT_OPS, k3_rows, light_case, light_op,
                         shard_wires)

from chip_smoke import inorder_slot_sums
from rappas_tpu_torch import utils
from rappas_tpu_torch.alphabet import DNA
from rappas_tpu_torch.db import PhyloKmerDB, build_csr
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import (PlacementEngine, pack_reads,
                                           unpack_wire, window_offsets)
from rappas_tpu_torch.tree import parse_newick


def _launches(name: str) -> int:
    return utils.counter("kernel.launch." + name)


def _codes(rng, B, L, k, amb=0.0):
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
    codes[rng.random((B, L)) < amb] = -1
    codes[np.arange(L)[None, :] >= lens[:, None]] = -2
    return codes, lens


def _table(rng, n_rows, E, fill):
    D = np.where(rng.random((n_rows, E)) < fill,
                 rng.random((n_rows, E)) * 2.5 + 1e-3, 0).astype(np.float32)
    D[-1] = 0
    return D


def _amb_spec(rng, n_rows, n_win, B, max_w=4):
    W = rng.integers(1, max_w + 1, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    alt_rows = rng.integers(0, n_rows, alt_win.size).astype(np.int32)
    alt_rows[::5] = n_rows - 1
    win_read = np.sort(rng.integers(0, B, n_win)).astype(np.int32)
    return alt_rows, alt_win, win_read, (1.0 / W).astype(np.float32)



@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card):
    rng = np.random.default_rng(21)
    k, E, L, B = 8, 300, 150, 512
    D = torch.from_numpy(_table(rng, 4 ** k + 1, E, 0.02)).to(card)
    codes, lens = _codes(rng, B, L, k, amb=0.002)
    c, ln = torch.from_numpy(codes).to(card), torch.from_numpy(lens).to(card)
    rows = T.kmer_rows(c, k, 4, D.shape[0])
    got = T.accumulate_codes(D, c, k, 4)
    assert torch.allclose(got, T.accumulate(D, rows), rtol=1e-5, atol=1e-5)
    pure, plens = _codes(rng, B, L, k)
    p = torch.from_numpy(pack_reads(pure)).to(card)
    pl = torch.from_numpy(plens).to(card)
    got_p = T.accumulate_packed(D, p, pl, L, k)
    want_p = T.accumulate(D, T.kmer_rows_packed(p, pl, k, 4, D.shape[0], L))
    assert torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    thr = float(np.float32(-4.1))
    wire = T.finalize_wire(got_p, pl, thr, k, 7)
    assert torch.equal(wire, T.pack_wire(*T.finalize(
        got_p, pl, torch.tensor(np.float32(thr)), k, 7)))
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, D.shape[0], 40, B)
    is_mean = (rng.random(40) < 0.5)
    spec = [torch.from_numpy(x).to(card) for x in (
        alt_rows, window_offsets(alt_win, 40), win_read, inv_w,
        is_mean.astype(np.uint8))]
    acc = T.ambiguous_pass_(got.clone(), D, 1.0, *spec)
    want = T.ambiguous_pass(T.alt_delta_rows(D, 1.0, spec[0]),
                            torch.from_numpy(alt_win).to(card), spec[2],
                            spec[3], spec[4], got)
    torch.cuda.synchronize()
    assert torch.allclose(acc, want, atol=2e-4, rtol=0)


def _u16_table(rng, n_rows, E, fill):
    D = np.where(rng.random((n_rows, E)) < fill,
                 rng.integers(1, 65536, (n_rows, E)), 0).astype(np.uint16)
    D[-1] = 0
    return torch.from_numpy(D)


@pytest.mark.cuda
def test_u16_kernels_match_plain_on_card(card):
    """K1, K2 and K4 on a uint16 table: the sums of quantised values are
    exact in f32, so K1 and K2 equal their plain versions bitwise."""
    rng = np.random.default_rng(22)
    k, E, L, B = 8, 300, 150, 512
    D = _u16_table(rng, 4 ** k + 1, E, 0.02).to(card)
    scale = float(np.float32(2.5 / 65535))
    codes, lens = _codes(rng, B, L, k, amb=0.002)
    c = torch.from_numpy(codes).to(card)
    got = T.accumulate_codes(D, c, k, 4, scale)
    want = T.accumulate(D, T.kmer_rows(c, k, 4, D.shape[0])) * scale
    assert torch.equal(got, want)
    pure, plens = _codes(rng, B, L, k)
    p = torch.from_numpy(pack_reads(pure)).to(card)
    pl = torch.from_numpy(plens).to(card)
    got_p = T.accumulate_packed(D, p, pl, L, k, scale)
    assert torch.equal(got_p, T.accumulate(D, T.kmer_rows_packed(
        p, pl, k, 4, D.shape[0], L)) * scale)
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, D.shape[0], 40, B)
    spec = [torch.from_numpy(x).to(card) for x in (
        alt_rows, window_offsets(alt_win, 40), win_read, inv_w,
        (rng.random(40) < 0.5).astype(np.uint8))]
    acc = T.ambiguous_pass_(got.clone(), D, scale, *spec)
    want = T.ambiguous_pass(T.alt_delta_rows(D, scale, spec[0]),
                            torch.from_numpy(alt_win).to(card), spec[2],
                            spec[3], spec[4], got)
    torch.cuda.synchronize()
    assert torch.allclose(acc, want, atol=2e-4, rtol=0)
    assert torch.equal(acc > 0, want > 0)
    assert _launches("accumulate_codes_u16") > 0
    assert _launches("ambiguous_pass_u16") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("u16, E, n_keys", [(False, 300, 3000),
                                            (True, 300, 3000),
                                            (True, 600, 3000),
                                            (False, 300, 0)])
def test_compact_kernels_match_plain_on_card(card, u16, E, n_keys):
    """C1 (the key search on the card, with the empty key set) and C2
    (rows given) against their plain versions: bitwise on a uint16
    table, within 1e-5 relative on an f32 one (summation order)."""
    rng = np.random.default_rng(23 + E + n_keys)
    k, L, B = 8, 150, 256
    keys = np.sort(rng.choice(4 ** k, n_keys, replace=False))
    D = (_u16_table(rng, n_keys + 1, E, 0.05) if u16 else
         torch.from_numpy(_table(rng, n_keys + 1, E, 0.05))).to(card)
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0
    codes, lens = _codes(rng, B, L, k, amb=0.002)
    for b in range(0, B, 2):          # plant DB k-mers: windows that hit
        for j, key in enumerate(rng.choice(keys, 4) if n_keys else []):
            codes[b, 10 + 20 * j:18 + 20 * j] = [
                (int(key) >> (2 * (k - 1 - i))) & 3 for i in range(k)]
    keys_d = torch.from_numpy(keys.astype(np.int32)).to(card)
    c = torch.from_numpy(codes).to(card)
    rows = T.compact_rows(keys_d, T.kmer_indices64(c, k, 4))
    want = T.accumulate(D, rows) * scale
    got = T.accumulate_compact(D, keys_d, c, k, 4, scale)
    got_rows = T.accumulate_rows(D, rows, scale)
    torch.cuda.synchronize()
    for g in (got, got_rows):
        if u16:
            assert torch.equal(g, want)
        else:
            assert torch.allclose(g, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(g > 0, want > 0)
    assert bool((want > 0).any()) == bool(n_keys)


def _postings_db(seed, k=5, n_edges=40, n_kmers=300, heavy_frac=0.1,
                 every_kmer=False):
    """``tests/test_postings.py``'s skewed DB on the port's classes: most
    k-mers get 1-4 postings, a ``heavy_frac`` tail 12-30; with
    ``every_kmer`` all 4^k k-mers get 7 postings (every window hits; with
    many edges, so that an edge's segment stays short and its f32 sum
    exact to a few ulps)."""
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.{i % 9 + 1}" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    kmers = (np.arange(4 ** k) if every_kmer else
             rng.choice(4 ** k, size=n_kmers, replace=False))
    codes, edges = [], []
    for km in kmers:
        n = (7 if every_kmer else int(rng.integers(12, 31))
             if rng.random() < heavy_frac else int(rng.integers(1, 5)))
        es = rng.choice(np.arange(1, n_edges), size=min(n, n_edges - 1),
                        replace=False)
        codes.extend([km] * len(es))
        edges.extend(es)
    codes = np.array(codes, np.int64)
    scores = (thr + 0.01 + rng.random(codes.shape[0]) * 2.5
              ).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, np.array(edges, np.int32),
                                         scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


def _reads(rng, n, L, n_amb):
    mat = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))].copy()
    lens = np.full(n, L, np.int32)
    amb = rng.choice(n, n_amb, replace=False)
    mat[amb, rng.integers(0, L, n_amb)] = ord("N")
    return mat, lens


def _same_placements(a, b):
    assert np.array_equal(a.n_matched, b.n_matched)
    for i in range(a.n_matched.shape[0]):
        va, vb = a.top_edges[i] >= 0, b.top_edges[i] >= 0
        assert va.sum() == vb.sum(), f"read {i}"
        sa, sb = a.top_scores[i][va], b.top_scores[i][vb]
        assert np.allclose(sa, sb, atol=2e-4, rtol=2.5e-7), f"read {i}"
        if set(a.top_edges[i][va]) != set(b.top_edges[i][vb]):
            assert abs(float(sa[-1]) - float(sb[-1])) <= 2e-4, f"read {i}"


def _postings_kernels_vs_plain(db, mat, lens, card, width=8, plan=None):
    eng = PlacementEngine(db, device=card, table="postings",
                          postings_width=width)
    host, eplan = eng.postings_inputs(eng.encode_batch(mat), mat, lens)
    plan = plan or eplan
    host.pop("scratch_off", None)
    dev = {n: torch.from_numpy(np.ascontiguousarray(a)).to(card)
           for n, a in host.items()}
    acc_c = T.dense_side(eng.heavy_dense, dev["hrows"], dev["hoff"])
    slots = torch.repeat_interleave(
        torch.arange(acc_c.shape[0], device=card),
        (dev["hoff"][1:] - dev["hoff"][:-1]).long())
    want = T.scatter_slots(T.gather_rows(eng.heavy_dense, dev["hrows"]),
                           slots, acc_c.shape[0])
    torch.cuda.synchronize()
    assert torch.allclose(acc_c, want, rtol=1e-5, atol=1e-6)
    if "win_off" in dev:
        spec = [dev[n] for n in ("alt_lrows", "alt_hrows", "win_off",
                                 "win_slot", "win_inv_w", "win_is_mean")]
        got = T.ambiguous_postings_(acc_c.clone(), eng.heavy_dense,
                                    eng.pairs, *spec, layout=eng.light_layout)
        rows = T.alt_delta_rows_postings(eng.pairs, eng.heavy_dense,
                                         spec[0], spec[1],
                                         layout=eng.light_layout)
        alt_win = torch.repeat_interleave(
            torch.arange(spec[3].shape[0], device=card),
            (spec[2][1:] - spec[2][:-1]).long())
        want = T.ambiguous_pass(rows, alt_win, spec[3], spec[4], spec[5],
                                acc_c)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, atol=2e-4, rtol=0)
        assert torch.equal(got > 0, want > 0)
        acc_c = got
    args = (eng.pairs, dev["lrows"], acc_c, dev["slot_of"], dev["lengths"])
    wire = T.finalize_postings_wire(*args, eng.thr, eng.k, 7, plan.to(card),
                                    layout=eng.light_layout)
    want = T.pack_wire(*T.finalize_postings(
        *args, torch.tensor(np.float32(eng.thr)), eng.k, 7,
        layout=eng.light_layout), wide=eng.wide)
    torch.cuda.synchronize()
    K = min(7, eng.n_edges)
    _same_placements(unpack_wire(wire.cpu().numpy(), K, eng.wide),
                     unpack_wire(want.cpu().numpy(), K, eng.wide))
    return eng, host, plan


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 0])
def test_postings_kernels_match_plain_on_card(card, width):
    """P1-P3 against their plain versions, with heavy hits and ambiguity
    windows; width 0 puts every k-mer in the heavy table."""
    rng = np.random.default_rng(31)
    db = _postings_db(3)
    mat, lens = _reads(rng, 600, 60, 60)
    base = db.alphabet.kmer_to_string(int(db.keys[0]), db.k) * 12
    mat[:4] = np.frombuffer(base.encode(), np.uint8)[None]
    _postings_kernels_vs_plain(db, mat, lens, card, width)


@pytest.mark.cuda
def test_postings_long_read_takes_global_scratch(card):
    """A 3,000 bp read whose every window hits a 7-posting light k-mer
    (20,972 postings) does not fit one block's shared memory: P3 sorts it
    in the global scratch, beside 63 short reads in shared memory."""
    rng = np.random.default_rng(32)
    db = _postings_db(4, n_edges=2000, every_kmer=True)
    mat, lens = _reads(rng, 64, 3000, 8)
    lens[1:] = 150
    mat[1:, 150:] = 0xFF
    eng, host, plan = _postings_kernels_vs_plain(db, mat, lens, card)
    assert plan.scratch_off is not None
    off = plan.scratch_off.numpy()
    # its region holds exactly its light postings (its windows with an N
    # score on P2), past one block's shared memory
    light = int(eng._light_counts[host["lrows"][0]].sum())
    assert off[1] - off[0] == light > T.SMEM_PAIRS
    assert (np.diff(off)[1:] == 0).all()
    # every read in the scratch (a plan with no shared memory at all)
    counts = np.full(64, 20972)
    _postings_kernels_vs_plain(db, mat, lens, card,
                               plan=T.postings_plan(counts, smem_pairs=0))


@pytest.mark.cuda
def test_wide_wire_on_card(card):
    """E >= 65535 edge slots: K3 (the registers path and the scanning
    rounds) and P3 write int32 edge ids."""
    rng = np.random.default_rng(33)
    B, E = 40, 65601
    acc = torch.from_numpy(np.where(rng.random((B, E)) < 0.01,
                                    rng.random((B, E)) * 3, 0)
                           .astype(np.float32)).to(card)
    acc[:, 65590] = 5.0                 # the best edge needs 17 bits
    lens = torch.full((B,), 150, dtype=torch.int32, device=card)
    wire = T.finalize_wire(acc, lens, -4.0, 8, 7)
    assert wire.shape == (B, 15)
    assert torch.equal(wire, T.pack_wire(*T.finalize(
        acc, lens, torch.tensor(np.float32(-4.0)), 8, 7), wide=True))
    assert (wire[:, 7] == 65590).all()
    # K3's scanning rounds (keep 20) in the wide wire
    wire = T.finalize_wire(acc, lens, -4.0, 8, 20)
    assert torch.equal(wire, T.pack_wire(*T.finalize(
        acc, lens, torch.tensor(np.float32(-4.0)), 8, 20), wide=True))
    # P3 on a light table whose edge ids reach past 65535
    P, nl, n_slots = 8, 500, 10
    edges = np.sort(rng.choice(E, (nl + 1, P)), axis=1).astype(np.int32)
    edges[rng.random((nl + 1, P)) < 0.3] = np.iinfo(np.int32).max
    edges[-1] = np.iinfo(np.int32).max
    deltas = np.where(edges < E, rng.random((nl + 1, P)) * 2 + 1e-3,
                      0).astype(np.float32)
    pairs = torch.from_numpy(np.concatenate(
        [edges, deltas.view(np.int32)], axis=1)).to(card)
    lrows = torch.from_numpy(rng.integers(0, nl + 1, (B, 20))
                             .astype(np.int32)).to(card)
    slot_of = np.full(B, -1, np.int32)
    slot_of[rng.choice(B, n_slots, replace=False)] = np.arange(n_slots)
    slot_of = torch.from_numpy(slot_of).to(card)
    acc_c = acc[:n_slots].contiguous()
    args = (pairs, lrows, acc_c, slot_of, lens)
    wide = T.LightLayout.of(P, E)
    assert not wide.narrow
    wire = T.finalize_postings_wire(*args, -4.0, 8, 7,
                                    T.postings_plan(np.full(B, 20 * P)),
                                    layout=wide)
    want = T.pack_wire(*T.finalize_postings(
        *args, torch.tensor(np.float32(-4.0)), 8, 7, layout=wide), wide=True)
    torch.cuda.synchronize()
    _same_placements(unpack_wire(wire.cpu().numpy(), 7, True),
                     unpack_wire(want.cpu().numpy(), 7, True))


@pytest.mark.cuda
def test_accumulate_rows_range_matches_plain_on_card(card):
    """C3 on each k-mer-range shard: global rows folded into the shard's
    range (the miss row and other shards' rows add nothing)."""
    rng = np.random.default_rng(41)
    n, E, B, Q, mp = 5000, 300, 256, 143, 3
    per = -(-n // mp)
    rows = torch.from_numpy(rng.integers(0, n + 1, (B, Q))
                            .astype(np.int32)).to(card)
    for i in range(mp):
        D = torch.from_numpy(_table(rng, per + 1, E, 0.05)).to(card)
        got = T.accumulate_rows_range(D, rows, i * per, per)
        want = T.accumulate_range(D, rows, i * per, per)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got > 0, want > 0)
    assert _launches("accumulate_rows_range") >= mp


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1000, 4093])
@pytest.mark.parametrize("mp, K_in, keep, E, wide", [
    (2, 7, 7, 7999, False), (4, 3, 7, 20, False), (8, 7, 7, 300, False),
    (3, 5, 5, 70000, True), (4, 20, 20, 300, False), (2, 7, 3, 7999, False)])
def test_merge_candidates_wire_matches_plain_on_card(card, mp, K_in, keep,
                                                     E, wide, B):
    """M1 against its plain version, wire words bitwise: ties go to the
    lower shard, -inf slots stay empty, a finite score with no edge keeps
    its score, |L| sums (-1 propagates); B = 1, and B not a multiple of
    the reads per block (8)."""
    rng = np.random.default_rng(42 + mp)
    wires = shard_wires(rng, mp, B, K_in, E, wide)
    got = T.merge_candidates_wire(wires.to(card), K_in, keep, wide)
    want = T.merge_candidates_wire(wires, K_in, keep, wide)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if B > 4:
        assert int(want[4, -1]) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "u16"])
@pytest.mark.parametrize("n_parts, P, runs", [
    (1, 8, "all"), (2, 8, "all"), (32, 8, "empty"), (1, 7, "all"),
    (2, 7, "empty"), (32, 7, "empty"), (2, 8, "none"), (32, 7, "none")])
def test_gather_compact_cases_on_card(card, n_parts, P, runs, narrow):
    """G1 against its plain version, rows bitwise: one, 2 and 32 parts,
    every third run empty ("empty") or all of them ("none": U = 0), rows
    of int32 edge ids, P = 7 (56-byte rows: the 8-byte loads) and P = 8
    (16-byte loads), and of u16 ones, P = 7 (44-byte rows: the 4-byte
    loads) and P = 8 (48-byte rows: 16-byte loads)."""
    rng = np.random.default_rng(60 + n_parts + P)
    w = T.LightLayout(P, narrow).words
    heights = rng.integers(1000, 40000, n_parts)
    tables = tuple(torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, (h, w)).astype(np.int32))
        .to(card) for h in heights)
    uniq = []
    for p, h in enumerate(heights):
        empty = runs == "none" or (runs == "empty" and p % 3 == 1)
        size = 0 if empty else int(rng.integers(1, h // 2))
        uniq.append(np.sort(rng.choice(h, size, replace=False))
                    .astype(np.int32))
    off = np.concatenate([[0], np.cumsum([u.size for u in uniq])])
    flat = torch.from_numpy(np.concatenate(uniq)).to(card)
    got = T.gather_compact_(T.make_parts(tables, heights), flat,
                            torch.from_numpy(off.astype(np.int32)).to(card))
    want = T.gather_compact(tables, tuple(torch.from_numpy(u).to(card)
                                          for u in uniq))
    torch.cuda.synchronize()
    assert got.shape == (int(off[-1]), w)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dp, mp", [(1, 2), (2, 4)])
def test_postings_shards_match_plain_on_card(card, dp, mp):
    """P1, P2 and P3 with a shard's edge offset, and M1, through
    ``PostingsShardedPlacement`` on the card against the same placement's
    plain versions on the CPU (a mesh that repeats the card)."""
    from rappas_tpu_torch.parallel.mesh import make_mesh
    from rappas_tpu_torch.parallel.postings_sharded import \
        PostingsShardedPlacement
    rng = np.random.default_rng(43)
    db = _postings_db(5)
    mat, lens = _reads(rng, 64 * dp, 60, 16 * dp)
    base = db.alphabet.kmer_to_string(int(db.keys[0]), db.k) * 12
    mat[:4] = np.frombuffer(base.encode(), np.uint8)[None]
    host = PlacementEngine(db, device="cpu", table="postings")
    codes = host.encode_batch(mat)
    amb = host._expand_ambiguities_host(codes, mat, lens)
    runs = {}
    names = ("dense_side", "ambiguous_postings", "finalize_postings_wire",
             "merge_candidates_wire")
    for dev in ("cpu", "cuda"):
        sp = PostingsShardedPlacement(
            db, make_mesh([dev] * (dp * mp), dp=dp, mp=mp))
        before = {name: _launches(name) for name in names}
        runs[dev] = sp.score(codes, lens, amb)
        torch.cuda.synchronize()
    for name in names:
        assert _launches(name) > before[name], name
    _same_placements(runs["cuda"], runs["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["direct", "compact", "postings", "kmer"])
def test_sharded_engines_on_distinct_cards(card, table):
    """The sharded engines on a mesh of distinct cards (the all-gather's
    cross-device copies after an event on the source card's stream)
    against the same engines on a mesh that repeats the CPU.  Needs two
    or more cards; four make a (dp=2, mp=2) mesh."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards (cross-device copies)")
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.parallel.kmer_sharded import KmerShardedPlacement
    from rappas_tpu_torch.parallel.mesh import make_mesh
    dp = 2 if n >= 4 else 1
    rng = np.random.default_rng(44)
    db = _postings_db(6, n_edges=60)
    mat, lens = _reads(rng, 256, 80, 40)
    runs = {}
    for dev in ("cpu", "cuda"):
        devices = ([f"cuda:{i}" for i in range(2 * dp)] if dev == "cuda"
                   else ["cpu"] * (2 * dp))
        mesh = make_mesh(devices, dp=dp, mp=2)
        if table == "kmer":
            eng = PlacementEngine(db, device="cpu", table="direct")
            runs[dev] = KmerShardedPlacement(db, mesh).score(
                eng.encode_batch(mat), lens)
        else:
            runs[dev] = ShardedEngine(db, mesh, table=table).score(mat, lens)
        torch.cuda.synchronize()
    _same_placements(runs["cuda"], runs["cpu"])
    assert (runs["cuda"].n_matched > 0).any()


@pytest.mark.cuda
def test_split_postings_kernels_match_plain_on_card(card):
    """R1 (routed and part-select), G1 and A1 (P2 over the parts) on a
    light table split in 3 against their plain versions; R1's wires and P3
    on G1's compact table equal the one-table P3's wire bitwise (P3 sorts
    each read's postings by (edge, delta bits))."""
    rng = np.random.default_rng(51)
    db = _postings_db(7)
    mat, lens = _reads(rng, 400, 60, 40)
    base = db.alphabet.kmer_to_string(int(db.keys[0]), db.k) * 12
    mat[:4] = np.frombuffer(base.encode(), np.uint8)[None]
    one = PlacementEngine(db, device=card, table="postings")

    class Split(PlacementEngine):
        LIGHT_PART_BYTES = one.pairs.nbytes // 3 + 64
    eng = Split(db, device=card, table="postings")
    assert len(eng.light_parts) == 3 and eng._routed_windows
    host, plan = eng.postings_inputs(eng.encode_batch(mat), mat, lens)
    host.pop("scratch_off", None)
    plan = plan.to(card)
    dev = {n: torch.from_numpy(np.ascontiguousarray(a)).to(card)
           for n, a in host.items()}
    H = eng.heavy_dense
    acc_c = T.dense_side(H, dev["hrows"], dev["hoff"])
    spec = [dev[n] for n in ("alt_lrows", "alt_hrows", "win_off",
                             "win_slot", "win_inv_w", "win_is_mean")]
    lay = eng.light_layout
    assert lay.narrow
    got = T.ambiguous_postings_parts_(acc_c.clone(), H, eng._light, *spec,
                                      layout=lay)
    alt_win = torch.repeat_interleave(
        torch.arange(spec[3].shape[0], device=card),
        (spec[2][1:] - spec[2][:-1]).long())
    want = T.ambiguous_pass(T.alt_delta_rows_postings(
        eng.light_parts, H, spec[0], spec[1], layout=lay), alt_win,
        *spec[3:], acc_c)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=2e-4, rtol=0)
    assert torch.equal(got > 0, want > 0)
    args = (got, dev["slot_of"], dev["lengths"], eng.thr, eng.k, 7, plan)
    one_wire = T.finalize_postings_wire(one.pairs, dev["lrows"], *args,
                                        layout=lay)
    parts_wire = T.finalize_postings_wire_parts(eng._light, dev["lrows"],
                                                *args, miss=eng._nl,
                                                layout=lay)
    routed = torch.from_numpy(eng._route_windows(host["lrows"])).to(card)
    routed_wire = T.finalize_postings_wire_routed(eng._light, routed, *args,
                                                  layout=lay)
    eng.enable_routed_windows(False)
    eng.TWO_STAGE_MAX_BYTES = 1 << 30   # a compact budget for every row
    src = eng._light_source(host)
    assert src[0] == "compact"
    uniq = torch.from_numpy(host["uniq"]).to(card)
    off = torch.from_numpy(host["uniq_off"]).to(card)
    compact = T.gather_compact_(eng._light, uniq, off)
    bounds = host["uniq_off"].tolist()
    want_c = T.gather_compact(eng.light_parts, tuple(
        uniq[a:b] for a, b in zip(bounds[:-1], bounds[1:])))
    inv = torch.from_numpy(host["lrows"]).to(card)
    compact_wire = T.finalize_postings_wire(compact, inv, *args, miss=src[1],
                                            layout=lay)
    torch.cuda.synchronize()
    assert torch.equal(compact, want_c)
    for wire in (parts_wire, routed_wire, compact_wire):
        assert torch.equal(wire, one_wire)
    plain = T.pack_wire(*T.finalize_postings(
        None, None, got, dev["slot_of"], dev["lengths"],
        torch.tensor(np.float32(eng.thr)), eng.k, 7, layout=lay,
        light_parts=eng.light_parts, routed_lrows=tuple(routed)))
    _same_placements(unpack_wire(routed_wire.cpu().numpy(), 7),
                     unpack_wire(plain.cpu().numpy(), 7))
    for name in ("finalize_postings_wire_routed",
                 "finalize_postings_wire_parts", "gather_compact",
                 "ambiguous_postings_parts"):
        assert _launches(name) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("u16", [False, True])
def test_direct_split_kernels_match_plain_on_card(card, u16):
    """D1 and A1 (K4 over the parts) on a direct table split in 5, f32
    and uint16, against their plain versions: D1 bitwise on uint16 (exact
    f32 sums), within 1e-5 relative on f32; the ambiguity pass within
    2e-4 (atomic order), the global miss row reading a zero row."""
    from rappas_tpu_torch.convert import direct_parts
    from rappas_tpu_torch.place.engine import host_kmer_indices, route_rows
    rng = np.random.default_rng(52 + u16)
    k, E, L, B = 8, 300, 150, 256
    D = (_u16_table(rng, 4 ** k + 1, E, 0.02).numpy() if u16 else
         _table(rng, 4 ** k + 1, E, 0.02))
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0
    parts, cuts = direct_parts(D, D.nbytes // 5 + 1, 0, 64)
    tp = tuple(torch.from_numpy(p).to(card) for p in parts)
    sp = T.make_parts(tp, np.diff(cuts))
    codes, lens = _codes(rng, B, L, k, amb=0.002)
    kidx = host_kmer_indices(codes, lens, k, 4)
    rows = np.where(kidx >= 0, kidx, 4 ** k).astype(np.int32)
    routed = torch.from_numpy(route_rows(rows, cuts)).to(card)
    got = T.routed_accumulate_(sp, routed, scale)
    want = T.routed_accumulate(tp, tuple(routed)) * scale
    whole = T.accumulate(torch.from_numpy(D).to(card),
                         torch.from_numpy(rows).to(card)) * scale
    torch.cuda.synchronize()
    if u16:
        assert torch.equal(got, want) and torch.equal(got, whole)
    else:
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.allclose(got, whole, rtol=1e-5, atol=1e-5)
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, 4 ** k + 1, 40, B)
    spec = [torch.from_numpy(x).to(card) for x in (
        alt_rows, window_offsets(alt_win, 40), win_read, inv_w,
        (rng.random(40) < 0.5).astype(np.uint8))]
    acc = T.ambiguous_pass_split_(got.clone(), sp, scale, *spec)
    want = T.ambiguous_pass(T.alt_delta_rows_split(tp, scale, spec[0]),
                            torch.from_numpy(alt_win).to(card), spec[2],
                            spec[3], spec[4], got)
    torch.cuda.synchronize()
    assert torch.allclose(acc, want, atol=2e-4, rtol=0)
    assert torch.equal(acc > 0, want > 0)
    sfx = "_u16" if u16 else ""
    assert _launches("routed_accumulate" + sfx) > 0
    assert _launches("ambiguous_pass_split" + sfx) > 0


@pytest.mark.cuda
def test_split_engines_match_one_table_on_card(card):
    """The split postings engine's routed, two-stage, select and
    pipelined paths on the card equal the one-table engine bitwise."""
    rng = np.random.default_rng(53)
    db = _postings_db(8)
    mat, lens = _reads(rng, 256, 60, 20)
    one = PlacementEngine(db, device=card, table="postings")
    want = one.score(mat, lens)

    class Split(PlacementEngine):
        LIGHT_PART_BYTES = TWO_STAGE_MAX_BYTES = one.pairs.nbytes // 4 + 64
        MIN_SPLIT_B = 64

    class Select(Split):
        TWO_STAGE_MAX_UNIQUE = 0
    for cls, mode in ((Split, "routed"), (Split, "two-stage"),
                      (Select, "select"), (Split, "pipeline")):
        eng = cls(db, device=card, table="postings")
        if mode != "routed":
            eng.enable_routed_windows(False)
        if mode == "pipeline":
            eng.enable_pipeline()
            pend = [eng.score_async(mat, lens) for _ in range(3)]
            got = [p.result() for p in pend][-1]
        else:
            got = eng.score(mat, lens)
        assert np.array_equal(got.top_edges, want.top_edges), mode
        assert np.array_equal(got.top_scores.view(np.uint32),
                              want.top_scores.view(np.uint32)), mode
        assert np.array_equal(got.n_matched, want.n_matched), mode


# ---- the row-sum template's edges (csrc/accumulate.cu) ---------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 33, 300, 7999])
@pytest.mark.parametrize("u16", [False, True])
@pytest.mark.parametrize("slab_bytes", [None, 1 << 16])
def test_row_sum_edges_on_card(card, E, u16, slab_bytes, monkeypatch):
    """K1, K2, C1, C2 and C3 at E in {1, 33, 300, 7,999} (slab edges
    mid-vector, one slab, many), with the L2 slab budget as shipped and
    shrunk to 64 KB (many slabs, C1's resolve pass): reads shorter than
    k, all-miss reads, dest rows out of order, C1 with keys absent.
    Bitwise on uint16 tables, within 1e-5 relative on f32 ones."""
    if slab_bytes is not None:
        monkeypatch.setattr(T, "L2_SLAB_BYTES", slab_bytes)
    rng = np.random.default_rng(61 + E + u16)
    k = 8 if E <= 300 else 4
    L, B = 150, 200
    n_rows = 4 ** k + 1
    host = (_u16_table(rng, n_rows, E, 0.05).numpy() if u16 else
            _table(rng, n_rows, E, 0.05))
    D = torch.from_numpy(host).to(card)
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0

    def same(got, want):
        torch.cuda.synchronize()
        if u16:
            assert torch.equal(got, want)
        else:
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got > 0, want > 0)

    codes, lens = _codes(rng, B, L, k, amb=0.002)
    lens[:5] = rng.integers(0, k, 5)          # shorter than k: no window
    codes[:5][np.arange(L)[None, :] >= lens[:5, None]] = -2
    codes[5:9] = -1                           # all-miss reads
    c = torch.from_numpy(codes).to(card)
    dest = torch.from_numpy(rng.permutation(B + 7)[:B].astype(np.int32)
                            ).to(card)        # rows out of order
    acc = torch.zeros((B + 7, E), device=card)
    got = T.accumulate_codes(D, c, k, 4, scale, acc=acc, dest=dest)
    want = T.accumulate(D, T.kmer_rows(c, k, 4, n_rows)) * scale
    same(got[dest.long()], want)
    assert bool((want[5:9] == 0).all())
    pure, plens = _codes(rng, B, L, k)
    plens[:5] = rng.integers(0, k, 5)
    p = torch.from_numpy(pack_reads(pure)).to(card)
    pl = torch.from_numpy(plens).to(card)
    got = T.accumulate_packed(D, p, pl, L, k, scale, acc=acc, dest=dest)
    want = T.accumulate(D, T.kmer_rows_packed(p, pl, k, 4, n_rows, L)) * scale
    same(got[dest.long()], want)
    assert bool((want[:5] == 0).all())

    # C1 and C2 on a compact table: half the keys absent from the reads
    n_keys = 3000 if E <= 300 else 200
    keys = np.sort(rng.choice(4 ** k, n_keys, replace=False))
    Dc = host[:n_keys + 1].copy()
    Dc[-1] = 0
    Dc = torch.from_numpy(Dc).to(card)
    keys_d = torch.from_numpy(keys.astype(np.int32)).to(card)
    for b in range(0, B, 2):                  # plant DB k-mers
        for j, key in enumerate(rng.choice(keys[:n_keys // 2], 4)):
            codes[b, 10 + 20 * j:10 + 20 * j + k] = [
                (int(key) >> (2 * (k - 1 - i))) & 3 for i in range(k)]
    c = torch.from_numpy(codes).to(card)
    rows = T.compact_rows(keys_d, T.kmer_indices64(c, k, 4))
    want = T.accumulate(Dc, rows) * scale
    assert bool((want > 0).any())
    same(T.accumulate_compact(Dc, keys_d, c, k, 4, scale), want)
    if slab_bytes is not None and E == 7999:  # slabs: the resolve pass ran
        assert T.SLABS["accumulate_compact" + ("_u16" if u16 else "")
                       ].n_slabs > 1
    same(T.accumulate_rows(Dc, rows, scale), want)
    if not u16:                               # C3 on two k-mer ranges
        per = -(-n_keys // 2)
        for lo in (0, per):
            Ds = torch.from_numpy(_table(rng, per + 1, E, 0.05)).to(card)
            same(T.accumulate_rows_range(Ds, rows, lo, per),
                 T.accumulate_range(Ds, rows, lo, per))


# ---- P3's warp, block and scratch paths (csrc/postings.cu) ------------- #

_PAD = np.iinfo(np.int32).max


def _p3_inputs(rng, counts, n_edges, E=None, P=8, offset=0, slot_share=0.5):
    """A light table whose rows each read gathers to exactly ``counts[b]``
    real postings (edge ids in ``[0, n_edges)``, quarter deltas: every sum
    exact in f32, and exact ties), pads at random places in a row, the
    all-pad miss row last; a dense slot row of E columns (edges offset ..
    offset + E - 1), quarter values, for a ``slot_share`` of the reads."""
    E = n_edges if E is None else E
    rows, lists = [], []
    for c in counts:
        ids, left = [], int(c)
        while left > 0:
            m = min(P, left)
            e = np.full(P, _PAD, np.int64)
            d = np.zeros(P, np.float32)
            e[:m] = rng.integers(0, n_edges, m)
            d[:m] = rng.integers(1, 12, m) * 0.25
            perm = rng.permutation(P)
            ids.append(len(rows))
            rows.append((e[perm], d[perm]))
            left -= m
        lists.append(ids)
    rows.append((np.full(P, _PAD, np.int64), np.zeros(P, np.float32)))
    miss = len(rows) - 1
    pairs = np.concatenate([np.stack([r[0] for r in rows]).astype(np.int32),
                            np.stack([r[1] for r in rows]).view(np.int32)],
                           axis=1)
    B = len(counts)
    W = max(1, max(len(x) for x in lists))
    lrows = np.full((B, W), miss, np.int32)
    for b, ids in enumerate(lists):
        lrows[b, :len(ids)] = ids
    has = rng.random(B) < slot_share
    slot_of = np.where(has, np.cumsum(has) - 1, -1).astype(np.int32)
    acc_c = np.where(rng.random((int(has.sum()), E)) < 0.05,
                     rng.integers(1, 40, (int(has.sum()), E)) * 0.25,
                     0).astype(np.float32)
    return pairs, lrows, miss, acc_c, slot_of


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["counts", "ties", "k_is_e", "k16",
                                  "wide", "offset", "mixed"])
def test_p3_paths_on_card(card, case):
    """P3 and R1 (routed and part-select over 3 parts) against the plain
    version, wire words bitwise (quarter deltas: every sum exact): reads
    of 0, 1, 31, 32, 33 and 663 postings on the warp path; exact score
    ties (edge asc); K larger than a read's candidates; K = E and K = 16
    with a small E (the scanning rounds past a lane's registers); the
    wide wire; an edge offset; and one call that mixes warp-path,
    block-path and scratch reads.  Below 65,535 edge slots the same rows
    packed with u16 edge ids give the same wire words."""
    from rappas_tpu_torch.place.engine import route_rows
    rng = np.random.default_rng(71 + len(case))
    counts = [0, 1, 31, 32, 33, 663, 2, 5, 300, 64]
    n_edges, keep, offset, E = 7999, 7, 0, None
    plan_kw = {}
    if case == "ties":
        n_edges = 50
    elif case == "k_is_e":
        n_edges, keep = 20, 20
    elif case == "k16":
        n_edges, keep = 40, 16
    elif case == "wide":
        n_edges = 65601
    elif case == "offset":
        n_edges, E, offset = 400, 200, 150
    elif case == "mixed":
        counts = counts + [1024, 1025, 1500, 20000]
        plan_kw = {"smem_pairs": 2048}
    pairs, lrows, miss, acc_c, slot_of = _p3_inputs(
        rng, counts, n_edges, E, offset=offset)
    B = len(counts)
    lens = np.full(B, 3000, np.int32)
    lens[:B // 2] = 150
    thr, k = -1.25, 8
    cpu = [torch.from_numpy(a) for a in (pairs, lrows, acc_c, slot_of, lens)]
    plan = T.postings_plan(np.asarray(counts), **plan_kw)
    paths = plan.paths(B)
    if case == "mixed":
        assert paths == {"warp": B - 3, "block": 2, "scratch": 1}
    else:
        assert paths["warp"] == B
    wide = T.LightLayout(8, False)
    want = T.finalize_postings_wire(*cpu, thr, k, keep, plan, offset,
                                    n_edges, miss, layout=wide)
    dev = [t.to(card) for t in cpu]
    got = T.finalize_postings_wire(*dev, thr, k, keep, plan.to(card), offset,
                                   n_edges, miss, layout=wide)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    layouts = [(wide, pairs)]
    if n_edges < T.WIDE_EDGES:
        narrow = T.LightLayout(8, True)
        packed = narrow.pack(pairs[:, :8], pairs[:, 8:].view(np.float32))
        got = T.finalize_postings_wire(
            torch.from_numpy(packed).to(card), *dev[1:], thr, k, keep,
            plan.to(card), offset, n_edges, miss, layout=narrow)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        layouts.append((narrow, packed))
    K, wide, _ = T.wire_format(n_edges, keep, acc_c.shape[1])
    res = unpack_wire(want.numpy(), K, wide)
    assert (res.n_matched >= 0).all()
    if case == "ties":                  # exact ties among the picks
        s = res.top_scores
        assert (np.isfinite(s[:, 1:]) & (s[:, 1:] == s[:, :-1])).any()
    assert (res.top_edges[1] >= 0).sum() <= K    # K past the candidates
    if offset:
        return
    # R1 over 3 parts of the same table: the wire bitwise P3's
    cuts = np.array([0, pairs.shape[0] // 3, 2 * pairs.shape[0] // 3,
                     pairs.shape[0]])
    routed = torch.from_numpy(route_rows(lrows, cuts, drop=miss)).to(card)
    args = (dev[2], dev[3], dev[4], thr, k, keep, plan.to(card))
    for lay, table in layouts:
        tables = tuple(torch.from_numpy(table[a:c].copy()).to(card)
                       for a, c in zip(cuts[:-1], cuts[1:]))
        parts = T.make_parts(tables, np.diff(cuts))
        for wire in (T.finalize_postings_wire_routed(parts, routed, *args,
                                                     layout=lay),
                     T.finalize_postings_wire_parts(parts, dev[1], *args,
                                                    miss=miss, layout=lay)):
            torch.cuda.synchronize()
            assert torch.equal(wire.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", LIGHT_OPS)
@pytest.mark.parametrize("P", [45, 8])
def test_light_readers_on_narrow_rows_on_card(card, P, op):
    """Every reader of a light row on the card (P3, R1 routed and
    part-select, P3 on G1's compact table, P2, A1), on rows of u16 and of
    int32 edge ids, odd and even P, against the plain version on the
    int32 rows: wire words bitwise (quarter deltas), accumulators within
    2e-4 (atomic add order) with the same hit set."""
    case = light_case(P, seed=P)
    want = light_op(op, case, T.LightLayout(P, False), "cpu")
    for narrow in (True, False):
        got = light_op(op, case, T.LightLayout(P, narrow), card)
        torch.cuda.synchronize()
        got = got.cpu()
        if op in ("p2", "a1"):
            assert float((got - want).abs().max()) <= 2e-4, narrow
            assert torch.equal(got > 0, want > 0), narrow
        else:
            assert torch.equal(got, want), narrow


# ---- the ambiguity kernels (csrc/ambiguous.cu) ------------------------ #

def _light_pairs(rng, nl, P, n_edges, dup_share=0.2):
    """A light table int32[nl + 1, 2P] whose rows hold 1..P postings on
    edges in [0, n_edges), a ``dup_share`` of them with one edge twice
    (both deltas add), pads (LIGHT_PAD_EDGE, 0.0) past each row's count
    and an all-pad last row (the miss)."""
    edges = np.full((nl + 1, P), _PAD, np.int64)
    deltas = np.zeros((nl + 1, P), np.float32)
    for r in range(nl):
        n = int(rng.integers(1, P + 1))
        e = rng.choice(n_edges, n, replace=False)
        if n > 1 and rng.random() < dup_share:
            e[-1] = e[0]
        edges[r, :n] = e
        deltas[r, :n] = rng.random(n) * 2.5 + 1e-3
    return np.concatenate([edges.astype(np.int32), deltas.view(np.int32)],
                          axis=1)


def _postings_windows(rng, nl, nh, n_win):
    """Window specs over ``nl`` light and ``nh`` heavy rows: light-only
    windows of 4 alternatives (some misses), windows with one heavy
    alternative, a protein-width window of 20 light alternatives (160
    pairs at P = 8, past a warp's 32 lanes), and one of 40 alternatives
    (320 pairs: past the kernel's staging, read from the light rows)."""
    sizes = [4] * n_win
    sizes[3], sizes[7] = 20, 40
    alt_win = np.repeat(np.arange(n_win), sizes).astype(np.int32)
    n_alt = alt_win.size
    lrows = rng.integers(0, nl, n_alt)
    hrows = np.full(n_alt, nh)
    heavy = np.zeros(n_alt, bool)
    for w in range(0, n_win, 5):                 # a heavy alternative
        heavy[np.flatnonzero(alt_win == w)[1]] = True
    heavy[np.flatnonzero(alt_win == 7)[5]] = True
    lrows[heavy], hrows[heavy] = nl, rng.integers(0, nh, int(heavy.sum()))
    miss = rng.random(n_alt) < 0.15
    lrows[miss & ~heavy] = nl
    inv_w = (1.0 / np.asarray(sizes)).astype(np.float32)
    is_mean = (rng.random(n_win) < 0.6).astype(np.uint8)
    return (lrows.astype(np.int32), hrows.astype(np.int32), alt_win, inv_w,
            is_mean)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one", "parts", "offset"])
def test_ambiguous_postings_windows_on_card(card, case):
    """P2, A1 over 3 light parts and P2 on an edge-range shard against
    their plain versions (max abs error <= 2e-4, the same hit set): an
    odd E, light-only windows, windows with a heavy alternative, a
    20-alternative window, a window past the staging, duplicate edges in
    a light row, mean and max mode; on the shard, postings outside its
    edges add nothing.  The kernel reads the rows with int32 edge ids and
    packed with u16 ones alike."""
    rng = np.random.default_rng(81 + len(case))
    P, nl, nh, n_win, n_slots = 8, 500, 12, 60, 9
    n_edges, E, offset = (401, 200, 150) if case == "offset" else \
        (301, 301, 0)
    pairs = _light_pairs(rng, nl, P, n_edges)
    H = _table(rng, nh + 1, E, 0.3)
    lrows, hrows, alt_win, inv_w, is_mean = _postings_windows(
        rng, nl, nh, n_win)
    win_slot = rng.integers(0, n_slots, n_win).astype(np.int32)
    acc0 = _table(rng, n_slots + 1, E, 0.1)[:n_slots]
    spec = [torch.from_numpy(x).to(card) for x in (
        lrows, hrows, window_offsets(alt_win, n_win), win_slot, inv_w,
        is_mean)]
    Hd = torch.from_numpy(H).to(card)
    acc = torch.from_numpy(acc0).to(card)
    want = None
    for lay in (T.LightLayout(P, False), T.LightLayout(P, True)):
        table = lay.pack(pairs[:, :P], pairs[:, P:].view(np.float32))
        if case == "parts":
            cuts = [0, 170, 333, nl + 1]
            tables = tuple(torch.from_numpy(table[a:b].copy()).to(card)
                           for a, b in zip(cuts[:-1], cuts[1:]))
            light = tables
            got = T.ambiguous_postings_parts_(acc.clone(), Hd, T.make_parts(
                tables, np.diff(cuts)), *spec, layout=lay)
        else:
            light = torch.from_numpy(table).to(card)
            got = T.ambiguous_postings_(acc.clone(), Hd, light, *spec,
                                        offset, layout=lay)
        if want is None:               # the int32 rows' plain version
            want = T.ambiguous_pass(
                T.alt_delta_rows_postings(light, Hd, spec[0], spec[1],
                                          offset, layout=lay),
                torch.from_numpy(alt_win).to(card), spec[3], spec[4],
                spec[5], acc)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 2e-4, lay
        assert torch.equal(got > 0, want > 0), lay
        assert bool((got > acc).any())
    if case == "offset":           # some postings fall outside the shard
        e = pairs[lrows[lrows < nl], :P]
        assert ((e < offset) | ((e >= offset + E) & (e != _PAD))).any()


@pytest.mark.cuda
@pytest.mark.parametrize("u16, E, vec", [
    (False, 300, 4), (False, 302, 2), (False, 301, 1), (False, 20, 4),
    (True, 304, 8), (True, 300, 4), (True, 302, 2), (True, 301, 1)])
def test_ambiguous_direct_vec_on_card(card, u16, E, vec):
    """K4 and A1 (K4 over 4 parts of a split direct table) at widths that
    take 16-, 8-, 4- and 2-byte loads, with a thread per load (E = 20:
    5 threads per window, 51 windows per block; E = 301: 256 threads,
    some looping), against their
    plain versions: max abs error <= 2e-4
    (atomic order), the same hit set; the global miss row reads the last
    part's zero row."""
    from rappas_tpu_torch.convert import direct_parts
    rng = np.random.default_rng(91 + E + u16)
    n_rows, B, n_win = 3001, 64, 80
    D = (_u16_table(rng, n_rows, E, 0.05).numpy() if u16 else
         _table(rng, n_rows, E, 0.05))
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0
    assert T.ambiguous_plan(E, D.itemsize)[0] == vec
    parts, cuts = direct_parts(D, D.nbytes // 4 + 1, 0, 64)
    tp = tuple(torch.from_numpy(p).to(card) for p in parts)
    sp = T.make_parts(tp, np.diff(cuts))
    alt_rows, alt_win, win_read, inv_w = _amb_spec(rng, n_rows, n_win, B,
                                                   max_w=6)
    spec = [torch.from_numpy(x).to(card) for x in (
        alt_rows, window_offsets(alt_win, n_win), win_read, inv_w,
        (rng.random(n_win) < 0.5).astype(np.uint8))]
    acc = torch.from_numpy(_table(rng, B, E, 0.1)).to(card)
    alt_win_d = torch.from_numpy(alt_win).to(card)
    Dd = torch.from_numpy(D).to(card)
    for got, rows in (
            (T.ambiguous_pass_(acc.clone(), Dd, scale, *spec),
             T.alt_delta_rows(Dd, scale, spec[0])),
            (T.ambiguous_pass_split_(acc.clone(), sp, scale, *spec),
             T.alt_delta_rows_split(tp, scale, spec[0]))):
        want = T.ambiguous_pass(rows, alt_win_d, *spec[2:], acc)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 2e-4
        assert torch.equal(got > 0, want > 0)
        assert bool((got > acc).any())


# ---- the row-sum template's store modes (csrc/accumulate.cu) ---------- #

def _window_order_sum(D, rows):
    """f32 sums of ``D[rows[b, q]]`` added in window order q, one column
    at a time: the order the row-sum template keeps (misses are the zero
    row, which leaves a sum's bits unchanged)."""
    acc = np.zeros((rows.shape[0], D.shape[1]), np.float32)
    for q in range(rows.shape[1]):
        acc += D[rows[:, q]].astype(np.float32)
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("u16", [False, True])
@pytest.mark.parametrize("B, Q, E", [(300, 60, 300), (300, 60, 1100),
                                     (300, 60, 301), (40000, 6, 300)])
def test_routed_accumulate_parts_on_card(card, u16, B, Q, E):
    """D1 on parts of unequal height, one of them hit by no window (all
    pads), a read whose windows all lie in one part, and a read with no
    window; whole rows (E = 300, 16- and 8-byte loads), two slabs where E
    passes one block's loads (E = 1100; E = 301, one value per load), and
    more reads than the card's resident blocks take at once: bitwise
    equal to each part's window-order sum added in part order and scaled
    once (JAX's ``(a_0 + a_1 + ...) * scale``); u16 bitwise equal to the
    plain version and the unsplit table's sums, f32 within 1e-5 relative
    of them."""
    from rappas_tpu_torch.place.engine import route_rows
    rng = np.random.default_rng(101 + u16 + B + E)
    n = 9000
    D = (_u16_table(rng, n + 1, E, 0.05).numpy() if u16 else
         _table(rng, n + 1, E, 0.05))
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0
    cuts = np.array([0, 1000, 1500, 7000, n])
    rows = rng.integers(0, n + 1, (B, Q))
    rows[(rows >= 1000) & (rows < 1500)] = n     # part 1: all pads
    rows[0] = rng.integers(1500, 7000, Q)        # read 0: part 2 only
    rows[1] = n                                  # read 1: no window
    rows = rows.astype(np.int32)
    tables = [np.concatenate([D[a:b], np.zeros((1, E), D.dtype)])
              for a, b in zip(cuts[:-1], cuts[1:])]
    tp = tuple(torch.from_numpy(t).to(card) for t in tables)
    routed_np = route_rows(rows, cuts)
    assert (routed_np[1] == 500).all()
    routed = torch.from_numpy(routed_np).to(card)
    got = T.routed_accumulate_(T.make_parts(tp, np.diff(cuts)), routed,
                               scale)
    want = T.routed_accumulate(tp, tuple(routed)) * scale
    whole = T.accumulate(torch.from_numpy(D).to(card),
                         torch.from_numpy(rows).to(card)) * scale
    sums = [_window_order_sum(t, r) for t, r in zip(tables, routed_np)]
    ref = sums[0]
    for s in sums[1:]:
        ref = ref + s
    ref = ref * np.float32(scale)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          ref.view(np.uint32))
    if u16:
        assert torch.equal(got, want) and torch.equal(got, whole)
    else:
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.allclose(got, whole, rtol=1e-5, atol=1e-5)
    plan = T.SLABS["routed_accumulate" + ("_u16" if u16 else "")]
    assert plan.n_slabs == (1 if E == 300 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("u16", [False, True])
def test_k1_bits_in_window_order_on_card(card, u16):
    """K1 (the template's write mode) bitwise equal to the window-order
    f32 sums times the scale, with the L2 slabs as shipped (4 slabs of
    76 columns for f32 on the config-1 table, 2 for u16)."""
    rng = np.random.default_rng(111 + u16)
    k, E, L, B = 8, 300, 150, 512
    D = (_u16_table(rng, 4 ** k + 1, E, 0.02).numpy() if u16 else
         _table(rng, 4 ** k + 1, E, 0.02))
    scale = float(np.float32(2.5 / 65535)) if u16 else 1.0
    pure, plens = _codes(rng, B, L, k)
    p = torch.from_numpy(pack_reads(pure)).to(card)
    pl = torch.from_numpy(plens).to(card)
    Dd = torch.from_numpy(D).to(card)
    got = T.accumulate_packed(Dd, p, pl, L, k, scale)
    rows = T.kmer_rows_packed(p, pl, k, 4, D.shape[0], L).cpu().numpy()
    ref = _window_order_sum(D, rows) * np.float32(scale)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          ref.view(np.uint32))
    sfx = "_u16" if u16 else ""
    assert T.SLABS["accumulate_packed" + sfx].n_slabs > 1


# ---- K3 and P1 (csrc/finalize.cu, csrc/postings.cu) ------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 31, 300, 301, 7999])
@pytest.mark.parametrize("keep", [1, 7, 8, 9, 20])
def test_finalize_wire_cases_on_card(card, E, keep):
    """K3 bitwise against ``pack_wire(*finalize(...))``: the registers
    path (keep <= 8) and the
    scanning rounds (keep > 8), rows with no match and with every column
    matched, exact S ties from distinct acc under a large |Q * thr|, row
    starts at every 16-byte alignment (E odd), and B odd (a half warp with
    no read)."""
    rng = np.random.default_rng(E * 31 + keep)
    B, k, thr = 37, 8, np.float32(-4.1)
    lens = rng.integers(k, 3000, B).astype(np.int32)
    lens[2::3] = 3000                   # |Q * thr| ~ 12,000: ulp 2^-10
    acc = k3_rows(rng, B, E, 12000.0)
    a, ln = torch.from_numpy(acc).to(card), torch.from_numpy(lens).to(card)
    want = T.pack_wire(*T.finalize(torch.from_numpy(acc),
                                   torch.from_numpy(lens), torch.tensor(thr),
                                   k, keep))
    got = T.finalize_wire(a, ln, float(thr), k, keep)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert int(want[0, -1]) == 0 and int(want[1, -1]) == E


def _p1_case(rng, nh, E, word_offset, card):
    """A heavy table f32[nh + 1, E] on the card whose data starts
    ``word_offset`` words past a 16-byte boundary (so rows start at every
    alignment whatever E is), and slots of 0, 1, a few and 230 sources,
    one row repeated in many slots."""
    H_np = _table(rng, nh + 1, E, 0.3)
    buf = torch.zeros(H_np.size + 4, dtype=torch.float32, device=card)
    H = buf[word_offset:word_offset + H_np.size].view(nh + 1, E)
    H.copy_(torch.from_numpy(H_np))
    sizes = np.array([0, 1, 3, 230, 0, 2, 1, 17, 0, 5] * 3 + [0])
    hrows = rng.integers(0, nh, int(sizes.sum())).astype(np.int32)
    hrows[::4] = 7                      # a popular row
    hoff = np.zeros(sizes.size + 1, np.int32)
    np.cumsum(sizes, out=hoff[1:])
    return H, torch.from_numpy(hrows).to(card), torch.from_numpy(hoff).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [300, 4000, 7998, 7999])
@pytest.mark.parametrize("word_offset", [0, 1, 2, 3])
def test_dense_side_cases_on_card(card, E, word_offset):
    """P1 bitwise equal to the in-order f32 sums and within 1e-5 relative
    of the plain ``scatter_slots(gather_rows(...))`` (atomic order on the
    card): source rows at all four
    16-byte alignments, slots with 0, 1 and 230 sources (an empty slot is
    a zero row), a row repeated across slots."""
    rng = np.random.default_rng(E + word_offset)
    H, hrows, hoff = _p1_case(rng, 50, E, word_offset, card)
    if word_offset:
        assert H.data_ptr() % 16 == 4 * word_offset
    want = inorder_slot_sums(H, hrows, hoff)
    n_slots = hoff.numel() - 1
    slots = torch.repeat_interleave(torch.arange(n_slots, device=card),
                                    (hoff[1:] - hoff[:-1]).long())
    plain = T.scatter_slots(T.gather_rows(H, hrows), slots, n_slots)
    got = T.dense_side(H, hrows, hoff)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.allclose(got, plain, rtol=1e-5, atol=0)
    assert not bool(got[0].any()) and bool(got[3].any())


@pytest.mark.cuda
def test_dense_side_edge_range_shard_on_card(card):
    """P1 on an edge-range shard's own heavy table (columns 3,999 ..
    7,998 of a 7,999-column table, as ``parallel/postings_sharded.py``
    cuts it): bitwise the in-order sums of the same columns of the whole
    table."""
    rng = np.random.default_rng(5)
    H, hrows, hoff = _p1_case(rng, 40, 7999, 0, card)
    shard = H[:, 3999:].contiguous()
    got = T.dense_side(shard, hrows, hoff)
    whole = inorder_slot_sums(H, hrows, hoff)
    torch.cuda.synchronize()
    assert torch.equal(got, inorder_slot_sums(shard, hrows, hoff))
    assert torch.equal(got, whole[:, 3999:])


@pytest.mark.cuda
def test_calibrate_on_card_matches_cpu(card):
    """``calibrate`` on the card on the layout ``table="auto"`` takes (the
    compact table: C1 and K3 on every batch, calibration reads being clean
    ACGT) and on the direct table (K1 and K3) gives the CPU bound within
    2e-4 on the same reads."""
    from chip_smoke import bench_db
    from rappas_tpu_torch.build import calibration
    from rappas_tpu_torch.build.calibration import calibrate

    db = bench_db(1, 6, 0.6)
    kw = {"n_samples": 20_000, "mean_length": 60, "batch_size": 4096}
    on_cpu = calibrate(db, device="cpu", **kw)
    assert calibration.LAST_RUN["table"] == "compact"
    for table, row_sum in (("compact", "accumulate_compact"),
                           ("direct", "accumulate_packed")):
        engine = PlacementEngine(db, device="cuda", table=table,
                                 treat_ambiguities=False)
        utils.trace_reset()
        on_card = calibrate(db, engine=engine, device="cuda", **kw)
        launched = {n: _launches(n) for n in (row_sum, "finalize_wire")}
        assert launched == {row_sum: 5, "finalize_wire": 5}
        assert _launches("accumulate_codes") == 0
        assert np.isfinite(on_card) and abs(on_card - on_cpu) <= 2e-4
