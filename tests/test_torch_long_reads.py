"""Full-length 16S reads (``portbench/traffic/hifi1450.json``) on the
4,000-taxon k=10 deployment: every read's light postings pass one block's
shared memory, so P3 sorts them in its global scratch.

On the CPU, at the deployment's recipe cut to k=6 and 2,000 slots (45
postings a key, reads at their full 1,400-1,550 bp): ``place_queries``
through ``cli._make_engine`` against ``portbench/reference.py`` with the
cell's limits, P3's counters and plan span on known batches (one-device
and mesh engines), the two readers of the cell's per-layer metrics on
synthetic run records, and the mix's samples.  On the card (``-m cuda``,
skips without one): P3 on a 1,024-read batch of 1,400-1,550 bp reads at
the deployment's widths, bitwise its plain version:

    RAPPAS_TPU_DEVICE_TESTS=1 python -m pytest -m cuda \\
        tests/test_torch_long_reads.py
"""

import math
import time

import numpy as np
import pytest
import torch

from portbench import cell, roofline, traffic
from rappas_tpu_torch import utils
from rappas_tpu_torch.db import LIGHT_PAD_EDGE
from rappas_tpu_torch.parallel.engine import ShardedEngine
from rappas_tpu_torch.parallel.mesh import make_mesh
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import PlacementEngine

CELL = "c5-4000taxa-k10.hifi1450"
#: the deployment's recipe at k=6 and 2,000 slots, as
#: tests/test_torch_large_tree.py cuts it
SMALL = {"k": 6, "n_edge_slots": 2000}
#: the mix cut to a CPU's size; the reads keep their lengths
MIX = {"reads_per_sample": 24, "pool": 2, "check_calls": 2}
PATHS = ("warp", "block", "scratch")


def _spec():
    s = cell.load_spec(CELL)
    s["config"].update(SMALL)
    s["mix"].update(MIX)
    return s


def _db(config, seed):
    recipe = cell.load_module(cell.HERE / "recipes" /
                              f"{config['recipe']}.py", "recipe")
    return cell.program_db(config, recipe.make(config, seed))


def _metric(name):
    return cell.load_module(cell.HERE / "metrics" / f"{name}.py",
                            "metric_" + name.replace(".", "_"))


@pytest.fixture
def reset_trace():
    utils.tracing(False)
    utils.trace_reset()
    yield
    utils.tracing(False)
    utils.trace_reset()


@pytest.fixture(scope="module")
def small_db():
    return _db(_spec()["config"], 25)


def _postings_engine(db, **kw):
    return PlacementEngine(db, device="cpu", table="postings",
                           postings_width=45, **kw)


def _reads(rng, lens):
    """uint8 [B, max(lens)] uniform ACGT reads, 0xFF padded."""
    lens = np.asarray(lens, np.int32)
    m = rng.choice(np.frombuffer(b"ACGT", np.uint8), (lens.size, lens.max()))
    m[np.arange(lens.max())[None, :] >= lens[:, None]] = 0xFF
    return m.astype(np.uint8), lens


def test_hifi1450_samples():
    """Lengths evenly spaced over 1,400-1,550 bp, no N, exactly half of
    each sample copies of an earlier read, at the mix's own size."""
    mix = cell.load_spec(CELL)["mix"]
    assert (mix["length"], mix["duplicate_share"], mix["reads_per_sample"],
            mix["pool"], mix["check_calls"]) == \
        ({"min": 1400, "max": 1550}, 0.5, 4000, 16, 4)
    rng = np.random.default_rng([2 ** 31 + 1450, 1])
    for tag in ("s0", "s1"):
        sample = traffic.make_sample(mix, rng, tag)
        seqs = sample.seqs
        assert len(seqs) == 4000
        lens = np.array([len(s) for s in seqs])
        assert lens.min() >= 1400 and lens.max() <= 1550
        assert not any(b"N" in s for s in seqs)
        assert set(b"".join(seqs)) <= set(b"ACGT")
        distinct = list(dict.fromkeys(seqs))
        assert len(distinct) == 2000 == 4000 * (1 - mix["duplicate_share"])
        assert sorted(len(s) for s in distinct) == \
            np.rint(np.linspace(1400, 1550, 2000)).astype(int).tolist()


def test_place_queries_on_the_scratch_path(tmp_path, monkeypatch,
                                          reset_trace):
    """The cell at the CPU size, past a compact line patched under its
    table: ``auto`` takes postings at width 45, every read P3 scores in
    the traced run has its postings in the global scratch, and the placements and the
    not-placed logs are within the cell's limits of the f64 reference."""
    s = _spec()
    E, n = SMALL["n_edge_slots"], 4 ** SMALL["k"]
    monkeypatch.setattr(PlacementEngine, "AUTO_COMPACT_BYTES",
                        (n + 1) * E * 4 - 1)
    engines = []
    run = cell.run(s, 2 ** 31 + 1450, 0.5, True, tmp_path, time.time(),
                   device="cpu",
                   engine_wrap=lambda e: engines.append(e) or e)
    assert run["table"] == "postings"
    assert engines[0].postings_width == 45
    assert run["failure"] is None
    correct, rows = cell.verdict(run["numbers"], s["limits"], run["failure"])
    assert correct, rows
    assert run["numbers"]["calls_checked"] >= 1
    assert run["numbers"]["placements"] > 0
    c = utils.trace_totals()["counters"]
    assert c["engine.p3_reads_scratch"] > 0
    assert c["engine.p3_reads_warp"] == c["engine.p3_reads_block"] == 0
    assert c["engine.p3_postings"] > T.SMEM_PAIRS * c[
        "engine.p3_reads_scratch"]


def _known_batch():
    """Reads on each of P3's paths at width 45: 20 bp (11 windows, the
    warp path), 200 bp (the block path in shared memory), 1,400 and
    1,550 bp (the scratch), one too short for a window, and a pad row
    as the batcher fills a batch with (length 0)."""
    return _reads(np.random.default_rng(7),
                  [20, 200, 1400, 1550, 5, 200, 0])


def test_p3_counters_on_a_known_batch(small_db, reset_trace):
    eng = _postings_engine(small_db)
    m, lens = _known_batch()
    codes = eng.encode_batch(m)
    host, plan = eng.postings_inputs(codes, m, lens)
    B = lens.size
    assert plan.paths(B) == {"warp": 3, "block": 2, "scratch": 2}
    lrows = host["lrows"]
    rows = np.unique(lrows[lrows != eng._nl])
    # off: no P3 counter (the plan's paths are read back on the host)
    utils.trace_reset()
    off = eng.score(m, lens)
    assert not any(n.startswith("engine.p3_")
                   for n in utils.trace_totals()["counters"])
    # on: the plan's counters, the distinct light rows and their
    # postings, and the plan's span inside the batch's inputs
    utils.trace_reset()
    utils.tracing(True)
    on = eng.score(m, lens)
    tot = utils.trace_totals()
    c = tot["counters"]
    # the read of 5 bp has no window and no postings, but is a read; the
    # batcher's pad rows (length 0) are not
    live = plan.paths(B, lens > 0)
    assert live == {"warp": 2, "block": 2, "scratch": 2}
    for path in PATHS:
        assert c[f"engine.p3_reads_{path}"] == live[path]
    assert c["engine.p3_scratch_bytes"] == plan.n_scratch * 12 > 0
    assert plan.n_scratch == plan.postings - int(
        eng._light_counts[lrows[lens < 1400]].sum())
    assert c["engine.p3_postings"] == plan.postings == \
        int(eng._light_counts[lrows].sum())
    assert c["engine.p3_row_slots"] == lrows.size
    assert c["engine.p3_light_rows"] == rows.size
    assert c["engine.p3_row_postings"] == int(eng._light_counts[rows].sum())
    assert tot["spans"]["engine.plan"]["count"] == 1
    assert tot["spans"]["engine.inputs"]["total_s"] >= \
        tot["spans"]["engine.plan"]["total_s"]
    # counting changes nothing placed
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_p3_counters_on_a_mesh(small_db, reset_trace):
    """The mesh engine counts each shard's P3 launch: every read once a
    shard, and the shards' postings, and those of the distinct rows they
    read, add up to the one-device engine's (each posting lies in one
    edge range)."""
    m, lens = _known_batch()
    utils.tracing(True)
    _postings_engine(small_db).score(m, lens)
    want = utils.trace_totals()["counters"]
    utils.trace_reset()
    mesh = ShardedEngine(small_db, make_mesh(["cpu"] * 2, dp=1, mp=2),
                         table="postings", postings_width=45)
    mesh.score(m, lens)
    c = utils.trace_totals()["counters"]
    assert sum(c[f"engine.p3_reads_{p}"] for p in PATHS) == \
        2 * int((lens > 0).sum())
    assert c["engine.p3_reads_scratch"] >= 2
    for name in ("engine.p3_postings", "engine.p3_row_postings"):
        assert c[name] == want[name] > 0
    assert c["engine.p3_light_rows"] >= want["engine.p3_light_rows"]


def _record(counters=None, ops=None, cell_name=CELL):
    run = {"cell": cell_name}
    if counters is not None:
        run["counters"] = counters
    if ops is not None:
        run["trace"] = {"device_ops": ops, "kernel_s": 1.0}
    return run


P3_BLOCK = ("void (anonymous namespace)::finalize_postings_kernel<"
            "(anonymous namespace)::OneTable, true>(...)")
P3_WARP = ("void (anonymous namespace)::finalize_postings_warp_kernel<"
           "(anonymous namespace)::OneTable, true>(...)")


def test_scratch_read_pct_reader():
    read = _metric("engine.scratch_read_pct").read
    c = {"engine.p3_reads_warp": 1, "engine.p3_reads_block": 3,
         "engine.p3_reads_scratch": 12}
    assert read(_record(c)) == 75.0
    assert read(_record(dict(c, **{"engine.p3_reads_scratch": 0}))) == 0.0
    # no P3 launch (a compact cell), or an untraced run: nothing
    assert read(_record({"place.reads": 9})) is None
    assert read(_record()) is None


def test_postings_roofline_reader():
    mod = _metric("kernel.postings_roofline_pct")
    c = {"engine.p3_reads_warp": 0, "engine.p3_reads_block": 24,
         "engine.p3_reads_scratch": 1000, "engine.p3_postings": 67_000_000,
         "engine.p3_row_slots": 1024 * 1541,
         "engine.p3_light_rows": 760_000,
         "engine.p3_row_postings": 760_000 * 45}
    ops = [[P3_BLOCK, 0.07], ["Memcpy HtoD (Pinned -> Device)", 0.002],
           [P3_WARP, 0.01]]
    # c5's 8,000 slots: u16 edge ids, 6 bytes a posting
    nbytes = 760_000 * 45 * 6 + 1024 * 1541 * 4 + 1024 * 7 * 6
    assert mod.p3_bytes(c, 2) == nbytes
    assert mod.p3_ops(c) == pytest.approx(67e6 * math.log2(67e6 / 1024))
    want = 100 * roofline.least_seconds(nbytes, mod.p3_ops(c)) / 0.08
    assert mod.read(_record(c, ops)) == pytest.approx(want)
    assert 0 < mod.read(_record(c, ops)) < 100
    # past 65,534 edge slots ids take 4 bytes
    assert mod.edge_id_bytes(8000) == 2 and mod.edge_id_bytes(65535) == 4
    assert mod.p3_ops({"engine.p3_reads_block": 5}) == 0.0
    # no P3 kernel in the trace, an untraced run, or no counted rows
    # (a compact cell, or a program without the counters): nothing
    assert mod.read(_record(c, ops[1:2])) is None
    assert mod.read(_record(c)) is None
    assert mod.read(_record(None, ops)) is None
    no_rows = {k: v for k, v in c.items() if k != "engine.p3_row_postings"}
    assert mod.read(_record(no_rows, ops)) is None


def _long_batch(rng, B=1024, W=45, E=8000, k=10, n_rows=1 << 16):
    """P3's inputs at the deployment's widths for ``B`` reads of
    1,400-1,550 bp: a light table of rows of ``W`` real postings
    (distinct edges, quarter deltas: every sum exact in f32), the all-pad
    miss row last; each read's windows hit rows, its row list padded
    with the miss row; no read has a dense slot."""
    start = rng.integers(0, E - 1, (n_rows, 1))
    stride = rng.integers(1, (E - 1) // W, (n_rows, 1))
    edges = 1 + (start + np.arange(W) * stride) % (E - 1)
    deltas = (rng.integers(1, 12, (n_rows, W)) * 0.25).astype(np.float32)
    pairs = np.concatenate([
        np.concatenate([edges.astype(np.int32), deltas.view(np.int32)], 1),
        np.concatenate([np.full((1, W), LIGHT_PAD_EDGE, np.int32),
                        np.zeros((1, W), np.int32)], 1)])
    lens = rng.permutation(np.rint(np.linspace(1400, 1550, B))
                           .astype(np.int32))
    Q = lens - k + 1
    lrows = rng.integers(0, n_rows, (B, int(Q.max()))).astype(np.int32)
    lrows[np.arange(Q.max())[None, :] >= Q[:, None]] = n_rows
    return pairs, lrows, lens, n_rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_p3_long_reads_on_the_scratch_on_card(card):
    """P3 on a 1,024-read batch of 1,400-1,550 bp reads at the
    deployment's widths (45 postings a row, u16 edge ids, E = 8,000):
    every read past one block's shared memory, sorted in a region of the
    global scratch of as many slots as its postings (no pad stored, where
    the sort network's power of two is 65,536 or 131,072), and the wire
    bitwise the plain version's."""
    rng = np.random.default_rng(1450)
    pairs, lrows, lens, miss = _long_batch(rng)
    B, E, k, keep, thr = lrows.shape[0], 8000, 10, 7, -4.25
    counts = (pairs[lrows, :45] != LIGHT_PAD_EDGE).sum(axis=(1, 2))
    assert counts.min() > T.SMEM_PAIRS
    plan = T.postings_plan(counts)
    assert plan.paths(B) == {"warp": 0, "block": 0, "scratch": B}
    assert np.array_equal(np.diff(plan.scratch_off.numpy()), counts)
    assert set(T._pow2(counts).tolist()) == {65536, 131072}
    narrow = T.LightLayout.of(45, E)
    assert narrow.narrow and narrow.words == 68
    packed = torch.from_numpy(
        narrow.pack(pairs[:, :45], pairs[:, 45:].view(np.float32)))
    acc_c = torch.zeros((0, E), dtype=torch.float32)
    slot_of = torch.full((B,), -1, dtype=torch.int32)
    lengths = torch.from_numpy(lens)
    rows = torch.from_numpy(lrows)
    # the plain version in slices of reads (its arrays are [B, W x 45])
    want = torch.cat([T.finalize_postings_wire(
        packed, rows[i:i + 128], acc_c, slot_of[i:i + 128],
        lengths[i:i + 128], thr, k, keep, plan, 0, E, miss, layout=narrow)
        for i in range(0, B, 128)])
    got = T.finalize_postings_wire(
        packed.to(card), rows.to(card), acc_c.to(card), slot_of.to(card),
        lengths.to(card), thr, k, keep, plan.to(card), 0, E, miss,
        layout=narrow)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    K, wide, _ = T.wire_format(E, keep)
    from rappas_tpu_torch.place.engine import unpack_wire
    res = unpack_wire(want.numpy(), K, wide)
    assert (res.n_matched > 0).all() and (res.top_edges >= 0).all()
