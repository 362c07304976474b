"""The 4,000-taxon k=10 deployment (``portbench/configs/c5-4000taxa-k10.json``)
at sizes a CPU holds: f32 tables built on the device (bitwise the host's
``compact_matrix`` / ``dense_matrix``), ``resolve_table`` on the
deployment's shape, ``place_queries`` through ``cli._make_engine`` against
``portbench/reference.py`` on the compact layout and, past a compact line
patched under the table, on the postings layout at the DB's own width,
P3's plan at width 45, and the table's span and the C1 row counter.

The card tests (``-m cuda``, skip without a card) run C1 and K3 at the
deployment's own widths, E = 8,000 on a 33.55 GB table, past 2^31
elements, and P3 on the postings layout ``table="auto"`` takes for it
(45 postings a key, the block path in shared memory), against their
plain versions:

    RAPPAS_TPU_DEVICE_TESTS=1 python -m pytest -m cuda \\
        tests/test_torch_large_tree.py
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import cell
from rappas_tpu_torch import convert, utils
from rappas_tpu_torch.alphabet import DNA
from rappas_tpu_torch.db import LIGHT_PAD_EDGE
from rappas_tpu_torch.parallel.engine import ShardedEngine
from rappas_tpu_torch.parallel.mesh import make_mesh
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import PlacementEngine, light_width

CELL = "c5-4000taxa-k10.miseq240"
#: the deployment's recipe at k=6 and 2,000 slots: heavy-dominated (45
#: postings a key), every 6-mer a key
SMALL = {"k": 6, "n_edge_slots": 2000}
#: the mix cut to a CPU's size (portbench/tests/tiny.py's sizes)
MIX = {"reads_per_sample": 200, "pool": 3, "check_calls": 2}


def _spec():
    s = cell.load_spec(CELL)
    s["config"].update(SMALL)
    s["mix"].update(MIX)
    return s


def _db(config, seed):
    recipe = cell.load_module(cell.HERE / "recipes" /
                              f"{config['recipe']}.py", "recipe")
    return cell.program_db(config, recipe.make(config, seed))


@pytest.fixture(scope="module")
def small_db():
    return _db(_spec()["config"], 21)


def _bits(a) -> bytes:
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a).view(np.uint32).tobytes()


def _counted_steps(monkeypatch) -> list:
    """One entry per scatter step of the f32 table build from now on."""
    steps = []
    scatter = torch.Tensor.index_put_

    def counted(self, *args, **kwargs):
        steps.append(1)
        return scatter(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "index_put_", counted)
    return steps


@pytest.mark.parametrize("budget", [1, 1024, 1 << 14, 1 << 20])
@pytest.mark.parametrize("table", ["compact", "direct"])
def test_device_built_f32_table_is_the_host_table(small_db, table, budget,
                                                  monkeypatch):
    # steps of one key (a step smaller than a key's postings), of about 22
    # keys, of about 360 keys, and of the whole DB
    monkeypatch.setattr(convert, "TABLE_STEP_POSTINGS", budget)
    steps = _counted_steps(monkeypatch)
    lens = np.diff(small_db.offsets)
    assert int(lens[lens > 8].sum()) * 2 > small_db.nnz   # heavy-dominated
    tabs = convert.device_tables(small_db, "cpu", table)
    want = (small_db.compact_matrix(pad_rows=1) if table == "compact"
            else small_db.dense_matrix(pad_rows=1))
    assert tabs.D.dtype == torch.float32
    assert tuple(tabs.D.shape) == want.shape
    assert _bits(tabs.D) == _bits(want)
    assert not tabs.D[-1].any()                           # the miss row
    if budget == 1:
        assert len(steps) == small_db.n_kmers
    if budget >= small_db.nnz:
        assert len(steps) == 1
    if table == "compact":
        assert tabs.keys.dtype == torch.int32
        assert np.array_equal(tabs.keys.numpy(), small_db.keys)
    else:
        assert tabs.keys is None


@pytest.mark.parametrize("table", ["compact", "direct"])
def test_f32_table_steps_by_a_fixed_posting_budget(small_db, table,
                                                   monkeypatch):
    """At the default budget the build takes at most ``ceil(nnz /
    TABLE_STEP_POSTINGS)`` steps plus one for each key wider than a step:
    a budget of postings, not a share of the table."""
    steps = _counted_steps(monkeypatch)
    convert.f32_table(small_db, "cpu", table)
    budget = convert.TABLE_STEP_POSTINGS
    wide = int((np.diff(small_db.offsets) > budget).sum())
    assert 1 < len(steps) <= -(-small_db.nnz // budget) + wide


def test_device_built_table_of_an_empty_db(small_db):
    empty = SimpleNamespace(
        k=small_db.k, alphabet=DNA, n_kmers=0, n_edge_slots=7,
        keys=np.zeros(0, np.int64), offsets=np.zeros(1, np.int64),
        edges=np.zeros(0, np.int32), deltas=np.zeros(0, np.float32))
    D = convert.f32_table(empty, "cpu", "compact")
    assert tuple(D.shape) == (1, 7) and not D.any()


def _deployment(n_per_key=45, E=8000, k=10):
    """A DB of the deployment's shape (every 10-mer a key, ``n_per_key``
    postings each, ``E`` slots), as far as ``resolve_table`` reads it."""
    n = 4 ** k
    return SimpleNamespace(
        k=k, alphabet=DNA, n_kmers=n, n_edge_slots=E, nnz=n * n_per_key,
        offsets=np.arange(n + 1, dtype=np.int64) * n_per_key)


def test_resolve_table_takes_postings_for_the_deployment(monkeypatch):
    """Past the compact line the deployment takes postings at its own
    light width, 45, with no heavy keys: 0.29 GB (light rows of 23 words
    of u16 edge ids and 45 of deltas) against the compact table's 33.55
    GB."""
    db = _deployment()
    assert (db.n_kmers + 1) * db.n_edge_slots * 4 == 33_554_464_000
    budget = PlacementEngine.DIRECT_BYTE_LIMIT
    assert 33_554_464_000 > PlacementEngine.AUTO_COMPACT_BYTES
    assert light_width(np.diff(db.offsets), db.n_edge_slots) == \
        (45, (4 ** 10 + 1) * 4 * (23 + 45) + 4 * 8000) == (45, 285_244_944)
    assert PlacementEngine.resolve_layout(db, "auto", "f32", budget) == \
        ("postings", 45)
    # past the card's budget: postings at the same width
    assert PlacementEngine.resolve_layout(
        db, "auto", "f32", 33_554_464_000 - 1) == ("postings", 45)
    # light-dominated at the same size: postings at the default width
    assert PlacementEngine.resolve_layout(
        _deployment(n_per_key=8), "auto", "f32", budget) == ("postings", 8)
    # an asked-for layout keeps the width it is given
    assert PlacementEngine.resolve_layout(db, "postings", "f32", budget) \
        == ("postings", 8)
    # u16 never takes postings
    assert PlacementEngine.resolve_table(db, "auto", "u16", budget) == \
        "compact"
    # a share under the deployment's 0.85% keeps compact
    monkeypatch.setattr(PlacementEngine, "AUTO_POSTINGS_SHARE", 0.0084)
    assert PlacementEngine.resolve_table(db, "auto", "f32", budget) == \
        "compact"


def test_place_queries_agrees_with_the_reference(tmp_path):
    s = _spec()
    c1 = cell.load_spec("c1-16s-k8.miseq240")["limits"]
    run = cell.run(s, 2 ** 31 + 2103, 0.5, False, tmp_path, time.time(),
                   device="cpu")
    assert run["table"] == "compact"
    assert run["failure"] is None
    correct, rows = cell.verdict(run["numbers"], c1, run["failure"])
    assert correct, rows
    assert run["numbers"]["calls_checked"] >= 1
    assert run["numbers"]["placements"] > 0


def _same_placements(a, b):
    """``|L|`` and each read's edge set identical, scores within 2e-4 and
    LWR within 1e-4 (``tests/test_engine.py``'s gate)."""
    np.testing.assert_array_equal(a.n_matched, b.n_matched)
    for i in range(a.n_matched.shape[0]):
        va, vb = a.top_edges[i] >= 0, b.top_edges[i] >= 0
        assert sorted(a.top_edges[i][va]) == sorted(b.top_edges[i][vb]), i
        for x, y, tol in ((a.top_scores, b.top_scores, 2e-4),
                          (a.top_lwr, b.top_lwr, 1e-4)):
            np.testing.assert_allclose(sorted(x[i][va]), sorted(y[i][vb]),
                                       rtol=0, atol=tol)


def test_place_queries_takes_postings_past_the_line(tmp_path, monkeypatch,
                                                    reset_trace):
    """The deployment's recipe at the CPU size, its table past a compact
    line patched under it: ``auto`` takes postings at the DB's own width
    (45, no heavy keys) through ``cli._make_engine``, the cell is correct
    against the reference within c1's limits, and the engine places as a
    compact engine on the same DB, and as a mesh engine, which takes the
    same width."""
    s = _spec()
    E, n = SMALL["n_edge_slots"], 4 ** SMALL["k"]
    monkeypatch.setattr(PlacementEngine, "AUTO_COMPACT_BYTES",
                        (n + 1) * E * 4 - 1)
    engines = []
    run = cell.run(s, 2 ** 31 + 2203, 0.5, False, tmp_path, time.time(),
                   device="cpu",
                   engine_wrap=lambda e: engines.append(e) or e)
    assert run["table"] == "postings"
    eng = engines[0]
    assert eng.postings_width == 45 and eng.heavy_dense.shape[0] == 1
    tot = utils.trace_totals()["counters"]
    assert tot["engine.postings_width"] == 45
    assert tot["engine.edge_id_bytes"] == 2
    lens = np.diff(eng.db.offsets)
    assert tot["engine.table_bytes"] == light_width(lens, E)[1] == \
        (n + 1) * 4 * (23 + 45) + 4 * E
    assert run["failure"] is None
    c1 = cell.load_spec("c1-16s-k8.miseq240")["limits"]
    correct, rows = cell.verdict(run["numbers"], c1, run["failure"])
    assert correct, rows
    assert run["numbers"]["calls_checked"] >= 1
    m, lens = _reads(np.random.default_rng(11), 48)
    compact = PlacementEngine(eng.db, device="cpu", table="compact")
    got, want = eng.score(m, lens), compact.score(m, lens)
    assert (got.n_matched > 0).all()
    _same_placements(got, want)
    # a mesh takes the same layout and width: two edge-range shards
    sharded = ShardedEngine(eng.db, make_mesh(["cpu"] * 2, dp=1, mp=2))
    assert (sharded.table, sharded.postings_width) == ("postings", 45)
    _same_placements(sharded.score(m, lens), got)


def _reads(rng, B, L=240):
    m = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    m[0, 17] = ord("N")                   # a window with an ambiguity
    lens = np.full(B, L, np.int32)
    lens[1] = 100
    m[1, 100:] = 0xFF
    return m.astype(np.uint8), lens


def _distinct_rows(db, m, lens):
    """The distinct compact rows of the reads' clean windows, by hand."""
    k, rows = db.k, set()
    for read, n in zip(m, lens):
        s = bytes(read[:n])
        for q in range(n - k + 1):
            w = s[q:q + k]
            if b"N" in w:
                continue
            idx = 0
            for c in w:
                idx = idx * 4 + b"ACGT".index(c)
            pos = int(np.searchsorted(db.keys, idx))
            if pos < db.n_kmers and db.keys[pos] == idx:
                rows.add(pos)
    return len(rows)


@pytest.fixture
def reset_trace():
    utils.tracing(False)
    utils.trace_reset()
    yield
    utils.tracing(False)
    utils.trace_reset()


def test_table_span_and_c1_rows_only_while_tracing(small_db, reset_trace):
    rng = np.random.default_rng(5)
    m, lens = _reads(rng, 40)
    E = small_db.n_edge_slots
    table_bytes = (small_db.n_kmers + 1) * E * 4
    # off: the table's bytes (a counter of no cost) and nothing else
    eng = PlacementEngine(small_db, device="cpu")
    off = eng.score(m, lens)
    tot = utils.trace_totals()
    assert "engine.table" not in tot["spans"]
    assert "engine.c1_row_bytes" not in tot["counters"]
    assert tot["counters"]["engine.table_bytes"] == table_bytes
    # on: the span and the rows C1 reads, each batch's distinct rows
    utils.trace_reset()
    utils.tracing(True)
    eng = PlacementEngine(small_db, device="cpu")
    assert eng.table == "compact"
    on = eng.score(m, lens)
    eng.score(m[:20], lens[:20])
    tot = utils.trace_totals()
    assert tot["spans"]["engine.table"]["count"] == 1
    assert tot["counters"]["engine.table_bytes"] == table_bytes
    want = (_distinct_rows(small_db, m, lens) +
            _distinct_rows(small_db, m[:20], lens[:20])) * E * 4
    assert tot["counters"]["engine.c1_row_bytes"] == want
    # counting changes nothing placed
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_c1_hands_back_its_rows(small_db):
    tabs = convert.device_tables(small_db, "cpu", "compact")
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, (6, 50)).astype(np.int8)
    codes[2, 7] = -1
    c = torch.from_numpy(codes)
    rows = torch.full((6, 50 - small_db.k + 1), -5, dtype=torch.int32)
    acc = T.accumulate_compact(tabs.D, tabs.keys, c, small_db.k, 4,
                               rows=rows)
    want = T.compact_rows(tabs.keys, T.kmer_indices64(c, small_db.k, 4))
    assert torch.equal(rows, want)
    assert torch.equal(acc, T.accumulate(tabs.D, want))


def _p3_c5_inputs(rng, B, L=240, W=45, E=8000, n_rows=1 << 14):
    """P3's inputs at the deployment's widths: a light table of rows of
    ``W`` real postings (distinct edges, quarter deltas: every sum exact in
    f32), the all-pad miss row last; ``B`` reads of ``L`` bases whose every
    window hits a row; no heavy rows and no ambiguity windows, so no
    read has a dense slot."""
    start = rng.integers(0, E - 1, (n_rows, 1))
    stride = rng.integers(1, (E - 1) // W, (n_rows, 1))
    edges = 1 + (start + np.arange(W) * stride) % (E - 1)
    deltas = (rng.integers(1, 12, (n_rows, W)) * 0.25).astype(np.float32)
    pairs = np.concatenate([
        np.concatenate([edges.astype(np.int32), deltas.view(np.int32)], 1),
        np.concatenate([np.full((1, W), LIGHT_PAD_EDGE, np.int32),
                        np.zeros((1, W), np.int32)], 1)])
    lrows = rng.integers(0, n_rows, (B, L - 10 + 1)).astype(np.int32)
    return pairs, lrows, n_rows


def test_postings_plan_at_the_deployment_widths():
    """P3's plan at width 45: a 240 bp read's 231 x 45 postings sort in
    one block's shared memory (no scratch); a 1,024-read batch of 1,450 bp
    reads (1,441 x 45 = 64,845 postings, a region of as many slots each)
    sorts in a global scratch of 12 bytes a slot, 0.80 GB, far under the
    33.55 GB compact table the layout replaces."""
    pairs, lrows, _ = _p3_c5_inputs(np.random.default_rng(3), 16)
    counts = (pairs[lrows, :45] != LIGHT_PAD_EDGE).sum(axis=(1, 2))
    assert (counts == 231 * 45).all()
    plan = T.postings_plan(counts)
    assert plan.paths(16) == {"warp": 0, "block": 16, "scratch": 0}
    assert plan.smem_pairs == 16384 == T.SMEM_PAIRS and plan.n_scratch == 0
    long = T.postings_plan(np.full(1024, (1450 - 10 + 1) * 45))
    assert long.paths(1024) == {"warp": 0, "block": 0, "scratch": 1024}
    assert long.n_scratch == 1024 * 64845
    # the scratch P3's wrapper allocates: an int64 key and an f32 total
    assert long.n_scratch * (8 + 4) == 796_815_360


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_c1_and_k3_at_the_deployment_widths_on_card(card):
    """E = 8,000 on the deployment's 33.55 GB compact table (8.4e9
    elements): the device-built table against the CSR on sampled rows
    (the last ones past 2^31 elements), C1 within 1e-5 of its plain
    version (summation order), its rows and K3's wire (keep 7 and the
    scanning rounds of keep 20) bitwise."""
    config = dict(cell.load_spec(CELL)["config"], postings_per_key=5)
    db = _db(config, 2 ** 31 + 7)
    E, n, k = db.n_edge_slots, db.n_kmers, db.k
    tabs = convert.device_tables(db, card, "compact")
    D = tabs.D
    assert D.numel() > 2 ** 31 and tuple(D.shape) == (n + 1, E)
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.choice(n, 512, replace=False),
                           np.arange(n - 8, n + 1)])
    got = D[torch.from_numpy(rows).to(card)].cpu().numpy()
    want = np.zeros((rows.size, E), np.float32)
    for i, r in enumerate(rows[:-1]):
        lo, hi = db.offsets[r], db.offsets[r + 1]
        want[i, db.edges[lo:hi]] = db.deltas[lo:hi]
    assert _bits(got) == _bits(want)

    B, L = 64, 240
    codes = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(np.int8))
    codes[3, 11] = -1
    c = codes.to(card)
    resolved = torch.empty((B, L - k + 1), dtype=torch.int32, device=card)
    acc = T.accumulate_compact(D, tabs.keys, c, k, 4, rows=resolved)
    plain_rows = T.compact_rows(tabs.keys, T.kmer_indices64(c, k, 4))
    assert torch.equal(resolved, plain_rows)
    assert int(plain_rows[plain_rows < n].max()) * E > 2 ** 31
    assert torch.allclose(acc, T.accumulate(D, plain_rows), rtol=1e-5,
                          atol=1e-5)
    lens = torch.full((B,), L, dtype=torch.int32, device=card)
    thr = float(db.thr_log10)
    thr_t = torch.tensor(thr, dtype=torch.float32, device=card)
    for keep in (7, 20):
        wire = T.finalize_wire(acc, lens, thr, k, keep)
        ref = T.pack_wire(*T.finalize(acc, lens, thr_t, k, keep))
        assert torch.equal(wire, ref), keep


@pytest.mark.cuda
def test_p3_at_the_deployment_widths_on_card(card):
    """P3 on a 1,024-read batch at the deployment's widths (231 windows x
    45 postings a read, E = 8,000): every read on the block path in shared
    memory, the wire bitwise the plain version's (quarter deltas: every
    sum exact), on the light rows the deployment takes (u16 edge ids, 68
    words) and on rows of int32 ids (90 words) alike."""
    from rappas_tpu_torch.place.engine import unpack_wire
    rng = np.random.default_rng(45)
    pairs, lrows, miss = _p3_c5_inputs(rng, 1024)
    B, E, k, keep, thr = 1024, 8000, 10, 7, -4.25
    counts = (pairs[lrows, :45] != LIGHT_PAD_EDGE).sum(axis=(1, 2))
    plan = T.postings_plan(counts)
    assert plan.paths(B) == {"warp": 0, "block": B, "scratch": 0}
    acc_c = np.zeros((0, E), np.float32)
    slot_of = np.full(B, -1, np.int32)
    lens = np.full(B, 240, np.int32)
    cpu = [torch.from_numpy(a) for a in (pairs, lrows, acc_c, slot_of, lens)]
    wide = T.LightLayout(45, False)
    want = T.finalize_postings_wire(*cpu, thr, k, keep, plan, 0, E, miss,
                                    layout=wide)
    narrow = T.LightLayout.of(45, E)
    assert narrow.narrow and narrow.words == 68
    packed = narrow.pack(pairs[:, :45], pairs[:, 45:].view(np.float32))
    for lay, table in ((narrow, packed), (wide, pairs)):
        dev = [torch.from_numpy(table).to(card)] + [t.to(card)
                                                    for t in cpu[1:]]
        got = T.finalize_postings_wire(*dev, thr, k, keep, plan.to(card), 0,
                                       E, miss, layout=lay)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), lay
    assert torch.equal(T.finalize_postings_wire(
        torch.from_numpy(packed), *cpu[1:], thr, k, keep, plan, 0, E, miss,
        layout=narrow), want)
    K, wide, _ = T.wire_format(E, keep)
    res = unpack_wire(want.numpy(), K, wide)
    assert (res.n_matched > 0).all() and (res.top_edges >= 0).all()
