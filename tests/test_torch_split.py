"""The port's height-split tables (``device="cpu"``: the kernels' plain
versions) against the JAX engine under the same constants and against the
serial oracle, mirroring ``tests/test_postings.py:296-490`` and
``tests/test_engine.py:246-277``: the split light table of the postings
layout (routed, N-way, two-stage, select fallback, a single slow table,
the unique-overflow halving, the software pipeline) and the split direct
table in f32 and u16; then each plain version against its JAX function.

Tolerances as ``tests/test_engine.py:41-60``: ``|L|`` and edge sets
identical, scores within 2e-4, LWR within 1e-4.  Bitwise where
``tests/test_postings.py`` is bitwise (two-stage, select, pipeline and
halving against the one-table engine); the tables carried to the device
bitwise equal to JAX's parts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rappas_tpu.place import engine as J
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu_torch import convert
from rappas_tpu_torch.db import LightLayout
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place import engine as port_engine
from rappas_tpu_torch.place.engine import (PlacementEngine, SplitPending,
                                           route_rows, window_offsets)
from test_engine import batch_of, compare, synthetic_db
from test_torch_engine import port_db, same_as_jax
from test_torch_kernels import _dense_sources, _pairs, _same_top, _table
from test_torch_postings import random_reads, skewed_db, with_db_kmers


@pytest.fixture(scope="module")
def db():
    return skewed_db()


@pytest.fixture(scope="module")
def tdb(db):
    return port_db(db)


@pytest.fixture(scope="module")
def ddb():
    return synthetic_db()


def _pairs_bytes(db):
    return (db.postings_tables(8).light_keys.shape[0] + 1) * 64


#: the port's budgets for the jobs JAX's one ``LIGHT_SPLIT_BYTES`` does
#: on these paths: the light part size, the two-stage table's cap, the
#: direct part size
PORT_SPLIT = ("LIGHT_PART_BYTES", "TWO_STAGE_MAX_BYTES", "DIRECT_PART_BYTES")
#: the budgets that weigh light rows, and the port's light row at width 8
#: over JAX's (u16 edge ids in the port: the postings DBs here have fewer
#: than 65,535 edge slots)
LIGHT_BUDGETS = ("LIGHT_PART_BYTES", "TWO_STAGE_MAX_BYTES")
ROW_WORDS = (LightLayout(8, True).words, 16)


def _patch(monkeypatch, **consts):
    """The same engine constants on both packages' engines; JAX's
    ``LIGHT_SPLIT_BYTES`` is set on the port as each budget of
    :data:`PORT_SPLIT`, a light-row budget in the port's own bytes
    (:data:`ROW_WORDS`), so that both take the same path."""
    for name, value in consts.items():
        monkeypatch.setattr(JaxEngine, name, value)
        for port in PORT_SPLIT if name == "LIGHT_SPLIT_BYTES" else (name,):
            monkeypatch.setattr(
                PlacementEngine, port, value * ROW_WORDS[0] // ROW_WORDS[1]
                if port in LIGHT_BUDGETS else value)


def _split(monkeypatch, db, div, **consts):
    _patch(monkeypatch, LIGHT_SPLIT_BYTES=_pairs_bytes(db) // div + 64,
           **consts)


def _engines(db, tdb, **kw):
    return (PlacementEngine(tdb, table="postings", device="cpu", **kw),
            JaxEngine(db, table="postings", **kw))


def _bitwise(a, b):
    assert np.array_equal(a.top_edges, b.top_edges)
    assert np.array_equal(a.top_scores.view(np.uint32),
                          b.top_scores.view(np.uint32))
    assert np.array_equal(a.n_matched, b.n_matched)


def _source(engine, reads):
    """The light row source the engine picks for a batch of ``reads``."""
    mat, lens = batch_of(reads)
    host, _ = engine.postings_inputs(engine.encode_batch(mat), mat, lens)
    return engine._light_source(host)


# ---- the layouts ------------------------------------------------------- #

@pytest.mark.parametrize("div", [2, 4, 5, 0])
def test_light_parts_match_jax(db, tdb, monkeypatch, div):
    """The light table's parts are bitwise JAX's packed in the port's
    light rows (u16 edge ids), and so are the slow and routed flags
    (``div`` 0: a budget of 0 bytes, too many parts to cut, one slow
    table)."""
    if div:
        _split(monkeypatch, db, div)
    else:
        _patch(monkeypatch, LIGHT_SPLIT_BYTES=0)
    t, j = _engines(db, tdb)
    assert len(t.light_parts) == len(j.light_parts) == (div or 1)
    assert t.light_layout == LightLayout(8, True)
    for a, b in zip(t.light_parts, j.light_parts):
        b = np.asarray(b)
        assert np.array_equal(a.numpy(), t.light_layout.pack(
            b[:, :8], b[:, 8:].view(np.float32)))
    assert t._light_slow == j._light_slow == (div == 0)
    assert t._routed_windows == j._routed_windows == (div > 1)
    assert (t.pairs is None) == (div > 1)
    meta = t._light.meta.numpy()
    assert meta[1].tolist() == [p.shape[0] for p in j.light_parts]
    assert meta[2].tolist() == np.cumsum(
        [0] + [p.shape[0] for p in j.light_parts[:-1]]).tolist()


@pytest.mark.parametrize("precision", ["f32", "u16"])
def test_direct_parts_match_jax(ddb, monkeypatch, precision):
    """The split direct table's parts (body slices plus a zero row, the
    global miss row dropped) are bitwise JAX's; the whole table is gone."""
    dense = (ddb.dense_matrix_u16(pad_rows=1)[0] if precision == "u16"
             else ddb.dense_matrix(pad_rows=1))
    _patch(monkeypatch, DIRECT_SPLIT_MIN=1024,
           LIGHT_SPLIT_BYTES=dense.nbytes // 4 + 64)
    t = PlacementEngine(port_db(ddb), table="direct", precision=precision,
                        device="cpu")
    j = JaxEngine(ddb, table="direct", precision=precision)
    assert t.D is None and j.D is None
    assert len(t.direct_parts) == len(j.direct_parts) == 4
    for a, b in zip(t.direct_parts, j.direct_parts):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert not a.numpy()[-1].any()
    assert np.array_equal(t._direct_cuts, j._direct_cuts)
    assert t.n_rows == j.n_rows and t.scale == float(j.scale)
    parts, cuts = convert.direct_parts(dense, dense.nbytes // 4 + 64, 1024,
                                       64)
    assert np.array_equal(cuts, j._direct_cuts)
    assert convert.direct_parts(dense, dense.nbytes // 4 + 64,
                                dense.nbytes, 64) is None


def test_sharded_engine_never_splits(db, monkeypatch):
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.parallel.mesh import make_mesh
    _split(monkeypatch, db, 4, DIRECT_SPLIT_MIN=0)
    eng = ShardedEngine(port_db(db), make_mesh(["cpu"] * 2, dp=1, mp=2),
                        table="direct")
    assert eng.direct_parts is None and not eng._routed_windows
    with pytest.raises(ValueError, match="single-device"):
        eng.enable_pipeline()


# ---- the postings layout on a split light table ------------------------ #

def test_split_light_table(db, tdb, monkeypatch):
    """2 parts (routed by default): the oracle's placements and JAX's."""
    _split(monkeypatch, db, 2)
    t, j = _engines(db, tdb)
    assert len(t.light_parts) == 2
    reads = with_db_kmers(db, random_reads(10, 30, seed=23), n=3)
    assert _source(t, reads) == ("routed",)
    compare(db, t, reads)
    mat, lens = batch_of(reads)
    same_as_jax(t.score(mat, lens), j.score(mat, lens))


def test_nway_split_light_table(db, tdb, monkeypatch):
    """4+ parts, with ambiguity alternatives over every part (A1)."""
    _split(monkeypatch, db, 4)
    t, j = _engines(db, tdb)
    assert len(t.light_parts) >= 4
    reads = with_db_kmers(db, random_reads(10, 30, seed=41), n=6)
    compare(db, t, reads)
    amb = [r[:8] + "N" + r[9:] for r in random_reads(6, 30, seed=43)]
    compare(db, t, amb)
    mat, lens = batch_of(reads + amb)
    same_as_jax(t.score(mat, lens), j.score(mat, lens))


def test_nway_split_two_stage_bitwise(db, tdb, monkeypatch):
    """5 parts, two-stage: bitwise the one-table engine's scores."""
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    _split(monkeypatch, db, 5)
    t, j = _engines(db, tdb)
    t.enable_routed_windows(False)
    j.enable_routed_windows(False)
    assert len(t.light_parts) >= 5
    # few distinct reads: the batch's unique rows fit the compact budget
    reads = with_db_kmers(db, random_reads(4, 40, seed=47), n=4) * 2
    assert _source(t, reads)[0] == "compact"
    mat, lens = batch_of(reads)
    r = t.score(mat.copy(), lens.copy())
    _bitwise(ref.score(mat.copy(), lens.copy()), r)
    same_as_jax(r, j.score(mat, lens))


def test_split_select_fallback(db, tdb, monkeypatch):
    """No two-stage budget and no batch to halve: the select over both
    parts at global rows (R1 parts) -- bitwise the one-table engine."""
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    _split(monkeypatch, db, 2, TWO_STAGE_MAX_UNIQUE=0, MIN_SPLIT_B=1 << 20)
    t, j = _engines(db, tdb)
    t.enable_routed_windows(False)
    j.enable_routed_windows(False)
    reads = with_db_kmers(db, random_reads(10, 30, seed=31), n=3)
    assert _source(t, reads) == ("parts",)
    compare(db, t, reads)
    mat, lens = batch_of(reads)
    r = t.score(mat, lens)
    _bitwise(ref.score(mat, lens), r)
    same_as_jax(r, j.score(mat, lens))


def test_two_stage_unique_slow_table(db, tdb, monkeypatch):
    """A single table past the budget that cannot be cut (``_light_slow``:
    here the part cap is 1) takes the two-stage gather when the batch
    repeats its rows: bitwise the fast one-table engine."""
    _patch(monkeypatch, LIGHT_SPLIT_BYTES=1 << 62)
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    assert not ref._light_slow
    _split(monkeypatch, db, 2, MAX_LIGHT_PARTS=1)
    t, j = _engines(db, tdb)
    assert t._light_slow and len(t.light_parts) == 1
    reads = with_db_kmers(db, random_reads(8, 40, seed=29), n=4) * 3
    src = _source(t, reads)
    assert src[0] == "compact" and src[1] >= 0   # the miss row is unique
    mat, lens = batch_of(reads)
    r = t.score(mat.copy(), lens.copy())
    _bitwise(ref.score(mat.copy(), lens.copy()), r)
    compare(db, t, reads[:12])
    same_as_jax(r, j.score(mat, lens))


def test_pipeline_multibatch_bitwise(db, tdb, monkeypatch):
    """The software pipeline across 3 in-flight batches: each batch's P3
    is issued when the next one arrives, the tail by its ``result()``;
    bitwise the two-stage engine's per-batch scores."""
    _split(monkeypatch, db, 3)
    pipe = PlacementEngine(tdb, table="postings", device="cpu")
    pipe.enable_pipeline()
    assert not pipe._routed_windows
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    ref.enable_routed_windows(False)
    batches = []
    for seed in (5, 6, 7):
        reads = random_reads(8, 40, seed=seed) + [
            db.alphabet.kmer_to_string(int(k), db.k) * 5
            for k in db.keys[seed:seed + 3]]
        batches.append(batch_of(reads * 2))
    pend = [pipe.score_async(m.copy(), ln.copy()) for m, ln in batches]
    assert pipe._pp_tail is pend[-1]._entry        # the tail waits
    assert [p._entry["out"] is None for p in pend] == [False, False, True]
    for (m, ln), p in zip(batches, pend):
        _bitwise(ref.score(m.copy(), ln.copy()), p.result())
    assert pipe._pp_tail is None                   # flushed
    pipe.enable_pipeline(False)
    assert pipe._routed_windows


def test_unique_overflow_batch_split(db, tdb, monkeypatch):
    """Too many batch-unique rows for the compact table: the batch is
    halved (SplitPending) down to MIN_SPLIT_B, then selected; bitwise the
    one-table engine, and JAX's placements under the same constants."""
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    _split(monkeypatch, db, 3, TWO_STAGE_MAX_UNIQUE=6, MIN_SPLIT_B=2)
    t, j = _engines(db, tdb)
    t.enable_routed_windows(False)
    j.enable_routed_windows(False)
    assert len(t.light_parts) >= 2
    reads = with_db_kmers(db, random_reads(12, 40, seed=51), n=4)
    mat, lens = batch_of(reads)
    pend = t.score_async(mat.copy(), lens.copy())
    assert isinstance(pend, SplitPending)
    r = pend.result()
    _bitwise(ref.score(mat.copy(), lens.copy()), r)
    jp = j.score_async(mat.copy(), lens.copy())
    assert isinstance(jp, J.SplitPending)
    same_as_jax(r, jp.result())


def test_routed_windows(db, tdb, monkeypatch):
    """Part-routed windows: edge order, ``|L|`` equal to the one-table
    engine, scores within 2e-4 (another order of each read's postings);
    the oracle's placements, ambiguity reads included, and JAX's."""
    ref = PlacementEngine(tdb, table="postings", device="cpu")
    _split(monkeypatch, db, 4)
    t, j = _engines(db, tdb)
    assert len(t.light_parts) >= 4 and t._routed_windows
    reads = with_db_kmers(db, random_reads(16, 40, seed=53), n=4)
    mat, lens = batch_of(reads)
    r1, r2 = ref.score(mat.copy(), lens.copy()), t.score(mat.copy(),
                                                         lens.copy())
    assert np.array_equal(r1.top_edges, r2.top_edges)
    assert np.array_equal(r1.n_matched, r2.n_matched)
    np.testing.assert_allclose(r2.top_scores, r1.top_scores, rtol=0,
                               atol=2e-4)
    same_as_jax(r2, j.score(mat, lens))
    amb = [r[:8] + "N" + r[9:] for r in random_reads(4, 30, seed=54)]
    compare(db, t, random_reads(8, 30, seed=55) + amb)


@pytest.mark.parametrize("with_max, char", [(False, "N"), (True, "R")])
def test_ambiguity_over_parts(db, tdb, monkeypatch, with_max, char):
    """Ambiguity alternatives on a split light table (A1's plain version,
    ``alt_delta_rows_postings`` over the parts), mean and max modes."""
    _split(monkeypatch, db, 4)
    t, j = _engines(db, tdb, ambiguities_with_max=with_max)
    base = db.alphabet.kmer_to_string(int(db.keys[0]), db.k) * 5
    reads = [r[:10] + char + r[11:] for r in random_reads(8, 30, seed=3)]
    reads += [base[:12] + char + base[13:], base, char * 20]
    compare(db, t, reads, ambiguities_with_max=with_max)
    mat, lens = batch_of(reads)
    same_as_jax(t.score(mat, lens), j.score(mat, lens))


def test_split_engine_errors(db, tdb, ddb):
    t = PlacementEngine(tdb, table="postings", device="cpu")
    d = PlacementEngine(port_db(ddb), table="direct", device="cpu")
    with pytest.raises(ValueError, match="postings"):
        d.enable_routed_windows()
    with pytest.raises(ValueError, match="single-device"):
        d.enable_pipeline()
    d.enable_routed_windows(False)
    with pytest.raises(ValueError, match="split"):
        convert.postings_device_tables(
            tdb, 8, "cpu", part_bytes=_pairs_bytes(db) // 2 + 64).pairs
    t.enable_pipeline()
    assert t._pp_enabled and not t._routed_windows


# ---- the split direct table -------------------------------------------- #

@pytest.mark.parametrize("precision", ["f32", "u16"])
def test_direct_split_matches_unsplit(ddb, monkeypatch, precision):
    """``tests/test_engine.py:246-277`` through the port, in f32 and u16:
    edge order and ``|L|`` equal to the unsplit engine, scores within
    2e-4 (part-major sums); the oracle's placements (f32) with ambiguity
    reads (A1's plain version); JAX's split engine's placements."""
    tdb = port_db(ddb)
    ref = PlacementEngine(tdb, table="direct", precision=precision,
                          device="cpu")
    dense = (ddb.dense_matrix_u16(pad_rows=1)[0] if precision == "u16"
             else ddb.dense_matrix(pad_rows=1))
    _patch(monkeypatch, DIRECT_SPLIT_MIN=1024,
           LIGHT_SPLIT_BYTES=dense.nbytes // 4 + 64)
    t = PlacementEngine(tdb, table="direct", precision=precision,
                        device="cpu")
    j = JaxEngine(ddb, table="direct", precision=precision)
    assert t.direct_parts is not None and len(t.direct_parts) >= 4
    rng = np.random.default_rng(61)
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(24)]
    reads += [ddb.alphabet.kmer_to_string(int(k), ddb.k) * 6
              for k in ddb.keys[:4]]
    mat, lens = batch_of(reads)
    r1, r2 = ref.score(mat.copy(), lens.copy()), t.score(mat.copy(),
                                                         lens.copy())
    assert np.array_equal(r1.top_edges, r2.top_edges)
    assert np.array_equal(r1.n_matched, r2.n_matched)
    np.testing.assert_allclose(r2.top_scores, r1.top_scores, rtol=0,
                               atol=2e-4)
    amb = ["".join(rng.choice(list("ACGT"), 30)) for _ in range(4)]
    amb = [r[:7] + "N" + r[8:] for r in amb]
    mixed = ["".join(rng.choice(list("ACGT"), 30)) for _ in range(8)] + amb
    if precision == "f32":
        compare(ddb, t, mixed)
    mat, lens = batch_of(reads + mixed)
    same_as_jax(t.score(mat, lens), j.score(mat, lens))


# ---- the plain versions against the JAX functions ---------------------- #

def _split_pairs(rng, n_parts, nl=90, P=8, E=50):
    pairs = _pairs(rng, nl, P, E)
    parts, slow = convert.light_parts(pairs, pairs.nbytes // n_parts + 1, 32)
    assert len(parts) == n_parts and not slow
    return pairs, parts


def test_light_gather_and_routing_match_jax():
    """Multi-part ``light_gather``, ``routed_light_gather`` over the
    routed rows of ``route_rows``, and ``_bucket_size``: bitwise."""
    rng = np.random.default_rng(70)
    pairs, parts = _split_pairs(rng, 3)
    nl = pairs.shape[0] - 1
    lrows = rng.integers(0, nl + 1, (12, 17)).astype(np.int32)
    lrows[0] = nl
    jp = tuple(jnp.asarray(p) for p in parts)
    tp = tuple(torch.from_numpy(p) for p in parts)
    want = np.asarray(J.light_gather(jp, jnp.asarray(lrows)))
    assert np.array_equal(T.light_gather(tp, torch.from_numpy(lrows))
                          .numpy(), want)
    assert np.array_equal(want, pairs[lrows])
    cuts = np.concatenate([[0], np.cumsum([p.shape[0] for p in parts])])
    routed = route_rows(lrows, cuts, drop=nl)
    j_routed = JaxEngine._route_rows(lrows, cuts, drop=nl)
    assert np.array_equal(routed, np.stack(j_routed))
    want = np.asarray(J.routed_light_gather(
        jp, tuple(jnp.asarray(r) for r in j_routed)))
    got = T.routed_light_gather(tp, tuple(torch.from_numpy(routed)),
                                T.LightLayout(8, False))
    assert np.array_equal(got.numpy(), want)
    for n in list(range(1, 70)) + [1000, 65537, 1 << 20]:
        assert port_engine._bucket_size(n) == J._bucket_size(n)


def test_gather_compact_matches_jax():
    """``gather_compact`` from per-part runs (tuple) and from global rows,
    and G1's wrapper on CPU tensors."""
    rng = np.random.default_rng(71)
    pairs, parts = _split_pairs(rng, 4)
    heights = [p.shape[0] for p in parts]
    uniq = tuple(np.sort(rng.choice(h, rng.integers(1, h), replace=False))
                 .astype(np.int32) for h in heights)
    jp = tuple(jnp.asarray(p) for p in parts)
    tp = tuple(torch.from_numpy(p) for p in parts)
    want = np.asarray(J.gather_compact(jp, tuple(jnp.asarray(u)
                                                 for u in uniq)))
    got = T.gather_compact(tp, tuple(torch.from_numpy(u) for u in uniq))
    assert np.array_equal(got.numpy(), want)
    off = np.concatenate([[0], np.cumsum([u.size for u in uniq])])
    g1 = T.gather_compact_(T.make_parts(tp, heights),
                           torch.from_numpy(np.concatenate(uniq)),
                           torch.from_numpy(off.astype(np.int32)))
    assert np.array_equal(g1.numpy(), want)
    rows = rng.integers(0, pairs.shape[0], 30).astype(np.int32)
    assert np.array_equal(
        T.gather_compact(tp, torch.from_numpy(rows)).numpy(),
        np.asarray(J.gather_compact(jp, jnp.asarray(rows))))


@pytest.mark.parametrize("source", ["parts", "uniq", "compact", "routed"])
def test_finalize_postings_row_sources_match_jax(source):
    """P3's plain version with JAX's row-source keywords against
    ``finalize_postings_v2`` (split parts, part-routed unique rows),
    ``finalize_postings_pipelined`` (a compact table) and
    ``finalize_postings_routed``: edge order, ``|L|``, scores, LWR."""
    rng = np.random.default_rng(72 + len(source))
    B, W, k, keep, E = 20, 9, 8, 7, 50
    pairs, parts = _split_pairs(rng, 3, E=E)
    nl = pairs.shape[0] - 1
    lrows = rng.integers(0, nl + 1, (B, W)).astype(np.int32)
    lrows[0] = nl
    rows, reads, slots, uniq_r = _dense_sources(rng, B, E, 12)
    lens = rng.integers(k, 150, B).astype(np.int32)
    thr = np.float32(-3.75)
    n_slots = uniq_r.size
    slot_read = np.full(n_slots, B, np.int32)
    slot_read[:n_slots] = uniq_r
    jp = tuple(jnp.asarray(p) for p in parts)
    tp = tuple(torch.from_numpy(p) for p in parts)
    dense = tuple(jnp.asarray(x) for x in (rows, reads, slots, slot_read,
                                           lens))
    heights = np.array([p.shape[0] for p in parts])
    offs = np.concatenate([[0], np.cumsum(heights)])
    if source == "routed":
        routed = route_rows(lrows, offs, drop=nl)
        out = J.finalize_postings_routed(
            jp, tuple(jnp.asarray(r) for r in routed), *dense[:4], dense[4],
            jnp.float32(thr), k, keep)
        kw = {"light_parts": tp, "routed_lrows": tuple(
            torch.from_numpy(routed))}
        t_lrows = None
    elif source == "parts":
        out = J.finalize_postings_v2(jp, jnp.asarray(lrows), None, *dense[:4],
                                     dense[4], jnp.float32(thr), k, keep)
        kw, t_lrows = {"light_parts": tp}, lrows
    else:
        u, inv = np.unique(lrows, return_inverse=True)
        part = np.searchsorted(offs[1:], u, side="right")
        per = tuple(np.ascontiguousarray(u[part == i] - offs[i])
                    .astype(np.int32) for i in range(len(parts)))
        t_lrows = inv.reshape(lrows.shape).astype(np.int32)
        if source == "uniq":
            out = J.finalize_postings_v2(
                jp, jnp.asarray(t_lrows), tuple(jnp.asarray(x) for x in per),
                *dense[:4], dense[4], jnp.float32(thr), k, keep)
            kw = {"light_parts": tp, "uniq_rows": tuple(
                torch.from_numpy(x) for x in per)}
        else:
            compact = J.gather_compact(jp, tuple(jnp.asarray(x)
                                                 for x in per))
            out, nxt = J.finalize_postings_pipelined(
                jp, compact, jnp.asarray(t_lrows), None, *dense[:4],
                dense[4], jnp.float32(thr), k, keep)
            assert nxt is None
            kw = {"compact_table": torch.from_numpy(np.array(compact))}
    acc_c = T.scatter_slots(torch.from_numpy(rows),
                            torch.from_numpy(slots.astype(np.int64)),
                            n_slots)
    slot_of = np.full(B, -1, np.int32)
    slot_of[uniq_r] = np.arange(n_slots, dtype=np.int32)
    got = T.finalize_postings(
        None, None if t_lrows is None else torch.from_numpy(t_lrows), acc_c,
        torch.from_numpy(slot_of), torch.from_numpy(lens),
        torch.tensor(thr), k, keep, layout=T.LightLayout(8, False), **kw)
    _same_top(tuple(x.numpy() for x in got),
              tuple(np.asarray(x) for x in out))


@pytest.mark.parametrize("u16", [False, True])
def test_direct_split_plain_versions_match_jax(u16):
    """``routed_accumulate`` over ``route_rows`` and
    ``alt_delta_rows_split`` (the global miss row included) against the
    JAX functions, and D1's and A1's wrappers on CPU tensors."""
    rng = np.random.default_rng(73 + u16)
    E, n_rows, B, Q = 40, 257, 16, 30
    dense = _table(rng, n_rows, E)
    scale = np.float32(1.0)
    if u16:
        dense = (dense * 20000).astype(np.uint16)
        scale = np.float32(1 / 20000)
    parts, cuts = convert.direct_parts(dense, dense.nbytes // 3 + 1, 0, 64)
    assert len(parts) == 3
    rows = rng.integers(0, n_rows, (B, Q)).astype(np.int32)
    routed = route_rows(rows, cuts)
    jp = tuple(jnp.asarray(p) for p in parts)
    tp = tuple(torch.from_numpy(p) for p in parts)
    want = np.asarray(J.routed_accumulate(jp, tuple(jnp.asarray(r)
                                                    for r in routed)))
    got = T.routed_accumulate(tp, tuple(torch.from_numpy(routed)))
    assert np.allclose(got.numpy(), want, rtol=1e-5, atol=0)
    tparts = T.make_parts(tp, np.diff(cuts))
    d1 = T.routed_accumulate_(tparts, torch.from_numpy(routed), float(scale))
    assert torch.equal(d1, got * float(scale))
    whole = dense[:-1].astype(np.float32)[rows.clip(max=n_rows - 2)]
    whole[rows == n_rows - 1] = 0
    assert np.allclose(got.numpy(), whole.sum(axis=1), rtol=1e-5, atol=1e-4)

    n_win = 9
    W = rng.integers(1, 5, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    alt_rows = rng.integers(0, n_rows, alt_win.size).astype(np.int32)
    alt_rows[::4] = n_rows - 1                      # the global miss row
    want_rows = np.asarray(J.alt_delta_rows_split(
        jp, jnp.float32(scale), jnp.asarray(alt_rows)))
    got_rows = T.alt_delta_rows_split(tp, float(scale),
                                      torch.from_numpy(alt_rows))
    assert np.array_equal(got_rows.numpy(), want_rows)
    assert not want_rows[::4].any()
    win_read = np.sort(rng.integers(0, B, n_win)).astype(np.int32)
    inv_w = (1.0 / W).astype(np.float32)
    is_mean = rng.random(n_win) < 0.5
    acc = got * float(scale)
    want_acc = np.asarray(J.ambiguous_pass(
        jnp.asarray(want_rows), jnp.asarray(alt_win), jnp.asarray(win_read),
        jnp.asarray(inv_w), jnp.asarray(is_mean), jnp.asarray(acc.numpy())))
    out = T.ambiguous_pass_split_(
        acc, tparts, float(scale), torch.from_numpy(alt_rows),
        torch.from_numpy(window_offsets(alt_win, n_win)),
        torch.from_numpy(win_read), torch.from_numpy(inv_w),
        torch.from_numpy(is_mean.astype(np.uint8)))
    assert out is acc
    assert np.allclose(acc.numpy(), want_acc, atol=2e-4, rtol=0)
    assert np.array_equal(acc.numpy() > 0, want_acc > 0)


def test_alt_delta_rows_postings_over_parts_matches_jax():
    """``alt_delta_rows_postings`` on a split light table (the light row
    from its part, the miss row ``nl`` from the last part), bitwise, and
    A1's postings wrapper on CPU tensors against the JAX composition."""
    rng = np.random.default_rng(74)
    E, P, nh = 50, 8, 10
    pairs, parts = _split_pairs(rng, 4, E=E)
    nl = pairs.shape[0] - 1
    H = _table(rng, nh + 1, E)
    n_win = 12
    W = rng.integers(1, 5, n_win)
    alt_win = np.repeat(np.arange(n_win), W).astype(np.int32)
    n_alt = alt_win.size
    light = rng.random(n_alt) < 0.7
    alt_lrows = np.where(light, rng.integers(0, nl, n_alt), nl)
    alt_hrows = np.where(light, nh, rng.integers(0, nh, n_alt))
    alt_lrows[::5], alt_hrows[::5] = nl, nh
    alt_lrows, alt_hrows = (x.astype(np.int32) for x in (alt_lrows,
                                                          alt_hrows))
    jp = tuple(jnp.asarray(p) for p in parts)
    tp = tuple(torch.from_numpy(p) for p in parts)
    j_rows = np.asarray(J.alt_delta_rows_postings(
        jp, jnp.asarray(H), jnp.asarray(alt_lrows), jnp.asarray(alt_hrows)))
    wide = T.LightLayout(P, False)
    t_rows = T.alt_delta_rows_postings(tp, torch.from_numpy(H),
                                       torch.from_numpy(alt_lrows),
                                       torch.from_numpy(alt_hrows),
                                       layout=wide)
    assert np.array_equal(t_rows.numpy(), j_rows)
    win_slot = np.sort(rng.integers(0, 5, n_win)).astype(np.int32)
    inv_w = (1.0 / W).astype(np.float32)
    is_mean = rng.random(n_win) < 0.5
    jc = np.asarray(J.ambiguous_contrib(
        jnp.asarray(j_rows), jnp.asarray(alt_win), jnp.asarray(inv_w),
        jnp.asarray(is_mean)))
    want = np.zeros((5, E), np.float32)
    np.add.at(want, win_slot, jc)
    acc_c = torch.zeros((5, E))
    T.ambiguous_postings_parts_(
        acc_c, torch.from_numpy(H),
        T.make_parts(tp, [p.shape[0] for p in parts]),
        torch.from_numpy(alt_lrows), torch.from_numpy(alt_hrows),
        torch.from_numpy(window_offsets(alt_win, n_win)),
        torch.from_numpy(win_slot), torch.from_numpy(inv_w),
        torch.from_numpy(is_mean.astype(np.uint8)), layout=wide)
    assert np.allclose(acc_c.numpy(), want, atol=2e-4, rtol=0)
    assert np.array_equal(acc_c.numpy() > 0, want > 0)
