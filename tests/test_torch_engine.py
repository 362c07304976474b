"""The port's engine (``device="cpu"``: the kernels' plain versions)
against the serial reference-semantics oracle and against the JAX engine,
mirroring ``tests/test_engine.py``.  Tolerances as there (lines 41-60):
edge sets and ``|L|`` identical, scores within 2e-4, LWR within 1e-4."""

import numpy as np
import pytest

from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu.tree import write_newick
from rappas_tpu_torch.convert import db_from_arrays
from rappas_tpu_torch.place import kernels as T
from rappas_tpu_torch.place.engine import PlacementEngine
from test_engine import (batch_of, compare, random_reads, synthetic_aa_db,
                         synthetic_db)


def port_db(j):
    return db_from_arrays(j.k, j.omega, j.alphabet.name, j.thr_log10,
                          write_newick(j.tree, True, True, True, False),
                          j.keys, j.offsets, j.edges, j.deltas, j.meta)


@pytest.fixture(scope="module")
def db():
    return synthetic_db()


@pytest.fixture(scope="module")
def tdb(db):
    return port_db(db)


@pytest.fixture(scope="module")
def engine(tdb):
    """The direct layout, which the JAX engine's ``auto`` takes for this
    DB (the port's takes compact)."""
    return PlacementEngine(tdb, device="cpu", table="direct")


def same_as_jax(res_t, res_j):
    assert np.array_equal(res_t.n_matched, res_j.n_matched)
    for i in range(res_t.n_matched.shape[0]):
        vt, vj = res_t.top_edges[i] >= 0, res_j.top_edges[i] >= 0
        assert sorted(res_t.top_edges[i][vt]) == \
            sorted(res_j.top_edges[i][vj]), f"read {i}"
        assert np.allclose(sorted(res_t.top_scores[i][vt]),
                           sorted(res_j.top_scores[i][vj]), atol=2e-4)
        assert np.allclose(sorted(res_t.top_lwr[i][vt]),
                           sorted(res_j.top_lwr[i][vj]), atol=1e-4)


def test_pure_reads_match_oracle(db, engine):
    rng = np.random.default_rng(1)
    compare(db, engine, random_reads(40, rng))


def test_ambiguous_reads_match_oracle(db, engine):
    rng = np.random.default_rng(2)
    compare(db, engine, random_reads(40, rng, with_amb=1.0))


def test_ambiguous_max_mode(db, tdb):
    engine = PlacementEngine(tdb, ambiguities_with_max=True, device="cpu",
                             table="direct")
    rng = np.random.default_rng(3)
    compare(db, engine, random_reads(30, rng, with_amb=1.0),
            ambiguities_with_max=True)


def test_noamb_mode(db, tdb):
    engine = PlacementEngine(tdb, treat_ambiguities=False, device="cpu",
                             table="direct")
    rng = np.random.default_rng(4)
    compare(db, engine, random_reads(30, rng, with_amb=1.0),
            treat_ambiguities=False)


def test_mixed_batch_packed_and_coded_reads(db, engine):
    """Reads clean inside their length go packed (K1), the others as int8
    codes (K2), into one accumulator: the mix matches the oracle, and a
    read scores the same whichever batch it rides in."""
    rng = np.random.default_rng(11)
    reads = random_reads(24, rng, with_amb=0.3)
    compare(db, engine, reads)
    # a character that is neither state nor ambiguity: its windows miss
    # (the oracle rejects such reads; the JAX engine scores them)
    junk = reads + ["ACGTTGCA" + "X" + "ACGTGGCATTAC"]
    same_as_jax(engine.score(*batch_of(junk)),
                JaxEngine(db, table="direct").score(*batch_of(junk)))
    alone = engine.score(*batch_of([reads[0]]))
    mixed = engine.score(*batch_of(reads))
    assert np.array_equal(alone.top_edges[0], mixed.top_edges[0])
    assert np.array_equal(alone.top_scores[0], mixed.top_scores[0])


def test_too_short_read(engine):
    mat, lens = batch_of(["ACG"])  # shorter than k
    res = engine.score(mat, lens)
    assert res.n_matched[0] == 0


def test_score_formula_unmatched_is_excluded(engine):
    rng = np.random.default_rng(5)
    reads = random_reads(20, rng)
    res = engine.score(*batch_of(reads))
    for i in range(len(reads)):
        n = int(res.n_matched[i])
        valid = (res.top_edges[i] >= 0).sum()
        assert valid == min(n, engine.keep_at_most)


def test_lwr_normalized(engine):
    rng = np.random.default_rng(6)
    reads = random_reads(10, rng)
    res = engine.score(*batch_of(reads))
    for i in range(len(reads)):
        if res.n_matched[i] == 0:
            continue
        w = res.top_lwr[i][res.top_edges[i] >= 0]
        assert np.isclose(w.sum(), 1.0, atol=1e-5)
        assert (np.diff(res.top_scores[i][res.top_edges[i] >= 0]) <=
                1e-6).all()


def test_packed_path_matches_int8(engine):
    import torch
    from rappas_tpu_torch.place.engine import pack_reads
    rng = np.random.default_rng(10)
    mat, lens = batch_of(random_reads(16, rng))
    codes = engine.encode_batch(mat)
    L = mat.shape[1]
    r_int8 = T.kmer_rows(torch.from_numpy(codes), engine.k, 4,
                         engine.n_rows)
    r_packed = T.kmer_rows_packed(
        torch.from_numpy(pack_reads(codes)), torch.from_numpy(lens),
        engine.k, 4, engine.n_rows, L)
    assert torch.equal(r_int8, r_packed)


@pytest.mark.parametrize("kw, amb", [
    ({}, 0.0), ({}, 0.5), ({"ambiguities_with_max": True}, 0.5),
    ({"treat_ambiguities": False}, 0.5), ({"keep_at_most": 4}, 0.3),
    ({"keep_at_most": 1}, 0.3)])
def test_matches_jax_engine(db, tdb, kw, amb):
    rng = np.random.default_rng(7)
    mat, lens = batch_of(random_reads(64, rng, with_amb=amb))
    same_as_jax(PlacementEngine(tdb, device="cpu", table="direct",
                                **kw).score(mat, lens),
                JaxEngine(db, table="direct", **kw).score(mat, lens))


def test_protein_mode_matches_oracle_and_jax():
    """A non-DNA alphabet sends every read through the int8-code path."""
    db = synthetic_aa_db()
    engine = PlacementEngine(port_db(db), device="cpu", table="direct")
    assert engine.table == "direct"
    rng = np.random.default_rng(12)
    letters = db.alphabet.letters
    reads = ["".join(letters[c] for c in rng.integers(0, 20, 25))
             for _ in range(20)]
    reads[0] = reads[0][:5] + "X" + reads[0][6:]
    compare(db, engine, reads)
    same_as_jax(engine.score(*batch_of(reads)),
                JaxEngine(db, table="direct").score(*batch_of(reads)))


def test_score_async_result_and_table_resolution(db, tdb, engine):
    rng = np.random.default_rng(8)
    mat, lens = batch_of(random_reads(12, rng, with_amb=0.5))
    pend = engine.score_async(mat, lens)
    res = pend.result()
    assert res.top_edges.shape == (12, min(7, tdb.n_edge_slots))
    assert engine.table == JaxEngine.resolve_table(
        db, "auto", "f32", JaxEngine.DIRECT_BYTE_LIMIT) == "direct"
    # the port's H100 rule takes the compact table for this DB
    assert PlacementEngine.resolve_table(
        tdb, "auto", "f32", PlacementEngine.table_budget("cpu")) == "compact"
    assert PlacementEngine(tdb, device="cpu").table == "compact"


@pytest.mark.parametrize("kw", [{"precision": "u16"}, {"table": "compact"}],
                         ids=["u16", "compact"])
def test_u16_and_compact_layouts_place(db, tdb, kw):
    """``precision="u16"`` and ``table="compact"`` are ported: they place
    as the JAX engine does (``tests/test_torch_compact.py`` holds them
    against it in every mode)."""
    engine = PlacementEngine(tdb, device="cpu", **kw)
    # u16 alone: the port's rule takes the compact table
    assert engine.table == kw.get("table", "compact")
    mat, lens = batch_of(random_reads(16, np.random.default_rng(13),
                                      with_amb=0.5))
    res = engine.score(mat, lens)
    assert (res.n_matched > 0).any()
    same_as_jax(res, JaxEngine(db, **dict(kw, table=engine.table)).score(
        mat, lens))


def test_postings_layout_runs(db, tdb):
    """``table="postings"`` is ported: it places like the direct table
    (``tests/test_torch_postings.py`` holds it against the JAX engine)."""
    engine = PlacementEngine(tdb, device="cpu", table="postings")
    assert engine.table == "postings"
    rng = np.random.default_rng(9)
    reads = random_reads(16, rng, with_amb=0.5)
    compare(db, engine, reads)
