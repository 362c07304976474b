"""The port's serial oracle (``rappas_tpu_torch.place.oracle``) against the
JAX package's (``rappas_tpu.place.oracle``): the same numpy f32 operations
in the same order, so every row is bitwise the same -- edges, f32 scores,
LWR floats and ``|L|`` -- on the synthetic DBs of
``tests/test_engine.py``, its protein DB and the DB of the canned
``--ardir`` fixture.  Then the port's CPU engine against the port's oracle
with the tolerances of ``tests/test_engine.py:41-60``, and
``exact_scores`` (the f64 sums) against the f32 oracle."""

import numpy as np
import pytest

from rappas_tpu.build.pipeline import BuildConfig, build_database
from rappas_tpu.place import oracle as jax_oracle
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place import oracle
from rappas_tpu_torch.place.engine import PlacementEngine
from test_engine import batch_of, random_reads, synthetic_aa_db, synthetic_db
from test_torch_engine import port_db


@pytest.fixture(scope="module")
def ardir_db_path(tmp_path_factory, fixtures_dir):
    """The canned RAxML-ng fixture's DB, built by the JAX package."""
    wd = tmp_path_factory.mktemp("oracle_ardir")
    build_database(fixtures_dir / "tiny.fasta", fixtures_dir / "tiny.tree",
                   wd, BuildConfig(k=8, omega=1.5, states="nucl",
                                   ar_binary="/fake/path/raxml-ng",
                                   ar_dir=str(fixtures_dir /
                                              "raxmlng_ardir")))
    return wd / "DB_k8_o1.5.rptpu"


def fixture_reads(fixtures_dir, seed=0):
    """tiny_reads, every third with one N / R / Y."""
    rng = np.random.default_rng(seed)
    reads = [r.split("\n", 1)[1].replace("\n", "") for r in
             (fixtures_dir / "tiny_reads.fasta").read_text()
             .split(">")[1:]]
    return [s[:p] + "NRY"[i % 3] + s[p + 1:] if i % 3 == 0 else s
            for i, s in enumerate(reads)
            for p in [int(rng.integers(0, len(s)))]]


def protein_reads(db, seed=12):
    """Reads of six DB k-mers each (a uniform read rarely hits at 20^k)."""
    rng = np.random.default_rng(seed)
    reads = ["".join(db.alphabet.kmer_to_string(int(x), db.k)
                     for x in rng.choice(db.keys, 6)) for _ in range(20)]
    reads[0] = reads[0][:5] + "X" + reads[0][6:]
    reads[1] = reads[1][:9] + "B" + reads[1][10:]
    return reads


def dbs_and_reads(kind, fixtures_dir, ardir_db_path):
    """(JAX DB, port DB, reads) of one case."""
    if kind == "ardir":
        from rappas_tpu.db import PhyloKmerDB as JaxDB
        return (JaxDB.load(ardir_db_path), PhyloKmerDB.load(ardir_db_path),
                fixture_reads(fixtures_dir))
    if kind == "protein":
        jdb = synthetic_aa_db()
        return jdb, port_db(jdb), protein_reads(jdb)
    jdb = synthetic_db()
    rng = np.random.default_rng(7)
    return jdb, port_db(jdb), random_reads(
        40, rng, with_amb=1.0 if kind == "ambiguous" else 0.0)


def same_rows(got, want):
    """Two oracle results, bit for bit."""
    (rows_g, n_g), (rows_w, n_w) = got, want
    assert n_g == n_w
    assert [r[0] for r in rows_g] == [r[0] for r in rows_w]
    assert [np.float32(r[1]).view(np.uint32) for r in rows_g] == \
        [np.float32(r[1]).view(np.uint32) for r in rows_w]
    assert [r[2] for r in rows_g] == [r[2] for r in rows_w]


CASES = ([(kind, mode, keep) for kind in ("pure", "ambiguous")
          for mode in ("mean", "max") for keep in (1, 7, 20)] +
         [(kind, mode, 7) for kind in ("protein", "ardir")
          for mode in ("mean", "max")])


@pytest.mark.parametrize("kind, mode, keep", CASES)
def test_oracle_bitwise_jax(kind, mode, keep, fixtures_dir, ardir_db_path):
    jdb, tdb, reads = dbs_and_reads(kind, fixtures_dir, ardir_db_path)
    kw = dict(keep_at_most=keep, ambiguities_with_max=mode == "max")
    placed = 0
    for s in reads:
        got = oracle.place_read(tdb, s, **kw)
        same_rows(got, jax_oracle.place_read(jdb, s, **kw))
        placed += got[1] > 0
    assert placed > len(reads) // 2


def test_oracle_noamb_bitwise_jax():
    """``treat_ambiguities=False`` skips the ambiguous windows in both."""
    jdb = synthetic_db()
    tdb = port_db(jdb)
    for s in random_reads(30, np.random.default_rng(8), with_amb=1.0):
        same_rows(oracle.place_read(tdb, s, treat_ambiguities=False),
                  jax_oracle.place_read(jdb, s, treat_ambiguities=False))


def engine_vs_oracle(tdb, engine, reads, **kw):
    """``tests/test_engine.py:41-60`` with the port's oracle: ``|L|`` and
    edge sets identical, scores within 2e-4, LWR within 1e-4."""
    mat, lens = batch_of(reads)
    res = engine.score(mat, lens)
    for i, s in enumerate(reads):
        rows, nm = oracle.place_read(tdb, s, **kw)
        assert nm == res.n_matched[i], f"read {i}: |L| mismatch"
        if nm == 0:
            continue
        v = res.top_edges[i] >= 0
        assert sorted(res.top_edges[i][v]) == sorted(r[0] for r in rows)
        np.testing.assert_allclose(sorted(res.top_scores[i][v]),
                                   sorted(float(r[1]) for r in rows),
                                   atol=2e-4)
        np.testing.assert_allclose(sorted(res.top_lwr[i][v]),
                                   sorted(r[2] for r in rows), atol=1e-4)


@pytest.mark.parametrize("kind, mode", [
    ("pure", "mean"), ("ambiguous", "mean"), ("ambiguous", "max"),
    ("protein", "mean"), ("ardir", "mean"), ("ardir", "max")])
def test_port_engine_matches_port_oracle(kind, mode, fixtures_dir,
                                         ardir_db_path):
    _, tdb, reads = dbs_and_reads(kind, fixtures_dir, ardir_db_path)
    kw = {"ambiguities_with_max": mode == "max"}
    engine = PlacementEngine(tdb, device="cpu", **kw)
    engine_vs_oracle(tdb, engine, reads, **kw)


@pytest.mark.parametrize("kind", ["pure", "ambiguous", "protein", "ardir"])
def test_exact_scores_are_the_oracle_in_f64(kind, fixtures_dir,
                                            ardir_db_path):
    """``exact_scores`` names the oracle's candidates, and its f64 sums lie
    within f32 summation error of the oracle's scores: one ulp of the
    largest running sum per window (a sum starts at ``Q * thr``)."""
    _, tdb, reads = dbs_and_reads(kind, fixtures_dir, ardir_db_path)
    for s in reads:
        rows, nm = oracle.place_read(tdb, s, keep_at_most=10 ** 6)
        exact = oracle.exact_scores(tdb, s)
        assert len(exact) == nm
        assert sorted(exact) == sorted(r[0] for r in rows)
        n_windows = len(s) - tdb.k + 1
        start = abs(n_windows * float(tdb.thr_log10))
        for x, score, _ in rows:
            ulp = np.spacing(np.float32(max(abs(float(score)), start)))
            assert abs(exact[x] - float(score)) <= n_windows * float(ulp)
    assert oracle.exact_scores(tdb, "AC") == {}
