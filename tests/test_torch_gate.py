"""The score gate at real-size accumulators, on the CPU: a DB built by the
port's ``-p b --ardir`` from ``chip_smoke.synthetic_ardir`` and 150-bp
reads cut from its leaves, which hit on every window, so their
accumulators reach hundreds whatever the tree's size.  There two f32
summation orders differ by more than the 2e-4 of
``tests/test_engine.py:41-60``; the yardstick is the f64 sum of the same
postings (``rappas_tpu_torch.place.oracle.exact_scores``).  The port's CPU
engine and JAX's CPU engine each lie within 2e-4 of it, with the f64 top
edges, so they lie within 4e-4 of each other."""

import numpy as np
import pytest

import chip_smoke
from rappas_tpu.db import PhyloKmerDB as JaxDB
from rappas_tpu.place.engine import PlacementEngine as JaxEngine
from rappas_tpu_torch.cli import main as port_main
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.place.oracle import exact_scores
from test_engine import batch_of

TOL = 2e-4


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """(DB path, port DB, 64 leaf reads, their f64 scores)."""
    work = tmp_path_factory.mktemp("gate")
    align, tree, ar = chip_smoke.synthetic_ardir(work / "syn", 20, 600, 0)
    assert port_main(["-p", "b", "-r", str(align), "-t", str(tree), "-b",
                      "/fake/raxml-ng", "--ardir", str(ar), "-w",
                      str(work / "db")]) == 0
    path = work / "db" / "DB_k8_o1.5.rptpu"
    db = PhyloKmerDB.load(path)
    leaves = [ln for ln in align.read_text().split("\n")
              if ln and not ln.startswith(">")]
    rng = np.random.default_rng(1)
    reads = []
    for i in rng.integers(0, len(leaves), 64):
        start = int(rng.integers(0, len(leaves[i]) - 150 + 1))
        reads.append(leaves[i][start:start + 150])
    return path, db, reads, [exact_scores(db, s) for s in reads]


@pytest.fixture(scope="module")
def results(gate):
    path, db, reads, _ = gate
    mat, lens = batch_of(reads)
    return {"port": PlacementEngine(db, device="cpu").score(mat, lens),
            "jax": JaxEngine(JaxDB.load(path)).score(mat, lens)}


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_engine_within_2e4_of_f64(gate, results, engine):
    _, db, reads, exact = gate
    res = results[engine]
    acc = res.top_scores[:, 0] - (150 - db.k + 1) * np.float32(db.thr_log10)
    assert np.abs(acc).max() > 100, "the reads do not reach real-size sums"
    for i, ex in enumerate(exact):
        assert res.n_matched[i] == len(ex)
        chip_smoke.exact_distance(chip_smoke.result_rows(res, i), ex, TOL,
                                  f"{engine} read {i}")


def test_engines_within_the_sum_of_their_bounds(results):
    a, b = results["port"], results["jax"]
    assert np.array_equal(a.n_matched, b.n_matched)
    np.testing.assert_allclose(a.top_scores[:, 0], b.top_scores[:, 0],
                               atol=2 * TOL, rtol=0)
