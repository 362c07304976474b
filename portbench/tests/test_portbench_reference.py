"""The plain reference agrees with the port at a tiny size: with the
port's float64 oracle on every candidate, and with the port's engine on
the CPU through a whole run's judgement."""

import numpy as np
import pytest

from portbench import cell, reference, traffic
from portbench.tests import tiny


def _db_and_ref(name, seed=4, mix=None):
    s = tiny.spec(name, **(mix or {}))
    conf = s["config"]
    recipe = cell.load_module(cell.HERE / "recipes" / f"{conf['recipe']}.py",
                              "r")
    raw = recipe.make(conf, seed)
    ref = reference.Reference(conf["k"], conf["omega"], raw["codes"],
                              raw["edges"], raw["scores"],
                              conf["n_edge_slots"])
    return s, raw, cell.program_db(conf, raw), ref


@pytest.mark.parametrize("mix", [None, tiny.HARDER],
                         ids=["cell", "short_and_N"])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_matches_port_oracle_in_f64(name, mix):
    from rappas_tpu_torch.place.oracle import exact_scores

    s, raw, db, ref = _db_and_ref(name, mix=(mix or {}) |
                                  {"reads_per_sample": 400})
    sample = traffic.make_pool(s["mix"], 11)[0]
    uniq, _, _ = reference.expected_layout(sample)
    uniq = uniq[:80]
    scored = ref.score(uniq)
    n_amb = 0
    for i, seq in enumerate(uniq):
        want = exact_scores(db, seq.decode())
        e, sc = scored.candidates(i)
        got = dict(zip(e.tolist(), sc.tolist()))
        assert got.keys() == want.keys()
        # the oracle adds f32 raw scores rebuilt from the DB's f32 deltas
        # (two roundings of about 2.4e-7 a hit); the reference adds the
        # recipe's own scores less the threshold
        for x in want:
            assert abs(got[x] - want[x]) < 2e-6
        n_amb += b"N" in seq
    assert len(uniq) == 80
    assert (n_amb > 0) == bool(s["mix"]["ambiguous_share"])


def test_reference_thresholds_are_rappas():
    from rappas_tpu_torch.db import PhyloKmerDB
    for k in (6, 8, 10, 12):
        assert reference.rappas_threshold(k, 1.5, 4) == \
            PhyloKmerDB.threshold(k, 1.5, 4)


def test_star_tree_numbering_is_the_ports():
    from rappas_tpu_torch.tree import parse_newick
    tree = parse_newick(cell.star_newick(12, 0.1))
    tree.reset_jplace_edge_ids()
    arr = tree.to_arrays()
    leaves = np.arange(1, 12)
    np.testing.assert_array_equal(
        reference.star_node(arr.jplace_edge_id[leaves]), leaves)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 2.5, 1e-30], np.float32)
    got = reference.to_bfloat16(x)
    assert got[0] == 1.0 and got[1] == 1.0   # a tie rounds to even
    assert got[2] == np.float32(1.0078125)
    assert got[3] == 2.5
    assert abs(got[4] - 1e-30) / 1e-30 < 2 ** -8


@pytest.mark.parametrize("mix", [None, tiny.HARDER],
                         ids=["cell", "short_and_N"])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_port_on_cpu_passes_the_judge(name, mix, tmp_path):
    out = tiny.run(name, tmp_path, mix=mix)
    ok, rows = cell.verdict(out["numbers"], tiny.spec(name)["limits"],
                            out["failure"])
    assert ok, rows
    assert out["numbers"]["calls_checked"] >= 1
    assert out["numbers"]["placements"] > 0
