"""The recipes and the traffic generator are deterministic per seed, and
every seed makes the same amount of work."""

import numpy as np
import pytest

from portbench import cell, traffic
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_recipe_same_seed_same_db(name):
    s = tiny.spec(name)
    recipe = cell.load_module(cell.HERE / "recipes" /
                              f"{s['config']['recipe']}.py", "r")
    a, b, c = (recipe.make(s["config"], seed) for seed in (5, 5, 6))
    for key in ("codes", "edges", "scores"):
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["scores"], c["scores"])
    assert a["edges"].min() >= 1
    assert a["edges"].max() < s["config"]["n_edge_slots"]


@pytest.mark.parametrize("mix", [None, tiny.HARDER],
                         ids=["cell", "short_and_N"])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_pool_same_seed_same_reads_and_same_work(name, mix):
    s = tiny.spec(name, **(mix or {}))
    big = 2 ** 31 + 12345
    a = traffic.make_pool(s["mix"], big)
    b = traffic.make_pool(s["mix"], big)
    c = traffic.make_pool(s["mix"], big + 1)
    assert [x.seqs for x in a] == [x.seqs for x in b]
    assert [x.headers for x in a] == [x.headers for x in b]
    assert [x.seqs for x in a] != [x.seqs for x in c]
    mix = s["mix"]
    n = mix["reads_per_sample"]
    for sample in a + c:
        assert len(sample.seqs) == n
        assert len(set(sample.seqs)) == n - round(mix["duplicate_share"] * n)
    # the same distinct lengths and N's in every seed, in another order
    for x, y in zip(a, c):
        ux, uy = set(x.seqs), set(y.seqs)
        assert sorted(map(len, ux)) == sorted(map(len, uy))
        assert sum(q.count(b"N") for q in ux) == \
            sum(q.count(b"N") for q in uy)


def test_call_order_cycles_the_pool():
    order = traffic.call_order(16, 9)
    first = [next(order) for _ in range(32)]
    assert sorted(first[:16]) == list(range(16))
    assert sorted(first[16:]) == list(range(16))
    again = traffic.call_order(16, 9)
    assert [next(again) for _ in range(32)] == first
