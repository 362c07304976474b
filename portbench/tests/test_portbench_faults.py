"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the engine runs its plain
versions on the CPU at a tiny size) and the rest of a run is driven,
with one fault planted where the engine produces its answers."""

import numpy as np
import pytest

from portbench import cell
from portbench.tests import tiny


class Faulty:
    """The engine with ``fault(result, live_reads, state)`` applied to each
    batch's result."""

    def __init__(self, engine, fault):
        self._engine = engine
        self._fault = fault
        self._state: dict = {}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def score_async(self, matrix, lengths):
        handle = self._engine.score_async(matrix, lengths)
        live = int((np.asarray(lengths) > 0).sum())
        outer = self

        class Handle:
            def result(self):
                return outer._fault(handle.result(), live, outer._state)
        return Handle()


def _copy(res):
    return type(res)(*(np.array(a) for a in res))


def state_unchanged(res, live, state):
    """Each batch gets the result the batch before it left behind."""
    prev = state.get("prev", res)
    state["prev"] = res
    return prev


def half_left_out(res, live, state):
    """The second half of the batch's reads are never scored."""
    out = _copy(res)
    lo = live // 2
    out.top_edges[lo:live] = -1
    out.top_scores[lo:live] = -np.inf
    out.top_lwr[lo:live] = 0
    out.n_matched[lo:live] = 0
    return out


def answer_altered(res, live, state):
    """The first placed read's best edge is changed where it is
    produced (to a neighbouring node id)."""
    out = _copy(res)
    i = int(np.flatnonzero(out.top_edges[:live, 0] >= 0)[0])
    e = int(out.top_edges[i, 0])
    out.top_edges[i, 0] = e - 1 if e > 1 else e + 1
    return out


def _verdict(name, tmp_path, wrap=None, reads=None):
    s = tiny.spec(name)
    if reads:
        s["mix"]["reads_per_sample"] = reads
    import time
    out = cell.run(s, 21, 0.5, False, tmp_path, time.time(), device="cpu",
                   engine_wrap=wrap)
    return cell.verdict(out["numbers"], s["limits"], out["failure"]), out


#: a state left unchanged shows within a sample of two batches or more
FAULTS = [(name, fault, reads) for name in tiny.CELLS
          for fault, reads in ((state_unchanged, 4000), (half_left_out, None),
                               (answer_altered, None))]


@pytest.mark.parametrize("name,fault,reads", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, reads, tmp_path):
    (ok, rows), out = _verdict(name, tmp_path,
                               lambda e: Faulty(e, fault), reads)
    assert not ok, rows
