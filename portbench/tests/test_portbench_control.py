"""The control comes out not correct at a size a test run holds (the
reference in the program's place with bfloat16 deltas), and a run takes
the precision its configuration states unless a control names another."""

import pytest

from portbench import cell, readings
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_bf16_control_fails(name):
    s = tiny.spec(name)
    numbers = readings.bf16_numbers(s, 13)
    assert not cell.verdict(numbers | {"calls_checked": 1}, s["limits"],
                            None)[0], numbers


@pytest.mark.parametrize("stated,asked,want", [("f32", None, "f32"),
                                               ("u16", None, "u16"),
                                               ("f32", "u16", "u16")])
def test_run_takes_the_stated_precision(stated, asked, want, tmp_path):
    import time
    s = tiny.spec(tiny.CELLS[0], pool=1)
    s["config"]["precision"] = stated
    seen = []

    def wrap(engine):
        seen.append(engine.precision)
        return engine
    cell.run(s, 3, 0.1, False, tmp_path, time.time(), device="cpu",
             precision=asked, engine_wrap=wrap)
    assert seen == [want]
