"""``run.py`` end to end: on a machine without a card it fails and prints
no result; on the card (``-m cuda``) it prints a correct result line."""

import json
import subprocess
import sys

import pytest

from portbench import cell

RUN = [sys.executable, str(cell.HERE / "run.py")]


def _run(*args, timeout=600):
    return subprocess.run(RUN + list(args), capture_output=True, text=True,
                          timeout=timeout, cwd=cell.ROOT)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_no_card_no_result(no_card):
    r = _run("--workload", "c1-16s-k8.miseq240", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
    assert "no CUDA device" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_card_result_line(card, trace):
    r = _run("--workload", "c1-16s-k8.miseq240", "--seed",
             str(2 ** 31 + 99), "--seconds", "2", "--trace", str(trace))
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    want = cell.load_spec("c1-16s-k8.miseq240")
    names = {m["name"] for m in want["per_layer" if trace else
                                     "end_to_end"]}
    assert set(line["metrics"]) == names
    assert line["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
