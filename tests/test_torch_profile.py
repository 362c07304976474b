"""``--profile DIR`` in the port's CLI (``torch.profiler``, host activity on
``--device cpu``): ``-p p`` and the placement of ``-p b --ardir --dbinram
-q`` write a non-empty ``*.pt.trace.json`` into DIR, and their jplace
holds the placements of the same run without the profiler."""

import json
import shutil

import pytest

from rappas_tpu_torch import utils
from rappas_tpu_torch.cli import main as port_main
from test_torch_imports import _tiny_db


@pytest.fixture(autouse=True)
def _fresh_trace_totals():
    """``--profile`` turns the program's spans on and the next CLI call
    off again, keeping their totals: leave none to a later test in this
    process (the benchmark harness counts its set-up spans from them)."""
    yield
    utils.tracing(False)
    utils.trace_reset()


def _traced_and_plain(tmp_path, argv, out_name):
    """Run ``argv`` with ``--profile`` and without; the two jplace
    documents (parsed)."""
    docs = []
    for tag in ("profiled", "plain"):
        wd = tmp_path / tag
        extra = ["--profile", str(tmp_path / "trace")] \
            if tag == "profiled" else []
        assert port_main([*argv(tag), "-w", str(wd), *extra]) == 0
        docs.append(json.loads((wd / out_name).read_text()))
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    return docs


def _same_placements(a, b):
    assert a["placements"] and a["tree"] == b["tree"]
    assert a["fields"] == b["fields"] and a["placements"] == b["placements"]


def test_profile_placement(tmp_path):
    _tiny_db().save(tmp_path / "db.rptpu")
    (tmp_path / "q.fasta").write_text(
        ">q1\nACGTACGTACGTACGGTTACAC\n>q2\nTTGACNAGTACCAGTAGGCA\n")
    docs = _traced_and_plain(
        tmp_path, lambda tag: ["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                               "-q", str(tmp_path / "q.fasta"),
                               "--device", "cpu"],
        "placements_q.fasta.jplace")
    _same_placements(*docs)


def test_profile_dbinram_build_placement(tmp_path, fixtures_dir):
    """JAX traces only ``_place_all``; so does the port, which the
    ``--dbinram -q`` placement of ``-p b`` runs."""
    def argv(tag):
        ar = tmp_path / f"{tag}_ar"
        shutil.copytree(fixtures_dir / "raxmlng_ardir", ar)
        return ["-p", "b", "-r", str(fixtures_dir / "tiny.fasta"),
                "-t", str(fixtures_dir / "tiny.tree"), "-b",
                "/fake/raxml-ng", "--ardir", str(ar), "--dbinram", "-q",
                str(fixtures_dir / "tiny_reads.fasta"), "--device", "cpu"]
    docs = _traced_and_plain(tmp_path, argv,
                             "placements_tiny_reads.fasta.jplace")
    _same_placements(*docs)

