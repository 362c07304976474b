"""The port's tracing (``rappas_tpu_torch.utils``: spans and counters)
and the spans and counters of ``place_queries``: off by default at one
shared no-op context, self times on nested spans, per-thread nesting,
hand-counted duplicate paths, outputs unchanged by tracing, the main
thread's spans covering a call, and ``--profile``'s trace holding them."""

import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rappas_tpu_torch import utils
from rappas_tpu_torch.cli import main as port_main
from rappas_tpu_torch.place import kernels, pipeline
from rappas_tpu_torch.place.engine import PlacementEngine
from rappas_tpu_torch.place.pipeline import PlacementConfig, place_queries
from test_torch_imports import _tiny_db

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the main thread's steps that ``place.call`` encloses
MAIN = ("place.start", "place.ingest_wait", "place.dedup",
        "place.prep_wait", "place.fold", "place.finish")


@pytest.fixture
def traced():
    utils.trace_reset()
    utils.tracing(True)
    try:
        yield
    finally:
        utils.tracing(False)
        utils.trace_reset()


def test_off_by_default_without_the_profiler():
    code = ("import sys; from rappas_tpu_torch import utils; "
            "assert not utils._ON; assert 'torch.profiler' not in "
            "sys.modules; assert utils.span('a') is utils.span('b')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_off_is_one_shared_noop():
    utils.tracing(False)
    utils.trace_reset()
    s = utils.span("place.call")
    assert s is utils.span("place.fold")
    with s:
        with utils.span("place.fold"):
            pass
    assert utils.trace_totals()["spans"] == {}


def test_self_is_total_less_children(traced):
    with utils.span("outer"):
        time.sleep(0.01)
        with utils.span("inner"):
            time.sleep(0.02)
        with utils.span("inner"):
            time.sleep(0.01)
    sp = utils.trace_totals()["spans"]
    assert sp["outer"]["count"] == 1 and sp["inner"]["count"] == 2
    assert sp["inner"]["self_s"] == pytest.approx(sp["inner"]["total_s"])
    assert sp["outer"]["self_s"] == pytest.approx(
        sp["outer"]["total_s"] - sp["inner"]["total_s"], abs=1e-9)
    assert sp["outer"]["self_s"] >= 0.01


def test_threads_do_not_nest(traced):
    opened = threading.Event()

    def other():
        with utils.span("b"):
            opened.set()
            time.sleep(0.03)

    with utils.span("a"):
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(10)
        t.join(10)
        assert not t.is_alive()
    sp = utils.trace_totals()["spans"]
    assert sp["b"]["total_s"] >= 0.03
    assert sp["a"]["self_s"] == sp["a"]["total_s"]


def test_counters_and_the_counts_kept_elsewhere():
    utils.trace_reset()
    utils.count("place.reads", 5)
    utils.count("place.reads")
    # a kernel launch and a native row sweep count where they run
    for _ in range(2):
        kernels._launch("finalize_wire", lambda: 0)
    from rappas_tpu_torch import native
    native.probe_light_rows(np.zeros((1, 4), np.int8), np.full(1, 4, np.int32),
                            2, 4, 16, np.ones(17, np.int32),
                            direct=np.arange(17, dtype=np.int32))
    c = utils.trace_totals()["counters"]
    assert c["place.reads"] == 6
    assert c["kernel.launch.finalize_wire"] == 2
    assert c["native.probe_rows"] == 1
    assert not any(n.startswith("kernel.launch.") and not v
                   for n, v in c.items())
    assert utils.counter("kernel.launch.finalize_wire") == 2
    utils.trace_reset()
    assert utils.trace_totals()["counters"] == {}
    assert utils.counter("kernel.launch.finalize_wire") == 0
    assert utils.counter("native.probe_rows") == 0


# ---------------------------------------------------------------------
# place_queries on two blocks: the first's batches of 4 reads are folded
# (all but the three last in flight) before the second is deduped


def _rand(rng, n=30):
    return "".join(rng.choice(list("ACGT"), n))


def _sample(db, rng):
    """Two FASTA blocks of 30 bp reads and the hand counts: block 1 holds
    40 distinct reads, the first with no k-mer of the DB; block 2 holds
    duplicates of that unplaced read (folded), of placed reads 1 and 2
    (folded), of read 39 (its batch still in flight), and a new read with
    its duplicate (in flight: its own block)."""
    keys = set(db.keys.tolist())
    k = db.k
    code = {c: i for i, c in enumerate("ACGT")}

    def hits(s):
        return any(sum(code[c] << 2 * (k - 1 - j)
                       for j, c in enumerate(s[i:i + k])) in keys
                   for i in range(len(s) - k + 1))
    absent = [c * 30 for c in "ACGT" if not hits(c * 30)]
    assert absent, "every homopolymer k-mer is in the DB"
    firsts = [absent[0]]
    while len(firsts) < 40:
        s = _rand(rng)
        if hits(s) and s not in firsts:
            firsts.append(s)
    new = _rand(rng)
    b1 = [(f"u{i}", s) for i, s in enumerate(firsts)]
    b2 = [("d0", firsts[0]), ("d1", firsts[1]), ("d2", firsts[2]),
          ("d3", firsts[1]), ("d4", firsts[39]), ("v0", new),
          ("v1", new)]
    counts = {"place.reads": 47, "place.unique": 41, "place.unplaced": 2,
              "place.blocks": 2, "place.batches": 11,
              "place.dups_attached": 3, "place.dups_pending": 2,
              "place.dups_unplaced": 1}
    return b1, b2, counts


def _text(recs):
    return "".join(f">{h} x\n{s}\n" for h, s in recs).encode()


@pytest.fixture
def two_blocks(tmp_path, monkeypatch):
    from rappas_tpu_torch.native import parse_fasta_block
    db = _tiny_db()
    b1, b2, counts = _sample(db, np.random.default_rng(5))
    q = tmp_path / "q.fasta"
    q.write_bytes(_text(b1) + _text(b2))
    monkeypatch.setattr(pipeline, "ingest_blocks", lambda path: (
        parse_fasta_block(_text(b)) for b in (b1, b2)))
    eng = PlacementEngine(db, device="cpu")
    cfg = PlacementConfig(device="cpu", batch_size=4)

    def place(out):
        return place_queries(db, q, tmp_path / out, cfg, engine=eng)
    return place, counts


def _outputs(wd):
    return {p.relative_to(wd).as_posix(): p.read_bytes()
            for p in sorted(wd.rglob("*")) if p.is_file()}


def test_counters_hand_counted(two_blocks, traced):
    place, counts = two_blocks
    out = place("on")
    c = utils.trace_totals()["counters"]
    assert {n: c.get(n, 0) for n in counts} == counts
    assert c["engine.batches"] == counts["place.batches"]
    doc = json.loads(out.read_text())
    nm = {p["nm"][0][0]: [h for h, _ in p["nm"][1:]]
          for p in doc["placements"]}
    assert nm["u1 x"] == ["d1", "d3"] and nm["u2 x"] == ["d2"]
    assert nm["u39 x"] == ["d4"] and nm["v0 x"] == ["v1"]
    assert "u0 x" not in nm
    notplaced = (out.parent / "logs" / "notplaced_q.fasta.tsv").read_text()
    assert notplaced.split("\n")[:2] == ["u0 x", "d0 x"]
    # every batch folded once; formatted lines used or re-rendered once
    assert sum(c.get("jplace.lines_" + n, 0) for n in
               ("reused", "rerendered", "late")) == counts["place.batches"]


def test_outputs_identical_on_and_off(two_blocks, tmp_path):
    place, _ = two_blocks
    place("off")
    utils.tracing(True)
    try:
        place("on")
    finally:
        utils.tracing(False)
        utils.trace_reset()
    off, on = _outputs(tmp_path / "off"), _outputs(tmp_path / "on")
    assert set(off) == {"placements_q.fasta.jplace",
                        "logs/placements_q.fasta.tsv",
                        "logs/notplaced_q.fasta.tsv"}
    assert on == off


def test_main_thread_spans_cover_the_call(two_blocks, traced):
    place, _ = two_blocks
    for i in range(3):
        place(f"c{i}")
    sp = utils.trace_totals()["spans"]
    call = sp["place.call"]
    assert call["count"] == 3
    # the main thread's steps, each once (place.dedup holds the waits and
    # folds of the batches it submits, place.fold its result_wait): what
    # they leave uncovered is place.call's self time
    covered = sum(sp[n]["self_s"] for n in MAIN) + \
        sp["place.result_wait"]["total_s"]
    assert covered == pytest.approx(call["total_s"] - call["self_s"],
                                    rel=1e-6)
    assert covered >= 0.9 * call["total_s"]
    for n in ("place.read", "place.format", "engine.score_async",
              "engine.encode", "engine.inputs", "engine.stage",
              "engine.launch", "engine.fetch", "engine.sync",
              "engine.unpack", "place.result_wait"):
        assert sp[n]["count"] > 0, n


def test_profile_trace_holds_the_spans(tmp_path):
    _tiny_db().save(tmp_path / "db.rptpu")
    rng = np.random.default_rng(2)
    reads = [_rand(rng) for _ in range(12)]
    (tmp_path / "q.fasta").write_text(
        "".join(f">r{i}\n{reads[i % 12]}\n" for i in range(30)))
    try:
        assert port_main(["-p", "p", "-d", str(tmp_path / "db.rptpu"),
                          "-q", str(tmp_path / "q.fasta"), "--device",
                          "cpu", "-w", str(tmp_path / "w"),
                          "--batch-size", "4", "--profile",
                          str(tmp_path / "trace")]) == 0
    finally:
        utils.tracing(False)
        utils.trace_reset()
    trace, = (tmp_path / "trace").glob("*.pt.trace.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    call, = [e for e in events if e["name"] == "place.call"]
    folds = [e for e in events if e["name"] == "place.fold"]
    assert len(folds) == 3
    for f in folds:
        assert f["tid"] == call["tid"]
        assert call["ts"] <= f["ts"]
        assert f["ts"] + f["dur"] <= call["ts"] + call["dur"]
