"""The trace reader on a canned trace, and the roofline's work count on a
hand-counted batch and across the layouts of one DB."""

import json

import numpy as np
import pytest

from portbench import reference, roofline
from portbench.probe import EngineProbe
from portbench.tests import tiny
from portbench.trace import innermost, read_trace


def _x(name, cat, ts, dur, tid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_read_trace_canned(tmp_path):
    events = [
        _x("portbench.window", "user_annotation", 1000, 1000, tid=1),
        _x("portbench.place_queries", "user_annotation", 1000, 1000, tid=1),
        _x("place.call", "user_annotation", 1000, 900, tid=1),
        _x("place.fold", "user_annotation", 1250, 200, tid=1),
        _x("place.result_wait", "user_annotation", 1300, 120, tid=1),
        # another thread's span names no idle time
        _x("place.format", "user_annotation", 1500, 500, tid=2),
        _x("memset", "gpu_memset", 900, 200, device=0),
        _x("kernA", "kernel", 1100, 120, device=0, correlation=1),
        _x("kernB", "kernel", 1150, 100, device=0, correlation=2),
        _x("Memcpy HtoD", "gpu_memcpy", 1500, 50, device=0),
        _x("kernA", "kernel", 2500, 100, device=0, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 1090, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1140, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1600, 5, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_trace(path, 1)
    # busy: memset clipped to 1000-1100, kernels 1100-1250, copy 1500-1550
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(300e-6)
    assert t["idle_share"] == pytest.approx(0.7)
    assert t["kernel_s"] == pytest.approx(220e-6)
    assert t["lost_kernel_records"] == 1
    assert t["device_ops"][0] == ["kernA", pytest.approx(120e-6)]
    # idle 1550-2000: place.call to 1900, then no program span; idle
    # 1250-1500: fold 50 + 30, result_wait 120, place.call 50
    assert t["idle_gaps"][0] == ["place.call", pytest.approx(450e-6)]
    assert t["idle_gaps"][1] == ["place.result_wait", pytest.approx(250e-6)]
    assert dict(t["idle_by_span"]) == {
        "place.call": pytest.approx(400e-6),
        "place.result_wait": pytest.approx(120e-6),
        "harness": pytest.approx(100e-6),
        "place.fold": pytest.approx(80e-6)}
    assert t["idle_s"] == pytest.approx(700e-6)


def test_innermost_cuts_a_child_at_its_parents_end():
    pieces = innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                        (8, 11, "d"), (12, 13, "e")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 8, "a"),
                      (8, 10, "d"), (12, 13, "e")]


def _hand_ref():
    # k=2, E=5: AA has 2 postings, AC 1, CA 3
    codes = np.array([0, 0, 1, 4, 4, 4])
    edges = np.array([1, 2, 3, 1, 2, 4])
    return reference.Reference(2, 1.5, codes, edges,
                               np.full(6, -0.5, np.float32), 5)


def test_batch_work_hand_counted():
    ref = _hand_ref()
    mat = np.full((3, 4), 0xFF, np.uint8)
    mat[0, :3] = np.frombuffer(b"AAC", np.uint8)
    mat[1, :3] = np.frombuffer(b"ANA", np.uint8)
    nbytes, ops = roofline.batch_work(ref, mat, np.array([3, 3, 0]))
    # rows AA, AC, CA once: 6 postings x 8 B; 2 reads x 1 B of bases;
    # 2 reads x 7 candidates x (4 + 2) B
    assert nbytes == 6 * 8 + 2 + 2 * 7 * 6
    # AAC: AA 2 + AC 1; ANA: AN -> AA 2 + AC 1, NA -> AA 2 + CA 3, x3
    assert ops == 3 + 3 * 8


def _recorded_work(db, ref, sample_path, table, tmp):
    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.pipeline import (PlacementConfig,
                                                 place_queries)
    eng = PlacementEngine(db, table=table, device="cpu")
    probe = EngineProbe(eng)
    probe.record = []
    place_queries(db, sample_path, tmp / table,
                  PlacementConfig(device="cpu", table=table), engine=probe)
    assert eng.table == table and probe.record
    return [roofline.batch_work(ref, m, n) for m, n in probe.record]


@pytest.mark.parametrize("name,auto", [(n, "compact") for n in tiny.CELLS])
def test_work_is_the_same_on_every_layout(name, auto, tmp_path):
    from portbench import cell, traffic
    from rappas_tpu_torch.place.engine import PlacementEngine

    s = tiny.spec(name)
    conf = s["config"]
    recipe = cell.load_module(cell.HERE / "recipes" / f"{conf['recipe']}.py",
                              "r")
    raw = recipe.make(conf, 2)
    db = cell.program_db(conf, raw)
    ref = reference.Reference(conf["k"], conf["omega"], raw["codes"],
                              raw["edges"], raw["scores"],
                              conf["n_edge_slots"])
    assert PlacementEngine.resolve_table(
        db, "auto", "f32", PlacementEngine.CARD_MEMORY_BYTES // 2) in \
        ("compact", auto)
    sample = traffic.make_pool(s["mix"], 3)[0]
    path = tmp_path / "s.fasta"
    traffic.write_fasta(sample, path)
    works = {t: _recorded_work(db, ref, path, t, tmp_path)
             for t in ("compact", "postings", "direct")}
    assert works["compact"] == works["postings"] == works["direct"]
    assert all(b > 0 and o > 0 for b, o in works["compact"])
