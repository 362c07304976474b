"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""

import json
import re

import pytest

from portbench import cell

BENCH = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert len((cell.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] +
             [w["name"] for w in BENCH["workloads"]] +
             [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]


def test_every_name_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        conf = json.loads((cell.ROOT / configs[w["config"]]["file"])
                          .read_text())
        assert (cell.HERE / "recipes" / f"{conf['recipe']}.py").exists()
        assert (cell.HERE / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((cell.HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v >= 0 for v in limits.values())
        assert w["chips"] in (1, 4)
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert used == set(configs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (cell.HERE / "metrics" / f"{m['name']}.py").exists()


def test_metrics_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_four_chip_cells_and_run_length_fit():
    cells = BENCH["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    secs = BENCH["run_seconds"]
    assert 1 <= secs <= 51
    # a full check of 24 cells (14 runs each, 180 s of compiling) fits
    # in 43,200 seconds
    assert (2 + 14 * 24) * (secs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/configs/")
    conf = json.loads((cell.ROOT / c["file"]).read_text())
    assert conf["reduced"] == c["reduced"]
    for key in ("source", "assumed", "k", "n_edge_slots", "precision"):
        assert key in conf


def test_unknown_states_are_refused(tmp_path):
    conf = json.loads((cell.HERE / "configs" / "c1-16s-k8.json").read_text())
    conf["states"] = "amino"
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "c1-16s-k8.json").write_text(
        json.dumps(conf))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    with pytest.raises(SystemExit, match="amino"):
        cell.load_spec(BENCH["workloads"][0]["name"], root=tmp_path)
