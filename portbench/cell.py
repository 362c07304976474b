"""One run of one cell: set-up, the measured window, the trace, the work
count and the judgement of what the window wrote.

Everything the cell needs is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json``, ``recipes/<recipe>.py``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.  The program is driven as ``rappas_tpu_torch``'s
CLI drives it for ``-p p -q a.fasta,b.fasta,...``: one DB loaded with
``PhyloKmerDB.load``, one engine from ``cli._make_engine``, and
``place_queries`` called back to back over the sample files.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import shutil
import time
from pathlib import Path

import numpy as np

from portbench import reference, roofline, traffic
from portbench.probe import EngineProbe

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the alphabets the reference implements (ACGT with N, 4 states)
STATES = {"nucl"}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(cell_name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix, limits and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf_entry = confs[cell["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{cell_name}.json").read_text())
    if config["states"] not in STATES:
        raise SystemExit(f"configuration {config['name']!r} states "
                         f"{config['states']!r}; the reference and "
                         f"program_db implement {sorted(STATES)} only")
    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}


def star_newick(n_edge_slots: int, branch_len: float) -> str:
    """A star tree of ``n_edge_slots - 1`` leaves (node ids 0..E-1)."""
    return "(" + ",".join(f"L{i}:{branch_len}"
                          for i in range(n_edge_slots - 1)) + ")root;"


def program_db(config: dict, raw: dict):
    """The port's DB of the recipe's raw postings."""
    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    k = config["k"]
    tree = parse_newick(star_newick(config["n_edge_slots"],
                                    config["branch_len"]))
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, config["omega"], 4)
    keys, offsets, e, deltas = build_csr(raw["codes"], raw["edges"],
                                         raw["scores"], thr)
    return PhyloKmerDB(k=k, omega=config["omega"], alphabet=DNA,
                       thr_log10=thr, tree=tree, keys=keys, offsets=offsets,
                       edges=e, deltas=deltas)


def _cpu_times() -> dict:
    """This process's CPU seconds, for the window's record: where they
    stay while the rate falls, the host's cores ran slower."""
    import os
    t = os.times()
    return {"proc_user": t.user, "proc_sys": t.system}


def _host_stat() -> dict:
    """The host's load averages and its CPU ticks (``/proc``), where it
    has them: diagnostics of the run's line, not metrics."""
    out: dict = {}
    try:
        with open("/proc/loadavg") as f:
            out["loadavg"] = [float(x) for x in f.read().split()[:3]]
        with open("/proc/stat") as f:
            out["ticks"] = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        pass
    return out


def _host_window(a: dict, b: dict) -> dict:
    """Load averages as the window opens and closes, the host's CPU
    ticks in the window, their busy, iowait and steal shares (None where
    the host counts none), and the CPUs this process may run on."""
    import os
    out = {"loadavg_open": a.get("loadavg"),
           "loadavg_close": b.get("loadavg"),
           "cpus": len(os.sched_getaffinity(0))}
    if "ticks" in a and "ticks" in b:
        # user nice system idle iowait irq softirq steal (guest time is
        # in user already)
        d = [y - x for x, y in zip(a["ticks"], b["ticks"])][:8]
        total = sum(d)
        out["ticks"] = total
        for name, n in (("busy_share", total - d[3] - d[4]),
                        ("iowait_share", d[4]),
                        ("steal_share", d[7] if len(d) > 7 else None)):
            out[name] = n / total if total and n is not None else None
    return out


def _sync(torch, device: str) -> None:
    if device == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def run(spec: dict, seed: int, seconds: float, trace: bool, workdir: Path,
        t_start: float, device: str = "cuda", precision: str | None = None,
        engine_wrap=None) -> dict:
    """One run, at the configuration's precision unless ``precision``
    names another (a control's).  ``engine_wrap`` (tests) wraps the
    engine the window drives.

    A traced run turns the program's spans on from set-up to the
    window's close, where the program has them: ``setup_spans`` are
    set-up's totals, ``spans`` and ``counters`` the window's."""
    import torch

    from rappas_tpu_torch import cli, utils
    from rappas_tpu_torch.db import PhyloKmerDB
    from rappas_tpu_torch.place.pipeline import PlacementConfig, place_queries

    config, mix, cell = spec["config"], spec["mix"], spec["cell"]
    precision = precision or config["precision"]
    out: dict = {"seed": seed, "cell": cell["name"]}
    stages = out["setup_stages"] = {"imports": time.time() - t_start}
    spans = trace and hasattr(utils, "trace_totals")
    if spans:
        utils.tracing(True)

    def stage(name):
        stages[name] = time.time() - t_start - sum(stages.values())

    recipe = load_module(HERE / "recipes" / f"{config['recipe']}.py",
                         f"portbench_recipe_{config['recipe']}")
    raw = recipe.make(config, seed)
    stage("recipe")
    db_path = workdir / "db.rptpu"
    program_db(config, raw).save(db_path)
    gc.collect()
    stage("db_build_save")
    db = PhyloKmerDB.load(db_path)
    stage("db_load")

    # the CLI's own flags and PlacementConfig (cli._place_all)
    args = cli.build_parser().parse_args(
        ["-p", "p", "-d", str(db_path), "-q", "pool", "-w", str(workdir),
         "--device", device, "--dp", str(cell["chips"]),
         "--precision", precision])
    cfg = PlacementConfig(
        keep_at_most=args.keep_at_most, keep_factor=args.keep_factor,
        guppy_compatible=args.guppy_compat,
        treat_ambiguities=not args.noamb,
        ambiguities_with_max=args.ambwithmax,
        ns_bound=(args.nsbound if args.nsbound is not None
                  else db.meta.get("calibration_ns_bound", float("-inf"))),
        batch_size=args.batch_size, precision=args.precision,
        table=args.table, device=args.device,
        invocation="rappas-tpu-torch portbench", read_shard=None)
    engine = cli._make_engine(db, args, cfg)
    _sync(torch, device)
    stage("engine")
    out["table"] = engine.table
    if engine_wrap is not None:
        engine = engine_wrap(engine)
    probe = EngineProbe(engine)

    pool = traffic.make_pool(mix, seed)
    files = []
    for i, sample in enumerate(pool):
        files.append(workdir / f"s{i}.fasta")
        traffic.write_fasta(sample, files[-1])
    stage("pool")
    place_queries(db, files[0], workdir / "warmup", cfg, engine=probe)
    _sync(torch, device)
    stage("warmup")

    # the window
    out["setup_s"] = time.time() - t_start
    prof = None
    if trace:
        from portbench import trace as tr
        prof = tr.profiler()
        prof.start()
        recorded: dict = {}
    calls, failed = [], None
    order = traffic.call_order(len(files), seed)
    keep = check_picks(mix, seed)
    span = torch.profiler.record_function
    # the harness's set-up garbage is not the window's to collect
    gc.collect()
    gc.freeze()
    if spans:
        out["setup_spans"] = utils.trace_totals()["spans"]
        utils.trace_reset()
    cpu0 = _cpu_times()
    host0 = _host_stat()
    t_w0 = time.perf_counter()
    with span("portbench.window") if trace else contextlib.nullcontext():
        while True:
            s = next(order)
            call_dir = workdir / "calls" / str(len(calls))
            if trace and s not in recorded:
                probe.record = recorded[s] = []
            t0 = time.perf_counter()
            try:
                with (span("portbench.place_queries") if trace
                      else contextlib.nullcontext()):
                    place_queries(db, files[s], call_dir, cfg, engine=probe)
            except Exception as e:           # the run is then not correct
                failed = f"{type(e).__name__}: {e}"
                break
            finally:
                probe.record = None
            t1 = time.perf_counter()
            calls.append((s, t1 - t0, call_dir))
            # a call's files are dropped unless it may be judged (the
            # seed's picks, or the last call): before the page cache
            # writes them back, so a run writes little to disk
            if len(calls) > 1 and len(calls) - 2 not in keep:
                shutil.rmtree(calls[-2][2])
            if t1 - t_w0 >= seconds:
                break
    t_w1 = time.perf_counter()
    out["host"] = _host_window(host0, _host_stat())
    if spans:
        out.update(utils.trace_totals())
        utils.tracing(False)
    out["cpu"] = {k: round(b - a, 3) for (k, a), b in
                  zip(cpu0.items(), _cpu_times().values())}
    gc.unfreeze()
    out["window_s"] = t_w1 - t_w0
    out["calls"] = len(calls) + (failed is not None)
    out["failed"] = int(failed is not None)
    out["failure"] = failed
    out["durations"] = [d for _, d, _ in calls]
    out["call_files"] = [s for s, _, _ in calls]
    out["call_reads"] = [len(pool[s].seqs) for s, _, _ in calls]
    out["reads"] = sum(out["call_reads"])
    n_dev = cell["chips"] if device == "cuda" else 1
    if device == "cuda":
        out["memory_peak_bytes"] = max(torch.cuda.max_memory_allocated(i)
                                       for i in range(n_dev))
    if prof is not None:
        prof.stop()
        path = workdir / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        from portbench import trace as tr
        out["trace"] = tr.read_trace(path, n_dev) if device == "cuda" \
            else None
        path.unlink()
    del engine, probe
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref = reference.Reference(
        config["k"], config["omega"], raw["codes"], raw["edges"],
        raw["scores"], config["n_edge_slots"], cfg.keep_at_most,
        cfg.keep_factor)
    if trace:
        per_file = {s: [roofline.batch_work(ref, m, n) for m, n in b]
                    for s, b in recorded.items()}
        work = [per_file[s] for s, _, _ in calls]
        out["work_bytes"] = sum(b for w in work for b, _ in w)
        out["work_ops"] = sum(o for w in work for _, o in w)
    out["numbers"] = judge_calls(ref, pool, calls, keep, mix)
    return out


#: the calls a run may judge are drawn from the first this many
CHECK_RANGE = 64


def check_picks(mix: dict, seed: int) -> set:
    """The window's calls to judge, drawn from the seed before it opens:
    ``check_calls`` of its first ``CHECK_RANGE``."""
    rng = np.random.default_rng([seed, 3])
    return set(rng.choice(CHECK_RANGE, mix["check_calls"],
                          replace=False).tolist())


def judge_calls(ref, pool, calls, keep: set, mix: dict) -> dict:
    """The numbers of the picked calls that the window made, each judged
    by the files it wrote; the last call stands in for picks the window
    did not reach."""
    picked = sorted(c for c in keep if c < len(calls))
    if calls and len(picked) < mix["check_calls"] and \
            len(calls) - 1 not in picked:
        picked.append(len(calls) - 1)
    parts = []
    for c in picked:
        s, _, call_dir = calls[c]
        name = f"s{s}.fasta"
        parts.append(reference.compare(ref, pool[s], *reference.read_outputs(
            call_dir / f"placements_{name}.jplace",
            call_dir / "logs" / f"notplaced_{name}.tsv")))
    numbers = reference.merge_numbers(parts)
    numbers["calls_checked"] = len(picked)
    return numbers


def verdict(numbers: dict, limits: dict, failure) -> tuple:
    """(correct, [(name, value, limit)]): each number at or under its
    limit, at least one call checked, and no call failed."""
    rows = [(name, numbers.get(name, float("nan")), lim)
            for name, lim in limits.items()]
    ok = (failure is None and numbers.get("calls_checked", 0) > 0 and
          all(v <= lim for _, v, lim in rows))
    return ok, rows
