#!/usr/bin/env python3
"""Which table layout places a DB fastest on one card: the measurements
behind ``PlacementEngine.resolve_table`` and the split budgets.

Run from the repository root on a machine with the card and the CUDA
toolkit:

    python3 scripts/layout_sweep.py [--dbs config1,config2,...]
        [--cli-reads 200000] [--reps 3] [--cli-reps 1] [--only LABELS]
        [--batch 8192] [--seed 0] [--json-out F] [--device cuda]

Each DB is made from the seed by a recipe of ``chip_smoke.py`` at its
full size (``config1``, ``config2``, ``config4``, ``config5``,
``config6``), or is ``sparse12`` (``tests/test_torch_compact.py``'s
sparse k=12 DB: 100,000 keys with 4 postings on 300 edge slots) or
``k{K}_occ{X}`` (``chip_smoke.bench_db`` at k=K and occupancy X: 300
edge slots, 5 postings per key; the crossover sweep) or ``k12_E{E}``
(``chip_smoke.k12_db`` on E edge slots).  Every layout whose table fits
the card (``PlacementEngine.table_budget``) is a candidate: ``direct``
and ``compact`` in f32 and, on the configs and ``sparse12``, u16, ``postings``
on one light table and on the light table routed in two parts
(``postings_split``); config 2 adds the direct table in parts
(``direct_split``, D1) and config 5 the two-stage and select paths on two
parts.  For each DB the script reports, per layout:

* ``setup_s`` -- the engine's construction (host table build, upload);
* ``card_mb`` -- the bytes it holds on the card after construction;
* ``engine_reads_per_s`` -- ``--reps`` runs of 10 batches of ``--batch``
  reads back to back through ``score_async``, the layouts taken in turns
  (rep 1 of every layout, then rep 2, ...), with their median and spread;
* ``cli`` -- ``python -m rappas_tpu_torch.cli -p p`` on ``--cli-reads``
  reads (10% duplicates, 1% with an N, 5% short; half from the DB's keys)
  in a process of its own: ``reads_per_s`` over ``cli.main``'s time (DB
  load, engine set-up, placement, output), the process's wall seconds
  and its peak resident set (sampled every 20 ms), ``--cli-reps`` runs with the layouts
  taken in turns;
* ``auto`` -- what ``table="auto"`` picks for the DB under the code run;
* the first batch's first 512 reads of each f32 layout held against the
  first f32 layout's (``chip_smoke.same_placements``: ``|L|`` and edge
  sets identical, scores within 2e-4), u16 layouts against each other
  within 5e-3; config 5 also reports the batch-unique light rows its
  batches produce at 8,192 and 1,024 reads.

The card's name and power limit head the output; ``--json-out`` gets the
whole result after every DB.  With ``--device cpu`` (a rehearsal at tiny
sizes) every number is a CPU number, not a card's.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: a CLI placement in a process of its own, with engine constants set
#: first (the split budgets have no CLI flag); a thread samples its
#: resident set every 20 ms (``/proc`` may lack ``VmHWM``, and
#: ``ru_maxrss`` counts the parent's pages at fork)
CLI = ("import json, os, sys, threading, time\n"
       "PEAK = [0]\n"
       "def rss():\n"
       "    try:\n"
       "        with open('/proc/self/statm') as f:\n"
       "            return int(f.read().split()[1]) * os.sysconf("
       "'SC_PAGE_SIZE')\n"
       "    except (OSError, ValueError, IndexError):\n"
       "        return 0\n"
       "def watch():\n"
       "    while True:\n"
       "        PEAK[0] = max(PEAK[0], rss())\n"
       "        time.sleep(0.02)\n"
       "threading.Thread(target=watch, daemon=True).start()\n"
       "from rappas_tpu_torch.place.engine import PlacementEngine\n"
       "for k, v in json.loads(sys.argv[1]).items():\n"
       "    setattr(PlacementEngine, k, v)\n"
       "from rappas_tpu_torch import cli, utils\n"
       "t0 = time.perf_counter()\n"
       "rc = cli.main(sys.argv[2:])\n"
       "dt = time.perf_counter() - t0\n"
       "peak = max(PEAK[0], rss())\n"
       "counters = utils.trace_totals()['counters']\n"
       "launches = {n[14:]: c for n, c in counters.items()\n"
       "            if n.startswith('kernel.launch.')}\n"
       "print(json.dumps({'seconds': dt, 'peak_rss_mb': peak / 1e6,\n"
       "                  'launches': launches}))\n"
       "sys.exit(rc)\n")


def sparse12_db(seed: int):
    """``tests/test_torch_compact.py``'s sparse k=12 DB at its test size:
    100,000 random 12-mers with 4 postings each on 300 edge slots."""
    import numpy as np

    from rappas_tpu_torch.alphabet import DNA
    from rappas_tpu_torch.db import PhyloKmerDB, build_csr
    from rappas_tpu_torch.tree import parse_newick

    n_edges, n_keys, k = 300, 100_000, 12
    rng = np.random.default_rng(seed)
    labels = ",".join(f"L{i}:0.1" for i in range(n_edges - 1))
    tree = parse_newick(f"({labels})root;")
    tree.reset_jplace_edge_ids()
    thr = PhyloKmerDB.threshold(k, 1.5, 4)
    keys = np.unique(rng.integers(0, 4 ** k, int(n_keys * 1.1),
                                  np.int64))[:n_keys]
    codes = np.repeat(keys, 4)
    edges = rng.integers(1, n_edges, codes.size).astype(np.int32)
    scores = (thr + 0.01 + rng.random(codes.size) * 2.0).astype(np.float32)
    keys, offsets, e, deltas = build_csr(codes, edges, scores, thr)
    return PhyloKmerDB(k=k, omega=1.5, alphabet=DNA, thr_log10=thr,
                       tree=tree, keys=keys, offsets=offsets, edges=e,
                       deltas=deltas)


RECIPES = {"config1": cs.config1_db, "config2": cs.config2_db,
           "config4": cs.config4_db, "config5": cs.config5_db,
           "config6": cs.config6_db, "sparse12": sparse12_db}


def make_db(name: str, seed: int):
    m = re.fullmatch(r"k(\d+)_occ([0-9.]+)", name)
    if m:
        return cs.bench_db(seed, int(m.group(1)), float(m.group(2)))
    m = re.fullmatch(r"k12_E(\d+)", name)
    if m:
        return cs.k12_db(seed, int(m.group(1)))
    return RECIPES[name](seed)


def table_bytes(db) -> dict:
    """The bytes of each layout's tables (f32 unless named u16)."""
    import numpy as np
    S, E = db.alphabet.n_states, db.n_edge_slots
    lens = np.diff(db.offsets)
    nl, nh = int((lens <= 8).sum()), int((lens > 8).sum())
    return {"direct": (S ** db.k + 1) * E * 4,
            "compact": (db.n_kmers + 1) * E * 4,
            "light": (nl + 1) * 64, "heavy": (nh + 1) * E * 4,
            "light_share": float(lens[lens <= 8].sum() / max(db.nnz, 1))}


def layouts(name: str, db, budget: int) -> list:
    """(label, engine keyword arguments, engine constants) of every
    layout whose tables fit ``budget``."""
    sizes = table_bytes(db)
    one = {"LIGHT_PART_BYTES": 1 << 62}
    two = {"LIGHT_PART_BYTES": sizes["light"] // 2 + 64}
    out = []
    # the sweeps' DBs in f32 only
    sweep = name.startswith(("k1", "k9"))
    for prec, item in (("f32", 4),) + (() if sweep else (("u16", 2),)):
        if (db.alphabet.n_states ** db.k < 2 ** 31 - 1 and
                sizes["direct"] * item // 4 <= budget):
            out.append((f"direct_{prec}", {"table": "direct",
                                           "precision": prec}, {}))
        if sizes["compact"] * item // 4 <= budget:
            out.append((f"compact_{prec}", {"table": "compact",
                                            "precision": prec}, {}))
    out.append(("postings", {"table": "postings"}, one))
    out.append(("postings_split", {"table": "postings"}, two))
    if name == "config2":
        out.append(("direct_split", {"table": "direct"},
                    {"DIRECT_SPLIT_MIN": 0,
                     "DIRECT_PART_BYTES": sizes["direct"] // 2 + 64}))
    if name == "config5":
        out.append(("postings_two_stage", {"table": "postings"},
                    dict(two, _routed=False)))
        out.append(("postings_select", {"table": "postings"},
                    dict(two, TWO_STAGE_MAX_UNIQUE=0, MIN_SPLIT_B=1 << 20,
                         _routed=False)))
    # the u16 layouts last: a u16 result is held against the first one
    return sorted(out, key=lambda lay: lay[1].get("precision") == "u16")


def engine_of(db, device: str, kw: dict, consts: dict):
    from rappas_tpu_torch.place.engine import PlacementEngine
    consts = dict(consts)
    routed = consts.pop("_routed", True)
    cls = type("Sweep", (PlacementEngine,), consts)
    eng = cls(db, device=device, **kw)
    if not routed:
        eng.enable_routed_windows(False)
    return eng


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_engine(eng, batches, device: str) -> float:
    """Reads per second of ``batches`` back to back (a few in flight)."""
    sync(device)
    t0 = time.perf_counter()
    pend, n = [], 0
    for mat, lens in batches:
        pend.append(eng.score_async(mat, lens))
        n += mat.shape[0]
        if len(pend) > 3:
            pend.pop(0).result()
    for p in pend:
        p.result()
    sync(device)
    return n / (time.perf_counter() - t0)


def unique_rows(eng, batches, batch: int) -> list:
    """Batch-unique light rows (the two-stage table's height) of
    ``batches`` cut into batches of ``batch`` reads."""
    import numpy as np
    out = []
    for mat, lens in batches:
        for lo in range(0, mat.shape[0], batch):
            m, ln = mat[lo:lo + batch], lens[lo:lo + batch]
            host, _ = eng.postings_inputs(eng.encode_batch(m), m, ln)
            out.append(int(np.unique(host["lrows"]).size))
    return out


def write_reads(path: Path, rng, n_reads: int, ref, length: int,
                letters: bytes) -> None:
    """``chip_smoke.cli_phase``'s read file: 10% duplicates, 1% with an
    N (X), 5% short, half sampled from ``ref``."""
    import numpy as np
    n_unique = n_reads - n_reads // 10
    mat, lens = cs.random_reads(rng, n_unique, n_unique // 100, 0.05,
                                length, letters, ref)
    src = np.concatenate([np.arange(n_unique),
                          rng.integers(0, n_unique, n_reads - n_unique)])
    with open(path, "wb") as f:
        for i, s in enumerate(src.tolist()):
            f.write(b">r%d\n" % i + mat[s, :lens[s]].tobytes() + b"\n")


def run_cli(db_path: Path, reads: Path, work: Path, label: str, kw: dict,
            consts: dict, device: str) -> dict:
    consts = {k: v for k, v in consts.items() if not k.startswith("_")}
    argv = ["-p", "p", "-d", str(db_path), "-q", str(reads),
            "-w", str(work / f"cli_{label}"), "--device", device,
            "--table", kw["table"],
            "--precision", kw.get("precision", "f32")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI, json.dumps(consts), *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    cs.check(proc.returncode == 0,
             f"CLI {label} exited with {proc.returncode}: {err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    return dict(res, process_s=wall)


def sweep_db(name: str, args, work: Path) -> dict:
    import numpy as np
    import torch

    from rappas_tpu_torch.place.engine import PlacementEngine

    t0 = time.perf_counter()
    db = make_db(name, args.seed)
    db_path = work / f"{name}.rptpu"
    db.save(db_path)
    gen_s = time.perf_counter() - t0
    dev = torch.device(args.device)
    budget = PlacementEngine.table_budget(dev)
    protein = db.alphabet.name != "nucl"
    length = 100 if protein else cs.READ_LEN
    letters = cs.PROTEIN if protein else b"ACGT"
    ref = (cs.config5_reference(args.seed) if name in ("config5", "config6")
           else cs.key_chain(db, args.seed))
    sizes = table_bytes(db)
    out = {"k": db.k, "E": db.n_edge_slots, "kmers": db.n_kmers,
           "postings": db.nnz, "gen_s": gen_s, "table_bytes": sizes,
           "budget": budget, "auto": {}, "layouts": {}}
    for p in ("f32", "u16"):
        try:
            out["auto"][p] = PlacementEngine.resolve_table(db, "auto", p,
                                                           budget)
        except ValueError:          # no u16 table fits
            out["auto"][p] = None
    print(f"{name}: k={db.k} E={db.n_edge_slots} {db.n_kmers} k-mers "
          f"{db.nnz} postings, tables {json.dumps(sizes)}, auto "
          f"{out['auto']} ({gen_s:.1f} s)", flush=True)
    rng = np.random.default_rng(args.seed + 2)
    batches = [cs.random_reads(rng, args.batch, args.batch // 100, 0.05,
                               length, letters, ref)
               for _ in range(args.batches)]
    lays = [lay for lay in layouts(name, db, budget)
            if not args.only or lay[0] in args.only.split(",")]
    engines = {}
    for label, kw, consts in lays:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = engine_of(db, args.device, kw, consts)
        sync(args.device)
        setup = time.perf_counter() - t0
        mb = ((torch.cuda.memory_allocated() - base) / 1e6
              if dev.type == "cuda" else None)
        eng.score(*batches[0])          # warm-up
        engines[label] = eng
        out["layouts"][label] = {
            "table": eng.table, "precision": eng.precision,
            "light_parts": len(eng.light_parts),
            "direct_parts": len(eng.direct_parts or ()),
            "setup_s": setup, "card_mb": mb, "engine_reads_per_s": []}
        print(f"  {label}: set-up {setup:.2f} s, {mb} MB on the card",
              flush=True)
    # placements of the first batch's first 512 reads, layout against
    # layout
    mat, lens = batches[0]
    first = {}
    for label, eng in engines.items():
        r = eng.score(mat[:512], lens[:512])
        key = "u16" if eng.precision == "u16" else "f32"
        if key in first:
            diff = cs.same_placements(r, first[key][1],
                                      2e-4 if key == "f32" else 5e-3,
                                      1e-4 if key == "f32" else None)
            cs.check(diff is None, f"{name} {label} vs {first[key][0]}: "
                     f"{diff}")
        else:
            first[key] = (label, r)
    if name == "config5":
        eng = engines["postings"]
        out["unique_rows"] = {
            "batch_8192": unique_rows(eng, batches, 8192),
            "batch_1024": unique_rows(eng, batches[:2], 1024)}
    for _ in range(args.reps):
        for label, eng in engines.items():
            out["layouts"][label]["engine_reads_per_s"].append(
                run_engine(eng, batches, args.device))
    del eng
    engines.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for r in out["layouts"].values():
        v = r["engine_reads_per_s"]
        r["engine_median"] = statistics.median(v)
        r["engine_spread"] = (max(v) - min(v)) / statistics.median(v)
    # the CLI, each layout in a process of its own
    reads = work / f"{name}_reads.fasta"
    write_reads(reads, np.random.default_rng(args.seed + 3),
                args.cli_reads, ref, length, letters)
    for _ in range(args.cli_reps):
        for label, kw, consts in lays:
            if "_routed" in consts:
                continue     # no CLI run turns the routed windows off
            cl = run_cli(db_path, reads, work, label, kw, consts,
                         args.device)
            runs = out["layouts"][label].setdefault("cli_runs", [])
            runs.append(dict(cl, reads_per_s=args.cli_reads /
                             cl["seconds"]))
            out["layouts"][label]["cli"] = {
                "reads_per_s": statistics.median(
                    r["reads_per_s"] for r in runs),
                "peak_rss_mb": max(r["peak_rss_mb"] for r in runs)}
    for label, r in out["layouts"].items():
        cli = r.get("cli", {}).get("reads_per_s")
        print(f"  {label}: engine {r['engine_median']:.0f} reads/s "
              f"(spread {r['engine_spread']:.1%}), CLI {cli} reads/s, "
              f"set-up {r['setup_s']:.2f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dbs", default="config1,config2,k10_occ0.01,"
                    "k10_occ0.2,k10_occ0.6,k10_occ1.0,k9_occ0.05,"
                    "k11_occ0.01,config4,sparse12,k12_E1000,config6,"
                    "config5")
    ap.add_argument("--cli-reads", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cli-reps", type=int, default=1)
    ap.add_argument("--only", default="",
                    help="comma-separated layout labels (default: all)")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("layout_sweep: no CUDA device", file=sys.stderr)
            return 1
        card = cs.card_line()
        props = torch.cuda.get_device_properties(0)
        head = {"card": card, "total_memory": props.total_memory,
                "torch": torch.__version__, "cuda": torch.version.cuda}
        from rappas_tpu_torch import _kernels
        _kernels.lib()
    else:
        head = {"card": "cpu (a rehearsal: no card numbers)"}
    print(json.dumps(head), flush=True)
    results = {"head": head, "args": vars(args), "dbs": {}}
    with tempfile.TemporaryDirectory(prefix="layout_sweep_") as tmp:
        for name in args.dbs.split(","):
            results["dbs"][name] = sweep_db(name, args, Path(tmp))
            if args.json_out:
                Path(args.json_out).parent.mkdir(parents=True,
                                                 exist_ok=True)
                Path(args.json_out).write_text(json.dumps(results,
                                                          indent=1))
    print(json.dumps({"ok": True, **head}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"layout_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
