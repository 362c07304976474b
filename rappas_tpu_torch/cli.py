"""Command-line interface of the port, with the flag surface of
``rappas_tpu/cli.py`` (itself drop-in compatible with the reference
RAPPAS, ``ArgumentsParser_v2.java``) plus ``--device``.

Ported so far: ``-p b`` DB build (from an AR program's run or its
outputs under ``--ardir``; ``--calibration`` scores its random reads on
``--device``, and ``--dbinram -q`` places at once) and ``-p p``
placement in every table layout (``--table auto``, ``direct``,
``compact`` or ``postings``) and both precisions (``--precision f32`` or
``u16``; u16 takes the direct or compact table) on one device, or over a
``--dp`` x ``--mp`` mesh of this host's devices (f32;
:mod:`rappas_tpu_torch.parallel`), on one host or several
(``--num-hosts``, ``--host-id``, ``--coordinator``).  ``--profile DIR``
traces the placement with ``torch.profiler`` (the host with the
program's spans, and the card on ``--device cuda``) into a
``*.pt.trace.json`` under DIR; ``-v 1`` logs each query file's span
totals and counters.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from rappas_tpu_torch import __version__
from rappas_tpu_torch.utils import log, set_verbosity, tracing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rappas-tpu-torch",
        description="alignment-free phylogenetic placement via "
                    "phylo-kmers, on PyTorch and CUDA")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-p", "--phase", required=True, choices=["b", "p"],
                   help="b=build DB, p=place queries")
    p.add_argument("-s", "--states", default="nucl",
                   choices=["nucl", "amino"])
    p.add_argument("-b", "--arbinary", help="path to AR program binary "
                   "(phyml / raxml-ng / baseml / codeml)")
    p.add_argument("-w", "--workdir", default=".",
                   help="working directory")
    p.add_argument("-r", "--refalign", help="reference alignment (fasta)")
    p.add_argument("-t", "--reftree", help="reference tree (newick)")
    p.add_argument("-q", "--queries",
                   help="query reads, comma-separated list of fasta/fastq")
    p.add_argument("-d", "--database", help=".rptpu DB file (placement)")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    # build parameters
    p.add_argument("-k", type=int, default=8, help="k-mer size")
    p.add_argument("--omega", type=float, default=1.5)
    p.add_argument("-g", "--ghosts", type=int, default=1,
                   help="ghost nodes injected per branch")
    p.add_argument("-a", "--alpha", type=float, default=1.0,
                   help="gamma shape parameter")
    p.add_argument("-c", "--categories", type=int, default=4)
    p.add_argument("-m", "--model", default=None,
                   help="substitution model (default GTR / LG)")
    p.add_argument("--arparameters", default=None,
                   help="override AR command-line parameters")
    p.add_argument("--dbfilename", default=None)
    p.add_argument("--no-reduction", action="store_true")
    p.add_argument("--ratio-reduction", type=float, default=0.99)
    p.add_argument("--write-reduction", default=None,
                   help="path for the reduced alignment copy")
    p.add_argument("--ardir", default=None,
                   help="reuse AR outputs from this directory")
    p.add_argument("--aronly", action="store_true")
    p.add_argument("--arinputonly", action="store_true")
    p.add_argument("--force-root", action="store_true")
    p.add_argument("--use_unrooted", action="store_true")
    p.add_argument("--original-nodes", action="store_true",
                   help="test all internal nodes, not just ghosts")
    p.add_argument("--onlyX1", action="store_true",
                   help="test only X1 ghost nodes")
    p.add_argument("--force-gap-jump", action="store_true")
    p.add_argument("--do-n-jumps", action="store_true",
                   help="allow multiple gap jumps per word")
    p.add_argument("--gap-jumps-thresh", type=float, default=0.3)
    p.add_argument("--jsondb", action="store_true",
                   help="also write a readable JSON DB dump")
    p.add_argument("--threads", type=int, default=1,
                   help="threads forwarded to RAxML-ng")
    p.add_argument("--dbinram", action="store_true",
                   help="build the DB in RAM and place immediately, "
                        "skipping DB file persistence entirely "
                        "(reference contract, Main_DBBUILD_3.java:"
                        "873-986)")
    p.add_argument("--convertUO", action="store_true")
    # reference-compat flags accepted for drop-in CLI parity; behavior
    # documented per flag (ArgumentsParser_v2.java:407-420,421-424,471-474)
    p.add_argument("--extree", default=None, metavar="DIR",
                   help="accepted for reference compatibility: the "
                        "reference reloads a JVM-serialized extended tree "
                        "from DIR; here the extended tree is rebuilt "
                        "deterministically (use --ardir to skip the AR "
                        "run itself)")
    p.add_argument("--dbfull", action="store_true",
                   help="accepted for reference compatibility: the "
                        "reference additionally writes 'medium'/'small' "
                        "reduced DB copies; the union .rptpu DB is "
                        "already complete, so this is a no-op")
    p.add_argument("--poshash", action="store_true",
                   help="accepted for reference compatibility: positional "
                        "(per-ref-position) postings; the reference's "
                        "live hash deprecated this mode to a no-op "
                        "(CustomHash_v4_FastUtil81.java:219-241), union "
                        "mode is always used")
    # placement parameters
    p.add_argument("--keep-at-most", type=int, default=7)
    p.add_argument("--keep-factor", type=float, default=0.01)
    p.add_argument("--nsbound", type=float, default=None)
    p.add_argument("--guppy-compat", action="store_true")
    p.add_argument("--noamb", action="store_true",
                   help="ignore ambiguous k-mers instead of expanding")
    p.add_argument("--ambwithmax", action="store_true",
                   help="combine ambiguity alternatives with max, "
                        "not mean")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--precision", choices=["f32", "u16"], default="f32",
                   help="device score-table precision: f32 = strict "
                        "reference parity, u16 = fixed-point deltas (half "
                        "the table's bytes, error at f32-rounding scale; "
                        "direct or compact table only)")
    p.add_argument("--table",
                   choices=["auto", "direct", "compact", "postings"],
                   default="auto",
                   help="device k-mer table layout (auto: the "
                        "compact table searched on the card while its "
                        "keys fit int32 and it fits 7.3 GB, the layout "
                        "that placed such a DB fastest on an H100; past "
                        "that, for f32, light/heavy postings at width 8 "
                        "for a light-dominated DB, or at the DB's own "
                        "light width when that takes at most a quarter "
                        "of the compact table's bytes, else compact "
                        "(postings at that width when compact does not "
                        "fit the card); "
                        "direct only when asked for)")
    # multi-chip / multi-host placement (no reference analog: the
    # reference is single-threaded, PlacementProcess.java:1239-1241)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis: shard read batches "
                        "over this many devices (0 = auto: all local CUDA "
                        "devices when more than one, else one device)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel mesh axis: shard the phylo-kmer "
                        "table (edge ranges) over this many devices for "
                        "DBs exceeding one device's memory")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="total hosts; each host places its round-robin "
                        "shard of the reads against its own DB copy "
                        "(zero cross-host traffic in the hot loop)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's rank in [0, num-hosts)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="coordinator address of a multi-host run (the "
                        "host of rank 0; the hosts join one "
                        "torch.distributed gloo group there)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the placement "
                        "into DIR (TensorBoard / Perfetto *.pt.trace.json), "
                        "the program's place.* and engine.* spans in it")
    p.add_argument("--calibration", action="store_true",
                   help="calibrate a normalized-score lower bound from "
                        "random sequences at DB build (the reference's "
                        "--calibration is dead code; this is a working "
                        "implementation)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the placement engine (placement, "
                        "--calibration and -p b --dbinram -q): cuda runs "
                        "the CUDA kernels (and fails where no CUDA device "
                        "is present), cpu their plain PyTorch versions "
                        "(a --dp x --mp mesh then repeats the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbosity)
    # the program's spans: in the profiler's trace, and in -v 1's lines
    tracing(bool(args.profile) or args.verbosity >= 1)
    call_string = " ".join(argv if argv is not None else sys.argv[1:])

    if args.extree:
        log("--extree accepted for compatibility: the extended tree is "
            "rebuilt deterministically here (combine with --ardir to "
            "reuse AR outputs)")
    if args.dbfull:
        log("--dbfull accepted for compatibility: the union .rptpu DB "
            "is already complete (no-op)")
    if args.poshash:
        log("--poshash accepted for compatibility: positional mode is a "
            "deprecated no-op in the reference's live hash; union mode "
            "is used")
    if args.phase == "b":
        return run_build(args, call_string)
    return run_placement(args, call_string)


def run_build(args, call_string: str) -> int:
    from rappas_tpu_torch.build.pipeline import BuildConfig, build_database
    from rappas_tpu_torch.models import EvolModel

    if not args.refalign or not args.reftree:
        print("DB build needs -r/--refalign and -t/--reftree",
              file=sys.stderr)
        return 2
    model = (EvolModel.from_string(args.model, args.alpha, args.categories)
             if args.model else None)
    cfg = BuildConfig(
        k=args.k, omega=args.omega, states=args.states,
        ghosts=args.ghosts,
        reduction=not args.no_reduction,
        reduction_ratio=args.ratio_reduction,
        reduced_align_file=args.write_reduction,
        model=model, ar_binary=args.arbinary, ar_dir=args.ardir,
        ar_parameters=args.arparameters, threads=args.threads,
        force_rooting=args.force_root, use_unrooted=args.use_unrooted,
        only_fake_nodes=not args.original_nodes,
        only_x1_nodes=args.onlyX1,
        do_gap_jumps=args.force_gap_jump or args.do_n_jumps,
        limit_to_1_jump=not args.do_n_jumps,
        gap_jump_threshold=args.gap_jumps_thresh,
        only_ar=args.aronly, only_ar_input=args.arinputonly,
        db_filename=args.dbfilename, convert_uo=args.convertUO,
        save_db=not args.dbinram)
    db = build_database(args.refalign, args.reftree, args.workdir, cfg)
    if db is None:
        return 0
    if args.calibration:
        from rappas_tpu_torch.build.calibration import calibrate
        bound = calibrate(db, device=args.device)
        log(f"calibrated noise score bound: {bound}")
        if not args.dbinram:
            # re-save with the calibration in the header (--dbinram
            # keeps the bound in the in-RAM db.meta for the placement
            # below and never writes DB files)
            name = args.dbfilename or f"DB_k{args.k}_o{args.omega}.rptpu"
            if not name.endswith(".rptpu"):
                name += ".rptpu"
            db.save(Path(args.workdir) / name)
    if args.jsondb:
        import json
        dump = Path(args.workdir) / "DB.json"
        with open(dump, "w") as f:
            json.dump(db.to_json_dump(), f, indent=1)
        log(f"JSON DB dump: {dump}")
    if args.dbinram and args.queries:
        _place_all(db, args, call_string)
    return 0


def run_placement(args, call_string: str) -> int:
    from rappas_tpu_torch.db import PhyloKmerDB

    if not args.database or not args.queries:
        print("placement needs -d/--database and -q/--queries",
              file=sys.stderr)
        return 2
    db = PhyloKmerDB.load(args.database)
    if args.convertUO and db.alphabet.name == "amino":
        from rappas_tpu_torch.alphabet import get_alphabet
        db.alphabet = get_alphabet("amino", convert_uo=True)
    _place_all(db, args, call_string)
    return 0


def _make_engine(db, args, cfg):
    """One-device or mesh engine from the --dp/--mp flags.

    The mesh spans this host's LOCAL devices only (on ``--device cpu`` it
    repeats the CPU): reads are sharded across hosts at the stream level
    (each host places its own shard and rank 0 merges the jplace parts),
    so dp/mp parallelise within the host, read sharding across hosts."""
    import torch

    n_dev = torch.cuda.device_count() if cfg.device == "cuda" else 1
    dp = args.dp if args.dp else (n_dev if args.mp == 1 and n_dev > 1
                                  else 1)
    mp = args.mp
    if dp * mp <= 1:
        from rappas_tpu_torch.place.engine import PlacementEngine
        return PlacementEngine(
            db, keep_at_most=cfg.keep_at_most,
            treat_ambiguities=cfg.treat_ambiguities,
            ambiguities_with_max=cfg.ambiguities_with_max,
            precision=cfg.precision, table=cfg.table, device=cfg.device)
    if cfg.device == "cuda" and dp * mp > n_dev:
        raise SystemExit(f"--dp {dp} x --mp {mp} needs {dp * mp} "
                         f"devices, only {n_dev} visible")
    from rappas_tpu_torch.parallel.engine import ShardedEngine
    from rappas_tpu_torch.parallel.mesh import make_mesh
    if cfg.precision != "f32":
        log("multi-device placement is f32-only; ignoring --precision")
    if cfg.batch_size % dp:
        cfg.batch_size = -(-cfg.batch_size // dp) * dp
        log(f"batch size rounded up to {cfg.batch_size} "
            f"(multiple of dp={dp})")
    devices = ([torch.device("cuda", i) for i in range(dp * mp)]
               if cfg.device == "cuda" else ["cpu"] * (dp * mp))
    mesh = make_mesh(devices, dp=dp, mp=mp)
    log(f"placement mesh: dp={dp} x mp={mp}")
    return ShardedEngine(
        db, mesh, keep_at_most=cfg.keep_at_most,
        treat_ambiguities=cfg.treat_ambiguities,
        ambiguities_with_max=cfg.ambiguities_with_max, table=cfg.table)


def _place_all(db, args, call_string: str) -> None:
    from rappas_tpu_torch.place.pipeline import (PlacementConfig,
                                                 place_queries)

    joined = False
    if args.coordinator or args.num_hosts > 1:
        from rappas_tpu_torch.parallel.distributed import init_distributed
        pid, n_hosts = init_distributed(
            args.coordinator,
            args.num_hosts if args.coordinator else None,
            args.host_id if args.coordinator else None)
        joined = args.coordinator is not None
        if not args.coordinator:
            pid, n_hosts = args.host_id, args.num_hosts
        read_shard = (pid, n_hosts)
        log(f"multi-host placement: host {pid}/{n_hosts}")
    else:
        read_shard = None

    cfg = PlacementConfig(
        keep_at_most=args.keep_at_most,
        keep_factor=args.keep_factor,
        guppy_compatible=args.guppy_compat,
        treat_ambiguities=not args.noamb,
        ambiguities_with_max=args.ambwithmax,
        ns_bound=(args.nsbound if args.nsbound is not None
                  else db.meta.get("calibration_ns_bound",
                                   float("-inf"))),
        batch_size=args.batch_size,
        precision=args.precision, table=args.table,
        device=args.device,
        invocation=f"rappas-tpu-torch {call_string}",
        read_shard=read_shard)

    def run_all():
        # one engine (device tables + kernels) for all query files
        engine = _make_engine(db, args, cfg)
        for q in args.queries.split(","):
            out = place_queries(db, q, args.workdir, cfg, engine=engine)
            if read_shard is not None:
                _merge_host_parts(out, q, args, read_shard)

    try:
        if args.profile:
            _profiled(run_all, args.profile, args.device)
            log(f"profiler trace written to {args.profile}")
        else:
            run_all()
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _profiled(fn, out_dir: str, device: str) -> None:
    """``fn()`` inside ``torch.profiler.profile`` (host activity, and the
    card's on ``device`` cuda), the trace written into ``out_dir`` as a
    ``*.pt.trace.json`` when it ends (``rappas_tpu/cli.py:325-329`` wraps
    ``jax.profiler.trace`` the same way).  Shapes and stacks are off: a
    trace of a large read file stays small."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False,
                 with_stack=False,
                 on_trace_ready=tensorboard_trace_handler(out_dir)):
        fn()


def _merge_host_parts(part_path, query, args, read_shard) -> None:
    """Rank 0 merges the per-host jplace parts once all hosts wrote
    theirs (a cross-host barrier exists only under --coordinator;
    otherwise parts are left for an offline merge)."""
    from rappas_tpu_torch.parallel.distributed import merge_jplace
    pid, n_hosts = read_shard
    if args.coordinator:
        import torch.distributed as dist
        dist.barrier()
    elif n_hosts > 1:
        log(f"wrote host part {part_path}; merge the parts with "
            "rappas_tpu_torch.parallel.distributed.merge_jplace once all "
            "hosts finished")
        return
    if pid == 0:
        qname = Path(query).name
        parts = [Path(args.workdir) /
                 f"placements_{qname}.jplace.part{i}"
                 for i in range(n_hosts)]
        merged = Path(args.workdir) / f"placements_{qname}.jplace"
        merge_jplace(parts, merged)
        log(f"merged {n_hosts} host parts into {merged}")


if __name__ == "__main__":
    sys.exit(main())
