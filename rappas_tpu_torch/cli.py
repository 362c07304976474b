"""Command-line interface of the port, with the flag surface of
``rappas_tpu/cli.py`` (itself drop-in compatible with the reference
RAPPAS, ``ArgumentsParser_v2.java``) plus ``--device``.

Ported so far: ``-p p`` placement on one device (``--dp`` 0 or 1, ``--mp``
1) with a DB whose table resolves to the direct layout.  The options
that reach code not ported yet exit with status 2 and name the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import sys

from rappas_tpu_torch import __version__
from rappas_tpu_torch.utils import set_verbosity


class NotPorted(Exception):
    """An option whose code path is not ported yet."""


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
                        "reference parity, u16 = fixed-point (2x faster, "
                        "error at f32-rounding scale)")
    p.add_argument("--table",
                   choices=["auto", "direct", "compact", "postings"],
                   default="auto",
                   help="device k-mer table layout (auto: direct-indexed "
                        "when S^k is small enough, else binary-search "
                        "compact table, else light/heavy postings for "
                        "the large-tree regime)")
    # multi-chip / multi-host placement (no reference analog: the
    # reference is single-threaded, PlacementProcess.java:1239-1241)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis: shard read batches "
                        "over this many devices (0 = auto: all local "
                        "devices when more than one, else single-chip)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel mesh axis: shard the phylo-kmer "
                        "table (edge ranges) over this many devices for "
                        "DBs exceeding one chip's HBM")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="total hosts; each host places its round-robin "
                        "shard of the reads against its own DB copy "
                        "(zero cross-host traffic in the hot loop)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's rank in [0, num-hosts)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (needed on "
                        "multi-host TPU pods; rank 0 then merges the "
                        "per-host jplace parts)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a JAX profiler trace of the placement "
                        "into DIR (view with TensorBoard/Perfetto)")
    p.add_argument("--calibration", action="store_true",
                   help="calibrate a normalized-score lower bound from "
                        "random sequences at DB build (the reference's "
                        "--calibration is dead code; this is a working "
                        "implementation)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the placement engine: cuda runs the "
                        "CUDA kernels (and fails where no CUDA device "
                        "is present), cpu their plain PyTorch versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbosity)
    call_string = " ".join(argv if argv is not None else sys.argv[1:])
    try:
        if args.phase == "b":
            raise NotPorted("-p b (DB build) is not yet ported (ROADMAP "
                            "queue 1 item 2)")
        return run_placement(args, call_string)
    except (NotPorted, NotImplementedError) as e:
        print(f"rappas-tpu-torch: {e}", file=sys.stderr)
        return 2


def _check_ported(args) -> None:
    if args.dp > 1 or args.mp > 1:
        raise NotPorted("--dp/--mp above 1 (multi-device placement) is "
                        "not yet ported (ROADMAP queue 1 item 7)")
    if args.coordinator or args.num_hosts > 1:
        raise NotPorted("--coordinator/--num-hosts (multi-host "
                        "placement) is not yet ported (ROADMAP queue 1 "
                        "item 7)")
    if args.profile:
        raise NotPorted("--profile is not yet ported (ROADMAP queue 1 "
                        "item 8)")


def run_placement(args, call_string: str) -> int:
    from rappas_tpu_torch.db import PhyloKmerDB
    from rappas_tpu_torch.place.engine import PlacementEngine
    from rappas_tpu_torch.place.pipeline import (PlacementConfig,
                                                 place_queries)

    if not args.database or not args.queries:
        print("placement needs -d/--database and -q/--queries",
              file=sys.stderr)
        return 2
    _check_ported(args)
    db = PhyloKmerDB.load(args.database)
    if args.convertUO and db.alphabet.name == "amino":
        from rappas_tpu_torch.alphabet import get_alphabet
        db.alphabet = get_alphabet("amino", convert_uo=True)
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
        invocation=f"rappas-tpu-torch {call_string}")
    # one engine (device table + kernels) for all query files
    engine = PlacementEngine(
        db, keep_at_most=cfg.keep_at_most,
        treat_ambiguities=cfg.treat_ambiguities,
        ambiguities_with_max=cfg.ambiguities_with_max,
        precision=cfg.precision, table=cfg.table, device=cfg.device)
    for q in args.queries.split(","):
        place_queries(db, q, args.workdir, cfg, engine=engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
