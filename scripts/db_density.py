"""How dense a phylo-kmer DB of the method is: the port's ``-p b`` on a
Jukes-Cantor simulation (``chip_smoke.synthetic_ardir``) of ``--taxa``
taxa x ``--sites`` sites at ``-k``, then one JSON line with the DB's
keys (and their share of the 4^k), postings (a key's mean and median)
and the share of postings in keys with more than 8 (past the postings
layout's light width: ``resolve_table``'s heavy-dominated test):

    python3 scripts/db_density.py --taxa 150 --sites 1500 -k 10 --seed 0
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--taxa", type=int, required=True)
    p.add_argument("--sites", type=int, required=True)
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from chip_smoke import synthetic_ardir
    from rappas_tpu_torch import cli
    from rappas_tpu_torch.db import PhyloKmerDB

    with tempfile.TemporaryDirectory(prefix="db_density_") as wd:
        wd = Path(wd)
        align, tree, ar = synthetic_ardir(wd / "syn", args.taxa,
                                          args.sites, args.seed)
        t0 = time.perf_counter()
        rc = cli.main(["-p", "b", "-r", str(align), "-t", str(tree),
                       "-b", "/fake/raxml-ng", "--ardir", str(ar),
                       "-w", str(wd / "db"), "-k", str(args.k)])
        build_s = time.perf_counter() - t0
        if rc:
            return rc
        db = PhyloKmerDB.load(next((wd / "db").glob("DB_k*.rptpu")))
    lens = np.diff(db.offsets)
    print(json.dumps({
        "taxa": args.taxa, "sites": args.sites, "k": args.k,
        "seed": args.seed, "n_edge_slots": db.n_edge_slots,
        "keys": db.n_kmers, "keys_share": db.n_kmers / 4 ** args.k,
        "postings": db.nnz, "per_key_mean": float(lens.mean()),
        "per_key_median": float(np.median(lens)),
        "heavy_share": float(lens[lens > 8].sum() / max(db.nnz, 1)),
        "build_s": build_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
