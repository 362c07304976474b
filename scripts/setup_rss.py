"""A ``portbench`` run with its peak host memory: runs
``portbench/run.py``'s ``main`` in this process with the arguments given
and prints, after the run's own lines,

    setup_rss: {"recipe_gib": ..., "db_build_gib": ..., "db_load_gib": ...,
                "engine_gib": ..., "run_gib": ...}

the process's peak resident set (``ru_maxrss``, in GiB) as each step of
set-up ends: the recipe's raw postings drawn, the program's DB built from
them (``build_csr``), the DB saved and loaded, the engine made (its
tables built); and at the run's end, the judging included.  The step
whose reading first reaches the peak is the step that set it.  Then

    setup_counters: {"engine.table_bytes": ..., "engine.postings_width": ...,
                     "engine.edge_id_bytes": ...}

the engine's counters as it is made (the harness's window starts its
counters anew): its tables' device bytes and, on the postings layout,
the light width it took and the bytes of an edge id in its light rows
(2 below 65,535 edge slots, else 4).  On the card:

    python3 scripts/setup_rss.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>
"""

import json
import resource
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def peak_gib() -> float:
    """This process's peak resident set so far (Linux: KiB), in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def main() -> int:
    from portbench import cell, run
    from rappas_tpu_torch import cli, utils
    peaks, counters = {}, {}
    program_db, make_engine = cell.program_db, cli._make_engine

    def built(config, raw):
        peaks["recipe_gib"] = peak_gib()
        db = program_db(config, raw)
        peaks["db_build_gib"] = peak_gib()
        return db

    def engine(*args, **kw):
        peaks["db_load_gib"] = peak_gib()
        return make_engine(*args, **kw)

    def at_engine(eng):
        peaks["engine_gib"] = peak_gib()
        counters.update((n, c) for n, c in
                        utils.trace_totals()["counters"].items()
                        if n.startswith("engine."))
        return eng

    cell.program_db, cli._make_engine = built, engine
    rc = run.main(sys.argv[1:], engine_wrap=at_engine)
    peaks["run_gib"] = peak_gib()
    print("setup_rss: " + json.dumps(peaks), flush=True)
    print("setup_counters: " + json.dumps(counters), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
