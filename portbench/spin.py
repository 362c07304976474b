"""One run of a cell as ``run.py`` runs it, with a fixed pure-Python spin
of ``--spin-ms`` milliseconds on the main thread in each batch handle's
``result()``: a slowdown of the program's own, which the cell's
throughput has to show and not absorb.

    python3 portbench/spin.py --spin-ms 5 --workload <cell> --seed <n> \\
        --seconds <s> --trace 0
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402  (its clock starts here)


class Spin:
    """The engine, with ``seconds`` of spinning before each result."""

    def __init__(self, engine, seconds: float):
        self._engine = engine
        self._seconds = seconds

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def score_async(self, matrix, lengths):
        handle = self._engine.score_async(matrix, lengths)
        seconds = self._seconds

        class Handle:
            def result(self):
                end = time.perf_counter() + seconds
                while time.perf_counter() < end:
                    pass
                return handle.result()
        return Handle()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spin-ms", type=float, required=True)
    args, rest = p.parse_known_args(argv)
    return run.main(rest, engine_wrap=lambda e: Spin(e, args.spin_ms / 1e3))


if __name__ == "__main__":
    sys.exit(main())
