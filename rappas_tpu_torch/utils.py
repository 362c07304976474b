"""Logging / timing utilities.

Replaces the reference's verbosity-gated ``Infos.println``
(``/root/reference/src/etc/Infos.java``): verbosity -1 silences
everything, 0 prints progress, 1 prints debug detail.
"""

from __future__ import annotations

import sys
import time

VERBOSITY = 0


def set_verbosity(v: int) -> None:
    global VERBOSITY
    VERBOSITY = v


def log(msg: str, level: int = 0) -> None:
    if VERBOSITY >= level:
        print(msg, file=sys.stderr if level > 0 else sys.stdout)


class Timer:
    def __init__(self, label: str = ""):
        self.label = label

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        if self.label:
            log(f"{self.label}: {self.elapsed * 1000:.1f} ms", level=1)
