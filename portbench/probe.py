"""A thin proxy around the placement engine that ``place_queries`` is
handed: it times ``score_async`` (on the pipeline's prep thread) and
the handles' ``result()`` (the main thread blocked on the engine), and
can keep copies of the batches for the roofline's work count.  Every
other attribute is the engine's."""

from __future__ import annotations

import contextlib
import time


class EngineProbe:
    def __init__(self, engine, spans: bool = False):
        self._engine = engine
        self._spans = spans
        #: a list to append each batch's (reads, lengths) to, or None
        self.record = None
        self.reset()

    def reset(self) -> None:
        self.batches = 0
        self.score_s = 0.0
        self.wait_s = 0.0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _span(self, name):
        if not self._spans:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def score_async(self, matrix, lengths):
        t0 = time.perf_counter()
        with self._span("portbench.score_async"):
            handle = self._engine.score_async(matrix, lengths)
        self.score_s += time.perf_counter() - t0
        self.batches += 1
        if self.record is not None:
            self.record.append((matrix.copy(), lengths.copy()))
        return _Handle(handle, self)


class _Handle:
    def __init__(self, handle, probe: EngineProbe):
        self._handle = handle
        self._probe = probe

    def result(self):
        t0 = time.perf_counter()
        with self._probe._span("portbench.result_wait"):
            out = self._handle.result()
        self._probe.wait_s += time.perf_counter() - t0
        return out
