"""A thin proxy around the placement engine that ``place_queries`` is
handed: it can keep copies of the batches for the roofline's work
count.  Every other attribute is the engine's."""

from __future__ import annotations


class EngineProbe:
    def __init__(self, engine):
        self._engine = engine
        #: a list to append each batch's (reads, lengths) to, or None
        self.record = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def score_async(self, matrix, lengths):
        handle = self._engine.score_async(matrix, lengths)
        if self.record is not None:
            self.record.append((matrix.copy(), lengths.copy()))
        return handle
