"""pipeline.pending_dup_pct: of the duplicate reads the main thread
handled, the share queued for Python per read because their first was
still in flight (counter ``place.dups_pending`` over it plus
``place.dups_attached`` and ``place.dups_unplaced``)."""


def read(run: dict):
    c = run.get("counters", {})
    names = ("place.dups_pending", "place.dups_attached",
             "place.dups_unplaced")
    total = sum(c.get(n, 0) for n in names)
    if not total:
        return None
    return 100.0 * c.get("place.dups_pending", 0) / total
