"""jplace.eager_reuse_pct: of the batches the jplace writer wrote, the
share whose line blob the formatter thread had rendered eagerly and that
was written as it was (counter ``jplace.lines_reused`` over it plus
``jplace.lines_rerendered`` and ``jplace.lines_late``)."""


def read(run: dict):
    c = run.get("counters", {})
    names = ("jplace.lines_reused", "jplace.lines_rerendered",
             "jplace.lines_late")
    total = sum(c.get(n, 0) for n in names)
    if not total:
        return None
    return 100.0 * c.get("jplace.lines_reused", 0) / total
