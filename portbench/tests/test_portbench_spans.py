"""The per-layer metrics that read the program's spans and counters, on
the cut cell on the CPU: a traced run turns the spans on and reads them,
an untraced run leaves them off."""

import time

from portbench import cell
from portbench.tests import tiny

SPAN_METRICS = ("pipeline.ingest_wait_pct", "pipeline.dedup_pct",
                "pipeline.prep_wait_pct", "pipeline.device_wait_pct",
                "pipeline.fold_pct", "pipeline.call_edges_pct",
                "pipeline.engine_wait_pct", "engine.transfer_ms_per_batch",
                "engine.host_ms_per_batch", "setup.db_load_s",
                "setup.engine_s", "pipeline.pending_dup_pct",
                "jplace.eager_reuse_pct")


def _metric(name):
    return cell.load_module(cell.HERE / "metrics" / f"{name}.py",
                            "m_" + name.replace(".", "_"))


def test_span_metrics_read_a_traced_run(tmp_path):
    from rappas_tpu_torch import utils
    (tmp_path / "t").mkdir()
    run = cell.run(tiny.spec(tiny.CELLS[0]), 6, 0.5, True, tmp_path / "t",
                   time.time(), device="cpu")
    values = {n: _metric(n).read(run) for n in SPAN_METRICS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    # the tiny mix's duplicates all have their first in their own block
    assert values["pipeline.pending_dup_pct"] == 100.0
    assert 0 <= values["jplace.eager_reuse_pct"] <= 100
    shares = [values[n] for n in SPAN_METRICS if n.endswith("_pct") and
              n.startswith("pipeline.") and n != "pipeline.pending_dup_pct"]
    assert sum(shares) < 100
    assert run["counters"]["place.reads"] == run["reads"]
    assert run["setup_spans"]["db.load"]["count"] == 1
    # the spans are off again after the run; an untraced run keeps none
    assert not utils._ON
    (tmp_path / "u").mkdir()
    untraced = tiny.run(tiny.CELLS[0], tmp_path / "u", seed=6)
    assert "spans" not in untraced
    assert all(_metric(n).read(untraced) is None for n in SPAN_METRICS)
