"""The per-call records and host diagnostics of an untraced run of the
cut cell, and the spin that an end-to-end throughput has to show."""

from portbench import cell
from portbench.tests import tiny


def test_untraced_run_carries_call_records(tmp_path):
    run = tiny.run(tiny.CELLS[0], tmp_path, seed=9)
    n = len(run["durations"])
    assert n >= 1 and len(run["call_files"]) == n
    assert set(run["call_files"]) <= set(range(tiny.MIX["pool"]))
    assert run["call_reads"] == [tiny.MIX["reads_per_sample"]] * n
    assert run["reads"] == sum(run["call_reads"])
    host = run["host"]
    assert host["cpus"] >= 1
    assert len(host["loadavg_open"]) == len(host["loadavg_close"]) == 3
    if host["ticks"]:
        for k in ("busy_share", "iowait_share", "steal_share"):
            assert 0 <= host[k] <= 1, host


def test_host_window_shares():
    ticks = [0] * 10
    after = [30, 0, 10, 50, 5, 0, 0, 5, 0, 0]
    h = cell._host_window({"loadavg": [1.0, 2.0, 3.0], "ticks": ticks},
                          {"loadavg": [4.0, 5.0, 6.0], "ticks": after})
    assert h["ticks"] == 100
    assert (h["busy_share"], h["iowait_share"], h["steal_share"]) == \
        (0.45, 0.05, 0.05)
    assert h["loadavg_open"] == [1.0, 2.0, 3.0]
    # a host that counts no ticks (or has no /proc) gives no shares
    h = cell._host_window({"ticks": ticks}, {"ticks": ticks})
    assert h["ticks"] == 0 and h["busy_share"] is None
    assert cell._host_window({}, {})["loadavg_open"] is None


def test_spin_in_each_result(tmp_path):
    import time
    from portbench import spin

    class Engine:
        precision = "f32"

        def score_async(self, matrix, lengths):
            class Handle:
                def result(self):
                    return (matrix, lengths)
            return Handle()

    wrapped = spin.Spin(Engine(), 0.05)
    assert wrapped.precision == "f32"
    t0 = time.perf_counter()
    assert wrapped.score_async(1, 2).result() == (1, 2)
    assert time.perf_counter() - t0 >= 0.05
    # through a run of the cut cell: one batch a sample, one spin a call,
    # and the outputs are still judged correct
    s = tiny.spec(tiny.CELLS[0])
    run = cell.run(s, 5, 0.5, False, tmp_path, time.time(), device="cpu",
                   engine_wrap=lambda e: spin.Spin(e, 0.2))
    assert min(run["durations"]) >= 0.2
    assert cell.verdict(run["numbers"], s["limits"], run["failure"])[0]
