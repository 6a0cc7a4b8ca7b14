"""The trace readers: launches lost by the profiler fail the run; the
idle share, launches in a host range and gap labels from a trace."""

import pytest

from h100_bench.harness.runner import RunRecord
from h100_bench.harness.spec import load_reader
from h100_bench.harness.trace import HostOp, TraceData, check_launches


class FakeLoop:
    def k1_calls(self):
        return [(8, 512, 768, 4, 256, 768)]


def trace(k1_events: int, k1_counted: int, iterations: int = 1):
    ops = [("void splat_fwd_kernel<4, true>(...)", 10.0 * i, 10.0 * i + 5,
            100 + i) for i in range(k1_events)]
    ops.append(("elementwise_kernel", 200.0, 210.0, 99))
    rng = HostOp("train_step/optimizer", 0.0, 5.0, [])
    return TraceData(device_ops=ops, host_roots={1: [rng]},
                     launch_at={99: 1.0, 100: 50.0}, window_s=300e-6,
                     iterations=iterations,
                     counters={"splat.launches": k1_counted})


def record(t, window=None):
    return RunRecord(cell=None, window=window or {}, trace=t, host_trace=t,
                     spans={}, loop=FakeLoop())


def test_a_shortfall_of_kernel_events_fails_the_run():
    check_launches(trace(2, 2))
    with pytest.raises(RuntimeError, match="lost launches"):
        check_launches(trace(1, 2))


def test_the_k1_reader_raises_on_a_shortfall_and_reads_a_share():
    read = load_reader("k1_roofline.serve")
    with pytest.raises(RuntimeError):
        read(record(trace(0, 1)))
    share = read(record(trace(1, 1)))
    assert share == pytest.approx(100 * 35.669e-3 / 5e-3, rel=1e-3)


def test_idle_share_launches_in_a_range_and_gap_labels():
    # 20 us busy in the traced iteration; the untraced window ran 10
    # iterations in 1 ms.
    t = trace(2, 2)
    window = {"seconds": 1e-3, "iterations": 10, "units": 10}
    assert load_reader("idle_share.train")(record(t, window)) == (
        pytest.approx(100 * (1 - 10 * 20e-6 / 1e-3)))
    assert t.ops_launched_in("train_step/optimizer") == 1
    assert t.idle_gaps()[0][0] == "(no host range)"
    assert t.host_label(2.0) == "train_step/optimizer"
