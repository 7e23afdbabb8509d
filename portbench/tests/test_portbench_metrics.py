"""The metrics are taken over every call of the window, and the traced
ones from one trace."""

import numpy as np
import pytest

from portbench import harness
from portbench import trace as tr
from portbench.roofline import Work, bound_s


def record(latencies_ms, issue_ms=1.0, gap_ms=0.1):
    calls, t = [], 100.0
    for lat in latencies_ms:
        calls.append((t, t + issue_ms * 1e-3, t + lat * 1e-3))
        t += lat * 1e-3 + gap_ms * 1e-3
    return harness.RunRecord(5.0, calls, calls[-1][2] - calls[0][0],
                             {"audio_s": 10.0, "framing": Work(3.35e9, 0.0)})


def read(name, run):
    return harness.part("metrics", name).read(run)


def test_a_stalled_call_moves_rate_and_tail():
    steady = record([10.0] * 20)
    stalled = record([10.0] * 19 + [500.0])
    assert read("audio_s_per_s", steady) == pytest.approx(20 * 10.0 / steady.window_s)
    assert read("audio_s_per_s", stalled) < 0.4 * read("audio_s_per_s", steady)
    assert read("call_ms_p95", steady) == pytest.approx(10.0)
    # numpy's linear 95th percentile of 20 calls: 19.05 % of the way past the 19th
    assert read("call_ms_p95", stalled) == pytest.approx(10.0 + 0.05 * 490.0)
    assert read("host_issue_ms", stalled) == pytest.approx(1.0)
    assert read("setup_s", stalled) == 5.0


def synthetic_trace():
    # window 0-1000 us; B1 300 us, a copy 200 us overlapping a FFT 150 us
    ops = [("void frames_warp_kernel<8, true>(float const*)", 0.0, 300.0),
           ("void at::native::elementwise_kernel<copy>", 400.0, 600.0),
           ("void vector_fft_r2c<1024>", 500.0, 650.0)]
    cpu = np.asarray([(0.0, 1000.0), (650.0, 1000.0), (700.0, 900.0)])
    names = ["portbench.call", "portbench.sync", "cudaDeviceSynchronize"]
    return tr.TraceRecord(ops, (0.0, 1000.0), 2, names, cpu)


def test_traced_metrics_from_one_window():
    run = record([10.0] * 3)
    run.trace = synthetic_trace()
    assert run.trace.busy_s == pytest.approx(550e-6)
    assert read("device_idle_pct", run) == pytest.approx(45.0)
    # two calls traced: 350 us of torch's operations, 300 us of B1
    assert read("torch_ops_ms", run) == pytest.approx(0.175)
    b1_s = 150e-6
    assert read("framing_roofline", run) == pytest.approx(100 * bound_s(run.work["framing"])[0] / b1_s)
    assert read("iir_bank_roofline", run) is None
    gaps = dict(run.trace.breakdown()["idle_gaps"])
    assert gaps["sync > cudaDeviceSynchronize"] == pytest.approx(350e-6)
    assert gaps["between calls"] == pytest.approx(100e-6)


def test_no_trace_no_traced_metric():
    run = record([10.0] * 3)
    for name in ("device_idle_pct", "torch_ops_ms", "framing_roofline"):
        assert read(name, run) is None
