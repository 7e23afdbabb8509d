"""The readers of the port's own spans (``dsp.*``) and build counter, on a
hand-built trace: self time through nested spans, the device's idle and
the host's waits put down to the program's spans and not to the
harness's, and nothing read where there is nothing to read."""

import sys
import types

import numpy as np
import pytest

from portbench import harness
from portbench import trace as tr
from portbench.roofline import Work


def record():
    calls = [(100.0, 100.001, 100.01), (100.011, 100.012, 100.02)]
    return harness.RunRecord(5.0, calls, calls[-1][2] - calls[0][0],
                             {"audio_s": 10.0, "framing": Work(3.35e9, 0.0)})


def read(name, run):
    return harness.part("metrics", name).read(run)


def note(name, run):
    return harness.part("metrics", name).note(run)


# (name, start us, end us), a window of 0-1000 us over two calls
CPU = [
    ("portbench.call", 0.0, 800.0),
    ("portbench.istft", 10.0, 700.0),
    ("dsp.entry.transforms.istft", 20.0, 600.0),
    ("dsp.ops.spectral.stft", 100.0, 400.0),
    ("dsp.build.ops.spectral._device_window", 150.0, 250.0),
    ("dsp.ops.spectral._windowed_frames", 410.0, 430.0),
    ("cudaStreamSynchronize", 450.0, 500.0),
    ("portbench.sync", 800.0, 1000.0),
    ("cudaDeviceSynchronize", 810.0, 990.0),
]
# busy 0-120, 300-440, 520-820: idle 120-300 (in the build span), 440-520
# (in the ISTFT's own span), 820-1000 (under the harness's sync alone)
DEVICE = [("void frames_warp_kernel<8, true>(float const*)", 0.0, 120.0),
          ("void vector_fft_r2c<1024>", 300.0, 440.0),
          ("void at::native::elementwise_kernel<copy>", 520.0, 820.0)]


def trace(cpu=CPU):
    names = [n for n, _, _ in cpu]
    iv = np.asarray([(s, e) for _, s, e in cpu], dtype=np.float64).reshape(-1, 2)
    return tr.TraceRecord(DEVICE, (0.0, 1000.0), 2, names, iv)


def test_self_time_through_nested_spans():
    run = record()
    run.trace = trace()
    # the ISTFT's 580 us less its two ops spans (300 + 20); the STFT's 300
    # less its build (100), plus the framing's 20; two calls traced
    assert read("entry_host_ms", run) == pytest.approx(260e-3 / 2)
    assert read("ops_host_ms", run) == pytest.approx(220e-3 / 2)


def test_stall_inside_a_span_counts_the_harness_sync_does_not():
    run = record()
    run.trace = trace()
    assert read("host_stall_ms", run) == pytest.approx((180 + 80) * 1e-3 / 2)
    text = note("host_stall_ms", run)
    assert text.index("dsp.build.ops.spectral._device_window 0.09 ms") < text.index(
        "dsp.entry.transforms.istft 0.04 ms")
    assert "portbench" not in text


def test_sync_inside_the_istft_counts_the_harness_sync_does_not():
    run = record()
    run.trace = trace()
    assert read("host_syncs", run) == pytest.approx(0.5)
    assert note("host_syncs", run) == "innermost spans, syncs a call: dsp.entry.transforms.istft 0.5"


def test_operator_build_s_reads_the_program_counter(monkeypatch):
    run = record()
    run.trace = trace()
    fake = types.SimpleNamespace(builds={"ops.spectral._device_window": [3, 0.25],
                                         "ops.iir_block._bank_device_operators": [2, 1.5]})
    monkeypatch.setitem(sys.modules, "dsptoolbox_tpu_torch._trace", fake)
    assert read("operator_build_s", run) == pytest.approx(1.75)
    text = note("operator_build_s", run)
    assert text.startswith("5 builds, longest ops.iir_block._bank_device_operators 2x 1.5 s")
    assert "built again in the traced stretch: 1; dsp.build.ops.spectral._device_window 1x" in text


NEW = ("entry_host_ms", "ops_host_ms", "host_stall_ms", "host_syncs", "operator_build_s")


def test_nothing_to_read_without_a_trace():
    run = record()
    for name in NEW:
        assert read(name, run) is None, name


def test_nothing_to_read_from_a_program_without_spans(monkeypatch):
    run = record()
    run.trace = trace([c for c in CPU if not c[0].startswith("dsp.")])
    monkeypatch.delitem(sys.modules, "dsptoolbox_tpu_torch._trace", raising=False)
    for name in NEW:
        assert read(name, run) is None, name
