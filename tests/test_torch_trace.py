"""The port's tracer (`dsptoolbox_tpu_torch._trace`): spans at the layer
boundaries while torch's profiler records (CPU activity only here), none
otherwise, outputs unchanged by it, and the build counter of
`_config.device_cache`."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dsptoolbox_tpu_torch import Signal, _config, _cuda, _trace
from dsptoolbox_tpu_torch.filterbanks import fractional_octave_bands, linkwitz_riley_crossovers
from dsptoolbox_tpu_torch.standard import append_signals
from dsptoolbox_tpu_torch.standard.enums import FilterBankMode
from dsptoolbox_tpu_torch.standard.resampling import resample
from dsptoolbox_tpu_torch.transforms import istft

FS = 16000


def recording(channels=3, seconds=0.5, seed=0):
    x = np.random.default_rng(seed).standard_normal((channels, int(FS * seconds)))
    return torch.as_tensor(0.1 * x, dtype=torch.float32)


def session_call(x):
    """The session chain's calls: spectrogram → ISTFT → Welch spectrum →
    append → CSM, every getter on the device."""
    sig = Signal(None, x.T, FS)
    _, _, S = sig.get_spectrogram(force_computation=True, return_device=True)
    y = istft(S, original_signal=sig)
    _, welch = sig.get_spectrum(force_computation=True, return_device=True)
    both = append_signals([sig, y])
    _, csm = both.get_csm(force_computation=True, return_device=True)
    return [S, y.time_data, welch, csm.real, csm.imag]


def bank_call(x):
    """A two-band SOS bank, the LR crossover and a resampling."""
    sig = Signal(None, x.T, FS)
    bank = fractional_octave_bands([500, 1000], 1, 4, FS)[0]
    lr = linkwitz_riley_crossovers([1000], [4], FS)
    bands = bank.filter_signal(sig, FilterBankMode.Parallel)
    split = lr.filter_signal(sig, FilterBankMode.Parallel)
    rs = resample(sig, FS // 2)
    return [b.time_data for b in bands.bands + split.bands] + [rs.time_data]


def traced(fn, *args):
    """``(outputs, {name: Counter of parents}, dsp events)`` of ``fn``
    under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    events = [ev for ev in prof.events() if ev.name.startswith("dsp.")]
    parents = {}
    for ev in events:
        parent = ev.cpu_parent.name if ev.cpu_parent is not None else None
        parents.setdefault(ev.name, Counter())[parent] += 1
    return out, parents, events


def test_session_chain_spans_nest_ops_under_entry():
    x = recording()
    session_call(x)  # the device constants built before the traced call
    _, parents, _ = traced(session_call, x)
    nested = {
        "dsp.ops.spectral.stft": "dsp.entry.Signal.get_spectrogram",
        "dsp.ops.spectral.stft_plan": "dsp.ops.spectral.stft",
        "dsp.ops.spectral.welch": "dsp.entry.Signal.get_spectrum",
        "dsp.ops.spectral.csm_welch": "dsp.entry.Signal.get_csm",
    }
    for child, parent in nested.items():
        assert parents[child] == Counter({parent: 1}), (child, parents.get(child))
    assert parents["dsp.ops.spectral._windowed_frames"] == Counter(
        {"dsp.ops.spectral.stft": 1, "dsp.ops.spectral.welch": 1,
         "dsp.ops.spectral.csm_welch": 1})
    for entry in ("transforms.istft", "standard.append_signals"):
        assert sum(parents[f"dsp.entry.{entry}"].values()) == 1
    setter = parents["dsp.entry.Signal.time_data"]
    assert setter["dsp.entry.transforms.istft"] == 1
    assert setter["dsp.entry.standard.append_signals"] == 1
    # the constants were built before the traced call: nothing is built again
    assert not [n for n in parents if n.startswith("dsp.build.")]


def test_bank_calls_spans_nest_ops_under_entry():
    x = recording()
    bank_call(x)
    _, parents, _ = traced(bank_call, x)
    bank = "dsp.entry.FilterBank.filter_signal"
    assert parents["dsp.ops.iir_block.stack_sos_bank"] == Counter({bank: 1})
    assert parents["dsp.ops.iir_block.sosfilt_bank_apply_planes"] == Counter({bank: 1})
    assert parents["dsp.ops.fft_conv.resample_poly"] == Counter(
        {"dsp.entry.standard.resample": 1})
    assert sum(parents["dsp.entry.LRFilterBank.filter_signal"].values()) == 1
    # a band's Signal set from the bank's planes
    assert parents["dsp.entry.Signal.time_data"][bank] == 2


def test_spans_are_operator_events_not_annotations():
    x = recording()
    _, _, events = traced(session_call, x)
    _, _, more = traced(bank_call, x)
    assert events and more
    assert not [ev.name for ev in events + more if ev.is_user_annotation]


def test_no_profiler_no_span(monkeypatch):
    x = recording()
    session_call(x)
    bank_call(x)

    def refuse(name):
        raise AssertionError(f"span {name} entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    session_call(x)
    bank_call(x)
    with _trace.span("dsp.ops.anything"):
        pass


@pytest.mark.parametrize("call", [session_call, bank_call])
def test_outputs_bit_identical_with_and_without_the_profiler(call):
    x = recording(seed=3)
    plain = call(x)
    got, _, _ = traced(call, x)
    assert len(got) == len(plain)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


def test_device_cache_counts_each_miss_once():
    @_config.device_cache(4)
    def _window_for_test(n: int, device) -> torch.Tensor:
        return torch.ones(n, device=device)

    key = f"{__name__}.{_window_for_test.__qualname__}"
    assert key not in _trace.builds
    _window_for_test(8, "cpu")
    assert _trace.builds[key][0] == 1
    seconds = _trace.builds[key][1]
    _window_for_test(8, "cpu")  # a hit
    assert _trace.builds[key] == [1, seconds]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _window_for_test(16, "cpu")
        _window_for_test(16, "cpu")
    assert _trace.builds[key][0] == 2 and _trace.builds[key][1] >= seconds
    names = [ev.name for ev in prof.events() if ev.name.startswith("dsp.build.")]
    assert names == ["dsp.build." + key]


def test_a_kernel_build_is_a_span(monkeypatch, tmp_path):
    src = tmp_path / "stub.cu"
    src.write_text("// a source the stand-in compiler copies\n")
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_cuda, "BUILD_LOG", {})
    # a compiler stand-in: ``sh -c 'cp SRC OUT' sh -o OUT SRC``
    copy = ["sh", "-c", 'cp "$3" "$2"', "sh"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _cuda.build(src, "stub", copy)
        again = _cuda.build(src, "stub", copy)  # built already: no compile
    assert out == again and out.read_text() == src.read_text()
    names = [ev.name for ev in prof.events() if ev.name.startswith("dsp.")]
    assert names == ["dsp.build.nvcc.stub"]
    assert "stub" in _cuda.BUILD_LOG
