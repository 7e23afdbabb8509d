"""The roofline's bytes and operations against hand counts."""

import numpy as np
import pytest

from portbench import roofline as rl
from portbench.chains import banks, spectral
from portbench.harness import ROOT, load_json


def test_framing_counts_each_byte_once():
    # 2 rows of 10 samples, window 4, hop 2: ceil(10/2) = 5 frames a row
    w = rl.framing(2, 10, 4, 2)
    assert w.bytes == 4 * (2 * 10 + 4 + 2 * 5 * 4)
    assert w.flops == 2 * 5 * 4
    # padded by 2 at both ends: ceil(14/2) = 7 frames; detrend: 3 flops a value
    w = rl.framing(2, 10, 4, 2, pad=2, detrend=True)
    assert w.bytes == 4 * (2 * 10 + 4 + 2 * 7 * 4)
    assert w.flops == 3 * 2 * 7 * 4


def test_sos_bank_counts_direct_form_operations():
    real = np.ones((2, 6))
    w = rl.sos_bank(3, 5, [real, real[:1]], complex_out=False)
    assert w.bytes == 4 * 3 * 5 * (1 + 2)
    assert w.flops == 9 * 3 * 3 * 5
    p = 0.9 * np.exp(0.2j)
    unit = [1, 0, 0, 1, -p, 0]
    gain = [0.5, 0, 0, 1, -p, 0]
    assert rl.sos_section_flops(unit) == 8
    assert rl.sos_section_flops(gain) == 10
    w = rl.sos_bank(3, 5, [[unit, unit, unit, gain]], complex_out=True)
    assert w.bytes == 4 * 3 * 5 * (1 + 2)
    assert w.flops == (3 * 8 + 10) * 3 * 5


def test_bound_says_which_bound():
    assert rl.bound_s(rl.Work(bytes=rl.HBM_BYTES_S, flops=1.0)) == (1.0, "bytes")
    assert rl.bound_s(rl.Work(bytes=1.0, flops=2 * rl.FP32_FLOP_S)) == (2.0, "operations")


def test_cells_work_by_hand():
    session = load_json(ROOT / "portbench/configs/session16x60.json")
    T = 2_880_000
    frames = 16 * 5627 * 1024 + 16 * 5625 * 1024 + 32 * 5625 * 1024
    ins = 16 * T + 16 * T + 32 * T + 3 * 1024
    w = spectral.work(session, {})
    assert w["audio_s"] == 960.0
    assert w["framing"].bytes == 4 * (frames + ins)
    fb = load_json(ROOT / "portbench/configs/fb64x10.json")
    n = 64 * 441_000
    w = banks.work(fb, {})
    assert w["audio_s"] == 640.0
    # the signal once a bank call, 16 complex and 28 real bands out
    assert w["iir_bank"].bytes == 4 * n * (2 + 16 * 2 + 28)
    # 28 bands of 6 real biquads; 16 bands of 3 unit and 1 scaled complex section
    assert w["iir_bank"].flops == pytest.approx(n * (28 * 6 * 9 + 16 * (3 * 8 + 10)))
    assert rl.bound_s(w["iir_bank"])[1] == "bytes"
