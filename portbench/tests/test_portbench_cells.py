"""Each cell's traffic mix against its reference at a tiny size on the
CPU: a sound run is correct; the control (the reference in the program's
place in bfloat16) and each planted fault are not."""

import pytest

from .conftest import run_cpu, tiny_cell

CELLS = ["session16x60.spectral", "fb64x10.banks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run_cpu(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"audio_s_per_s", "call_ms_p95", "setup_s"}
    for c in r["checks"].values():
        assert c["value"] < c["limit"] / 3


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    r = run_cpu(cell, program_factory=cell.reference.Control)
    assert not r["correct"]
    assert any(c["value"] > 3 * c["limit"] for c in r["checks"].values()), r["checks"]


def half_batch(chain):
    """Half of the channels left out: the program is given the first half
    twice."""
    class Fault(chain.Program):
        def __init__(self, config, traffic, recordings, device, rows):
            half = recordings.shape[1] // 2
            recordings = recordings.clone()
            recordings[:, half:2 * half] = recordings[:, :half]
            super().__init__(config, traffic, recordings, device, rows)
    return Fault


def altered_answer(chain):
    """One value of one output altered where it is produced (by a
    thousandth of that output's peak)."""
    class Fault(chain.Program):
        @staticmethod
        def extract(outputs, rows):
            got = chain.Program.extract(outputs, rows)
            name = sorted(got)[0]
            t = got[name].clone()
            flat = t.view(-1) if not t.is_complex() else t.view(-1)
            flat[flat.numel() // 3] += 1e-3 * t.abs().max()
            got[name] = t
            return got
    return Fault


def unchanged_state(chain):
    """A step that returns its state unchanged: every call hands back the
    first call's outputs."""
    class Fault(chain.Program):
        first = None

        def call(self, index, span):
            if self.first is None:
                self.first = super().call(index, span)
            return self.first
    return Fault


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [half_batch, altered_answer, unchanged_state])
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    r = run_cpu(cell, program_factory=fault(cell.chain))
    assert not r["correct"], (fault.__name__, r["checks"])


def test_spectrogram_fault_the_inverse_undoes_is_not_correct():
    """The spectrogram handed out scaled by 1.001 while the ISTFT reads the
    sound one: y, Welch and the CSM stay right, and only ``stft_gap``
    sees it."""
    cell = tiny_cell("session16x60.spectral")

    class Fault(cell.chain.Program):
        def call(self, index, span):
            S, *rest = super().call(index, span)
            return (S * 1.001, *rest)

    r = run_cpu(cell, program_factory=Fault)
    assert not r["correct"]
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad == {"stft_gap"}, r["checks"]
