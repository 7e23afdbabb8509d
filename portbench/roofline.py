"""The yardstick of the hand-written kernels' rooflines: the card's
published peaks and the work that each kernel's function needs at a call's
shapes, whatever algorithm implements it.

The bytes are counted as ``chip_smoke.py:265`` (`bound`) counts them
(frozen copy of its arithmetic): every input byte read once and every
output byte written once, at the device-memory rate. The operations are
those of the plain direct-form computation: the window and the detrend of
the framing, and for a filter bank each section's multiply-adds a sample
(a real biquad 9 flops; a complex one-pole section 8 flops for its
feedback's complex multiply-add, and 2 more where its gain b0 is not 1),
at the float32 rate outside the tensor cores. No blocked, Toeplitz or
tensor-core form is counted.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet (dense, at the 700 W power limit)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


@dataclass(frozen=True)
class Work:
    """Bytes moved and float32 operations of one call of a kernel's
    function."""

    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)


def bound_s(work: Work) -> tuple[float, str]:
    """``(seconds, bound_by)``: the larger of the bytes' time at the
    device-memory rate and the operations' time at the float32 peak, and
    which of the two it is."""
    t_bytes = work.bytes / HBM_BYTES_S
    t_ops = work.flops / FP32_FLOP_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def frame_count(length: int, step: int) -> int:
    """Frames of hop ``step`` over ``length`` samples: ceil(length / step),
    the last ones zero-padded at the end."""
    return -(-length // step)


def framing(rows: int, length: int, window: int, step: int, pad: int = 0,
            detrend: bool = False, itemsize: int = 4) -> Work:
    """One windowed framing of ``rows`` signals of ``length`` samples:
    the signal and the window read once, the frames written once; a
    multiply a sample of every frame, and with ``detrend`` the frame's mean
    (an add) and its subtraction."""
    k = frame_count(length + 2 * pad, step)
    n_out = rows * k * window
    return Work(
        bytes=itemsize * (rows * length + window + n_out),
        flops=n_out * (3 if detrend else 1),
    )


def sos_section_flops(section) -> int:
    """Operations a sample of one second-order section ``(b0, b1, b2, a0,
    a1, a2)`` in direct form: 9 for a real biquad; for a section with a
    complex coefficient, 8 (one complex multiply-add) for each nonzero
    coefficient among b1, b2, a1, a2, and 2 for a gain b0 other than 1."""
    if not any(isinstance(c, complex) and c.imag != 0 for c in map(complex, section)):
        return 9
    b0, b1, b2, _, a1, a2 = (complex(c) for c in section)
    return 8 * sum(c != 0 for c in (b1, b2, a1, a2)) + (2 if b0 != 1 else 0)


def sos_bank(rows: int, length: int, bands, complex_out: bool, itemsize: int = 4) -> Work:
    """One call of a parallel bank of SOS cascades ``bands`` (a list of
    ``(sections, 6)`` arrays) on ``rows`` real signals of ``length``
    samples: the signal read once, every band's output written once
    (complex outputs twice the bytes); the direct-form operations of every
    section of every band on every sample."""
    per_sample = sum(sos_section_flops(s) for sos in bands for s in sos)
    n_bands = len(bands)
    return Work(
        bytes=itemsize * rows * length * (1 + n_bands * (2 if complex_out else 1)),
        flops=float(per_sample) * rows * length,
    )


def kernel_share(run, kernels, key: str):
    """``(share in %, seconds a call)`` of the kernels named ``kernels``
    against the bound of ``run.work[key]``; None where the run has no
    trace, no such work or none of these kernels ran."""
    t = run.trace
    if t is None or key not in run.work:
        return None
    s = t.seconds_of(kernels)
    if s is None:
        return None
    s /= t.n_calls
    return 100.0 * bound_s(run.work[key])[0] / s, s


def describe(run, kernels, key: str) -> str:
    """The roofline's reading in words: the bound, what bounds it, the
    device time and the card."""
    b, by = bound_s(run.work[key])
    w = run.work[key]
    return (f"bound {b * 1e3:.4f} ms by {by} ({w.bytes:.6g} B, {w.flops:.6g} flop), "
            f"device {kernel_share(run, kernels, key)[1] * 1e3:.4f} ms a call; card {run.card}")
