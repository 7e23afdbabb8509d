"""The comparisons that decide ``correct``: scale-relative gaps between
what the program produced and what the plain reference computes, in
float64, and rounding to a lower precision for the controls."""

from __future__ import annotations

import torch


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| over the whole tensor (NaN where the
    shapes differ or the program's values are not finite)."""
    got, ref = _f64(got.to(ref.device)), _f64(ref)
    if got.shape != ref.shape:
        return float("nan")
    scale = float(ref.abs().amax())
    return float((got - ref).abs().amax()) / (scale or 1.0)


def row_gap(got: torch.Tensor, ref: torch.Tensor, row_dim: int) -> float:
    """The largest over the rows along ``row_dim`` of each row's max
    |got - ref| / max |ref|: a row's error counts against its own scale
    (every other axis belongs to the row)."""
    got, ref = _f64(got.to(ref.device)), _f64(ref)
    if got.shape != ref.shape:
        return float("nan")
    dims = [d for d in range(ref.ndim) if d != row_dim % ref.ndim]
    err = (got - ref).abs().amax(dim=dims)
    scale = ref.abs().amax(dim=dims)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return float((err / scale).amax())


def merge(a: dict, b: dict) -> dict:
    """The larger reading of each number (NaN wins: not finite)."""
    out = dict(a)
    for k, v in b.items():
        w = out.get(k)
        if w is None or v != v or (w == w and v > w):
            out[k] = v
    return out


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back to its own dtype (a complex
    tensor part by part)."""
    if t.is_complex():
        return torch.complex(to_bf16(t.real), to_bf16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)
