"""Exponential moving averages along the last axis of ``(..., T)`` float32
or float64 rows, each walked in time with a coefficient chosen by the
direction of the signal, in two forms of one kernel, `csrc/ema.cu`:

- **attack/release** (`helpers.smoothing.time_smoothing` with a release
  time): ``y[0] = x[0]``, then ``carry + a·(x[t] − carry)``;
- **average** (`realtime.ExponentialAverageFilter.process_block`): from a
  start carry per row (the channel's state), ``y[t] = x[t]·c + (1 −
  c)·y[t−1]`` with ``c`` the increase coefficient where the signal rises
  above the carry, else the decrease coefficient.

No Pallas kernel stands behind them: the JAX package runs each recursion as
a ``lax.scan`` (`dsptoolbox_tpu/helpers/smoothing.py:164-175`,
`dsptoolbox_tpu/realtime/misc.py:62-77`), which is a loop on the device.
Torch has no such loop, the coefficient depends on the state (no
associative scan computes it in log depth), and a loop of torch ops launches
several kernels per sample (2.88 M samples on the session's path). So the
kernel is hand-written: one warp a row, lane 0 walking the chain in shared
memory while the warp stages the next chunk; each form with its scan's
operations in their order, so kernel and plain loop agree bit for bit
(float32, and float64 in the kernel's double instantiation).

`ema_attack_release` and `ema_average` dispatch by `_config.use_kernel`
("ema"): a float32 or float64 CUDA tensor goes to the kernel outside
`_config.kernels_off()`; a CPU tensor takes the plain loop. Each form counts its own launches (`launches`,
`average_launches`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _config, _cuda

# kernel launches since the last reset, of each form (read by run reports)
launches = 0
average_launches = 0

_c, _ll = ctypes.c_void_p, ctypes.c_longlong
_KERNELS = {
    dtype: _cuda.Kernel("ema", f"dsptb_ema_attack_release_{suffix}",
                        [_c, _c, _ll, _ll, _ll, _ll, scalar, scalar, _c], "EMA kernel")
    for dtype, suffix, scalar in ((torch.float32, "f32", ctypes.c_float),
                                  (torch.float64, "f64", ctypes.c_double))
}
_AVERAGE_KERNELS = {
    dtype: _cuda.Kernel("ema", f"dsptb_ema_average_{suffix}",
                        [_c, _c, _c, _ll, _ll, _ll, _ll, scalar, scalar, _c],
                        "EMA average kernel")
    for dtype, suffix, scalar in ((torch.float32, "f32", ctypes.c_float),
                                  (torch.float64, "f64", ctypes.c_double))
}


def ema_attack_release_plain(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Plain PyTorch version: a loop over time, vectorized over the rows,
    ``y[0] = x[0]``, ``carry + a·(x[t] − carry)`` with ``a`` = ``alpha``
    where ``x[t] > carry``, else ``beta`` (coefficients in the data's
    dtype, as the scan's weakly typed scalars)."""
    T = x.shape[-1]
    x2 = x.reshape(-1, T)
    y = torch.empty_like(x2)
    carry = x2[:, 0].clone()
    y[:, 0] = carry
    a_up = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    a_down = torch.tensor(beta, dtype=x.dtype, device=x.device)
    for t in range(1, T):
        xt = x2[:, t]
        a = torch.where(xt > carry, a_up, a_down)
        carry = carry + a * (xt - carry)
        y[:, t] = carry
    return y.reshape(x.shape)


def ema_attack_release_cuda(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """CUDA kernel: the same result as `ema_attack_release_plain` for
    float32 or float64 ``x (..., T)`` on a CUDA device. One launch,
    counted."""
    global launches
    if not x.is_cuda:
        raise ValueError("ema_attack_release_cuda needs a CUDA tensor")
    if x.dtype not in _KERNELS:
        raise TypeError(f"the EMA kernel takes float32 or float64 input, got {x.dtype}")
    T = x.shape[-1]
    x2 = x.reshape(-1, T)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    y = torch.empty((x2.shape[0], T), dtype=x.dtype, device=x.device)
    if x2.shape[0] and T:
        _KERNELS[x.dtype].launch(x.device.index, x2.data_ptr(), y.data_ptr(), x2.shape[0], T,
                       x2.stride(0), y.stride(0), float(alpha), float(beta))
        launches += 1
    return y.reshape(x.shape)


def ema_attack_release(x: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Attack/release EMA of ``x (..., T)`` along the last axis."""
    if _config.use_kernel("ema", x):
        return ema_attack_release_cuda(x, alpha, beta)
    return ema_attack_release_plain(x, alpha, beta)


def ema_average_plain(x: torch.Tensor, carry: torch.Tensor, increase: float,
                      decrease: float) -> torch.Tensor:
    """Plain PyTorch version: a loop over time, vectorized over the rows of
    ``x (..., T)``, from ``carry (...)`` (in ``x``'s dtype), ``c`` =
    ``increase`` where ``x[t] > y[t-1]``, else ``decrease``, and ``y[t] =
    x[t]·c + (1 − c)·y[t−1]`` (coefficients in the data's dtype, as the
    scan's weakly typed scalars)."""
    T = x.shape[-1]
    x2 = x.reshape(-1, T)
    y = torch.empty_like(x2)
    prev = carry.reshape(-1).to(x.dtype)
    c_up = torch.tensor(increase, dtype=x.dtype, device=x.device)
    c_down = torch.tensor(decrease, dtype=x.dtype, device=x.device)
    for t in range(T):
        xt = x2[:, t]
        c = torch.where(xt > prev, c_up, c_down)
        prev = xt * c + (1 - c) * prev
        y[:, t] = prev
    return y.reshape(x.shape)


def ema_average_cuda(x: torch.Tensor, carry: torch.Tensor, increase: float,
                     decrease: float) -> torch.Tensor:
    """CUDA kernel: the same result as `ema_average_plain` for float32 or
    float64 ``x (..., T)`` on a CUDA device. One launch, counted."""
    global average_launches
    if not x.is_cuda:
        raise ValueError("ema_average_cuda needs a CUDA tensor")
    if x.dtype not in _AVERAGE_KERNELS:
        raise TypeError(f"the EMA kernel takes float32 or float64 input, got {x.dtype}")
    T = x.shape[-1]
    x2 = x.reshape(-1, T)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    c = carry.reshape(-1).to(device=x.device, dtype=x.dtype).contiguous()
    if c.shape[0] != x2.shape[0]:
        raise ValueError(f"carry has {c.shape[0]} rows, x {x2.shape[0]}")
    y = torch.empty((x2.shape[0], T), dtype=x.dtype, device=x.device)
    if x2.shape[0] and T:
        _AVERAGE_KERNELS[x.dtype].launch(x.device.index, x2.data_ptr(), c.data_ptr(), y.data_ptr(),
                                 x2.shape[0], T, x2.stride(0), y.stride(0), float(increase),
                                 float(decrease))
        average_launches += 1
    return y.reshape(x.shape)


def ema_average(x: torch.Tensor, carry: torch.Tensor, increase: float,
                decrease: float) -> torch.Tensor:
    """The exponential average of ``x (..., T)`` along the last axis from
    ``carry (...)``."""
    if _config.use_kernel("ema", x):
        return ema_average_cuda(x, carry, increase, decrease)
    return ema_average_plain(x, carry, increase, decrease)
