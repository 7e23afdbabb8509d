"""Attack/release exponential moving average: ``(..., T)`` float32 or
float64 rows,
each walked in time with a coefficient chosen by the direction of the
signal (`helpers.smoothing.time_smoothing` with a release time).

No Pallas kernel stands behind it: the JAX package runs the recursion as a
``lax.scan`` (`dsptoolbox_tpu/helpers/smoothing.py:164-175`), which is a
loop on the device. Torch has no such loop, its coefficient depends on the
state (no associative scan computes it in log depth), and a loop of torch
ops launches several kernels per sample (2.88 M samples on the session's
path). So it is one hand-written kernel, `csrc/ema.cu`: one warp a row,
lane 0 walking the chain in shared memory while the warp stages the next
chunk; the scan's operations in its order, so kernel and plain loop agree
bit for bit (float32, and float64 in the kernel's double instantiation).

`ema_attack_release` dispatches: a CUDA tensor goes to the kernel unless
the switch (`_config.set_ema_kernel`) is "off"; a CPU tensor takes the
plain loop.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _config, _cuda

# kernel launches since the last reset (read by run reports)
launches = 0

_c, _ll = ctypes.c_void_p, ctypes.c_longlong
_KERNELS = {
    dtype: _cuda.Kernel("ema", f"dsptb_ema_attack_release_{suffix}",
                        [_c, _c, _ll, _ll, _ll, _ll, scalar, scalar, _c], "EMA kernel")
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
    if _config.use_kernel(_config.ema_kernel(), x):
        return ema_attack_release_cuda(x, alpha, beta)
    return ema_attack_release_plain(x, alpha, beta)
