"""Blocked-IIR lead: the K full L-sample blocks of an SOS cascade.

Replaces the Pallas kernel ``sosfilt_pallas`` / ``_iir_kernel``
(`dsptoolbox_tpu/ops/pallas_iir.py`), which ran the block recurrence

    y_k = x_k H + s_k G ;   s_{k+1} = s_k A + x_k M

over a sequential grid with the state carried in VMEM.

Precision: ``x_k H`` runs in the signal's dtype (H, the in-block impulse
response, is well conditioned); the boundary-state path (``v = x M``, the
chain, ``s G``) runs in float64 (complex128 for complex cascades). For
low-frequency cascades G reaches 1e3-1e5 while y stays O(1), and fp32
rounding of the state would be amplified by that cancellation. So ``H`` and
``xb`` come in the signal's dtype, ``G``, ``A``, ``M`` and ``s0`` in the state
dtype (`state_dtype`).

On the H100 the Toeplitz products x_k H are the bulk of the work (2·L²
flops per block, fp32 FFMA), and the boundary-state chain is K serial N×N
steps per row, bound by latency. CUDA blocks run in no order and cannot
carry state between them, so the kernel (`csrc/iir_lead.cu`) runs in
passes: the free response and state injections in parallel over all blocks
(H in shared memory, whole or streamed in chunks for long blocks); the
state chain, cut into chunks of ~sqrt(K/2) blocks
that are walked in parallel by one warp each, with one serial carry over
the chunk starts in between; and the state's contribution added in
parallel. The plain version resolves the same chain with a log-depth
doubling prefix of batched matmuls, as `dsptoolbox_tpu/ops/iir_block.py`
does.

`sosfilt_lead` dispatches: a CUDA tensor goes to the kernel unless the
switch (`_config.set_iir_kernel`) is "off". The kernel takes any block
length and up to 32 states (16 sections).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _config, _cuda

# kernel launches since the last reset (read by run reports)
launches = 0

_c = ctypes.c_void_p
_ARGTYPES = [_c] * 10 + [ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _c]


def _chunk(K: int) -> int:
    """Chunk length F of the kernel's state chain: serial depth ~2F + K/F,
    least at F = sqrt(K/2)."""
    return max(1, math.ceil(math.sqrt(K / 2)))


# states the kernel's chain holds: one per lane of a warp
MAX_STATES = 32


def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype of the boundary-state path for a signal of ``dtype``:
    float64, or complex128 for complex signals."""
    return torch.promote_types(dtype, torch.float64)


def sosfilt_lead_plain(H, G, A, M, xb, s0):
    """Plain PyTorch version. ``xb (B, K, L)``, ``s0 (B, N)`` →
    ``(y (B, K, L), s_K (B, N))``.

    The start state rides through the doubling prefix as part of the first
    injection (v_0 += s0 A), so X_k = s_{k+1} for every k.
    """
    K = xb.shape[-2]
    X = xb.to(M.dtype) @ M  # (B, K, N)
    X[..., 0, :] += s0 @ A
    # X_k = sum_{j<=k} v_j A^{k-j} via X_k += X_{k-2^t} (A^{2^t})
    A_pow = A
    shift = 1
    while shift < K:
        X = torch.cat(
            [X[..., :shift, :], X[..., shift:, :] + X[..., :-shift, :] @ A_pow],
            dim=-2,
        )
        A_pow = A_pow @ A_pow
        shift *= 2
    s_starts = torch.cat([s0.unsqueeze(-2), X[..., :-1, :]], dim=-2)
    y = (xb @ H).to(G.dtype) + s_starts @ G
    return y.to(xb.dtype), X[..., -1, :]


def sosfilt_lead_cuda(H, G, A, M, xb, s0):
    """CUDA kernel: the same result as `sosfilt_lead_plain`. ``xb`` and
    ``H`` float32, ``G``, ``A``, ``M`` and ``s0`` float64, all on one CUDA
    device; any block length L, at most `MAX_STATES` states N."""
    global launches
    tensors = (H, G, A, M, xb, s0)
    if not all(t.is_cuda and t.device == xb.device for t in tensors):
        raise ValueError("sosfilt_lead_cuda needs all tensors on one CUDA device")
    if xb.dtype != torch.float32 or H.dtype != torch.float32:
        raise TypeError("sosfilt_lead_cuda takes float32 xb and H")
    if any(t.dtype != torch.float64 for t in (G, A, M, s0)):
        raise TypeError("sosfilt_lead_cuda takes float64 G, A, M and s0")
    B, K, L = xb.shape
    N = A.shape[0]
    if (H.shape != (L, L) or G.shape != (N, L) or A.shape != (N, N)
            or M.shape != (L, N) or s0.shape != (B, N)):
        raise ValueError("operator shapes do not match xb (B, K, L) / s0 (B, N)")
    if N > MAX_STATES:
        raise ValueError(
            f"the kernel holds at most {MAX_STATES} states, got N={N}: run a "
            "longer cascade as a series of shorter ones (`sosfilt_block` does)"
        )
    H, G, A, M, xb, s0 = (t.contiguous() for t in tensors)
    y = torch.empty_like(xb)
    F = _chunk(K)
    scratch = torch.empty((B, K, N), dtype=s0.dtype, device=xb.device)
    carry = torch.empty((B, -(-K // F), N), dtype=s0.dtype, device=xb.device)
    zf = torch.empty_like(s0)
    fn = _cuda.function("iir_lead", "dsptb_iir_lead_f32", _ARGTYPES)
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), H.data_ptr(), G.data_ptr(), A.data_ptr(),
                 M.data_ptr(), s0.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                 carry.data_ptr(), zf.data_ptr(), B, K, L, N, F,
                 _cuda.stream_of(xb))
    _cuda.check(err, "sosfilt lead kernel")
    launches += 1
    return y, zf


def sosfilt_lead(H, G, A, M, xb, s0):
    """Filter the full blocks ``xb (B, K, L)`` from state ``s0 (B, N)``."""
    if _config.use_kernel(_config.iir_kernel(), xb):
        return sosfilt_lead_cuda(H, G, A, M, xb, s0)
    return sosfilt_lead_plain(H, G, A, M, xb, s0)
