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

The lead is one band of the filter bank's function with a start state, so
on the card it runs on the bank's kernel (`cuda_iir_bank`,
`csrc/iir_bank.cu`): its batch rows are the bank's rows, ``h = H[0]`` (H is
the Toeplitz matrix of its row 0, the in-block impulse response), ``s0``
the state before block 0 (`bank_form`). The kernel's passes: x·M on the
fp64 tensor cores, the fp64 state chain cut into chunks of ~sqrt(K/2)
blocks walked in parallel with one serial carry from ``s0`` over the chunk
starts, and an output pass that writes y once (for L <= 128 on the tensor
cores: x·h as three TF32 products of a hi/lo split, s·G in fp64). A lead of
`cuda_iir_bank.WIDE_LANES` states or more at L <= 128 takes the bank's wide
route (`cuda_iir_bank.keeps_state_on_chip`), which keeps the block states on
the chip and chains over tiles of 64 blocks. The plain
version resolves the same chain with a log-depth doubling prefix of batched
matmuls, as `dsptoolbox_tpu/ops/iir_block.py` does.

`sosfilt_lead` dispatches by `_config.use_kernel` ("iir"): a float32 CUDA
tensor goes to the kernel outside `_config.kernels_off()`; CPU tensors and
other dtypes take the plain version. The kernel takes any block length and
up to 32 states (16 sections).
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from .. import _config
from . import cuda_iir_bank

# kernel launches since the last reset (read by run reports)
launches = 0

# the wide route's operators of each state operator A (the cached device
# operators recur from call to call), dropped with A
_tile_operators = WeakTensorKeyDictionary()

# states the kernel's chain holds: one per lane of a warp
MAX_STATES = cuda_iir_bank.MAX_LANES


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


def bank_form(H, G, A, M, xb, s0):
    """The lead's arguments as one band of the filter bank: ``(ops, x, s0)``
    for `cuda_iir_bank.sosfilt_bank_lead_plain(ops, x, out, s0)` and, through
    ``ops["kernel"]``, for the kernel (`cuda_iir_bank.launch`).

    ``ops`` holds the operators with a band axis of one and their real form
    (``h = H[0]``, G as one plane); ``x`` is ``xb`` as ``B`` rows of ``K·L``
    samples, ``s0`` the band's state ``(1, B, N)``. Views of the arguments
    (``x`` a copy only if ``xb``'s blocks do not tile its rows); where the
    lead takes the wide route (`cuda_iir_bank.keeps_state_on_chip`), the
    kernel's ``W`` too, built once per ``A``.
    """
    B, K, L = xb.shape
    kops = {"h": H[None, :1], "G": G[None, None], "A": A[None], "M": M, "lanes": A.shape[0]}
    if cuda_iir_bank.keeps_state_on_chip(L, 1, A.shape[0]):
        W = _tile_operators.get(A)
        if W is None:
            W = _tile_operators[A] = cuda_iir_bank.tile_operators(kops["A"])
        kops["W"] = W
    ops = {"HmatT": H[None], "GyT": G[None], "ALT": A[None], "MT": M[None],
           "L": L, "n_full": K, "kernel": kops}
    return ops, xb.reshape(B, K * L), s0[None]


def sosfilt_lead_cuda(H, G, A, M, xb, s0):
    """CUDA kernel: the same result as `sosfilt_lead_plain`. ``xb`` and
    ``H`` float32, ``G``, ``A``, ``M`` and ``s0`` float64, all on one CUDA
    device; any block length L, at most `MAX_STATES` states N. One launch of
    the bank's kernel (`bank_form`), counted here and not as the bank's."""
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
    H, G, A, M, s0 = (t.contiguous() for t in (H, G, A, M, s0))
    ops, x, s0 = bank_form(H, G, A, M, xb, s0)
    if x.stride(1) != 1:
        x = x.contiguous()
    y = torch.empty((B, K, L), dtype=torch.float32, device=xb.device)
    zf = cuda_iir_bank.launch(ops["kernel"], x, y.view(1, 1, B, K * L), K, s0)
    launches += 1
    return y, zf[0]


def sosfilt_lead(H, G, A, M, xb, s0):
    """Filter the full blocks ``xb (B, K, L)`` from state ``s0 (B, N)``."""
    if _config.use_kernel("iir", xb):
        return sosfilt_lead_cuda(H, G, A, M, xb, s0)
    return sosfilt_lead_plain(H, G, A, M, xb, s0)
