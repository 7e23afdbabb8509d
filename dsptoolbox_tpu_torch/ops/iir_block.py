"""Blocked IIR filtering: the fast path for sosfilt/lfilter
(`dsptoolbox_tpu/ops/iir_block.py`).

Exact block processing of an LTI system in state-space form (A, B, C, D):

    y[n]  = sum_{k<=n} h[n-k] x[k]  +  C A^n s_prev          (within a block)
    s_end = A^L s_prev + sum_k A^{L-1-k} B x[k]

so a whole block of L samples is two products with static matrices (the L×L
lower-triangular Toeplitz of the impulse response, exact within the block,
plus the state propagation/injection operators), and the blocks are chained
through the N-dim boundary state.

The SOS cascade is composed host-side (float64) into one state-space whose
state vector is the concatenation of the per-section scipy TDF2 states, so
``zi``/``zf`` keep scipy's ``(S, 2)`` layout exactly. The host builders are
copied verbatim from the JAX package.

Precision differs from the JAX package on purpose: the in-block Toeplitz
product runs in the signal's dtype, the boundary-state path in float64
(`cuda_iir.state_dtype`). The composed TDF2 basis of a low-frequency cascade
has output operators of 1e3-1e5 against O(1) outputs; in float32 that
cancellation costs ~1e-5 relative error against scipy's float64 sosfilt
(250 Hz Butterworth bands at 48 kHz), in float64 state it costs <1e-6.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .. import _config
from . import cuda_iir_bank
from .cuda_iir import MAX_STATES, sosfilt_lead, sosfilt_lead_plain, state_dtype
from .cuda_iir_bank import MAX_LANES, sosfilt_bank_lead_cuda, sosfilt_bank_lead_plain


def _tdf2_abcd(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state-space (A, B, C, D) of normalized ba —
    the state convention of scipy's ``lfilter``/``sosfilt`` zi."""
    dtype = (
        np.complex128
        if (np.iscomplexobj(b) or np.iscomplexobj(a))
        else np.float64
    )
    b = np.atleast_1d(np.asarray(b, dtype=dtype))
    a = np.atleast_1d(np.asarray(a, dtype=dtype))
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = max(len(a), len(b)) - 1
    bp = np.zeros(N + 1, dtype)
    ap = np.zeros(N + 1, dtype)
    bp[: len(b)] = b
    ap[: len(a)] = a
    A = np.zeros((N, N), dtype)
    A[:, 0] = -ap[1:]
    A[: N - 1, 1:] = np.eye(N - 1)
    B = (bp[1:] - ap[1:] * bp[0])[:, None]
    C = np.zeros((1, N), dtype)
    C[0, 0] = 1.0
    D = np.array([[bp[0]]], dtype)
    return A, B, C, D


def _series_compose(systems):
    """Series-connect state-space systems, preserving member state order in
    the concatenated state vector."""
    A_c, B_c, C_c, D_c = systems[0]
    for A2, B2, C2, D2 in systems[1:]:
        n1 = A_c.shape[0]
        n2 = A2.shape[0]
        dtype = np.result_type(A_c.dtype, A2.dtype)
        A_new = np.zeros((n1 + n2, n1 + n2), dtype)
        A_new[:n1, :n1] = A_c
        A_new[n1:, n1:] = A2
        A_new[n1:, :n1] = B2 @ C_c
        B_new = np.vstack([B_c, B2 @ D_c])
        C_new = np.hstack([D2 @ C_c, C2])
        D_new = D2 @ D_c
        A_c, B_c, C_c, D_c = A_new, B_new, C_new, D_new
    return A_c, B_c, C_c, D_c


def _sos_abcd(sos: np.ndarray):
    return _series_compose([_tdf2_abcd(sec[:3], sec[3:]) for sec in sos])


@lru_cache(maxsize=256)
def _block_operators(sos_key: tuple, L: int):
    """Static (HmatT (L,L), GyT (N,L), ALT (N,N), MT (L,N)) in float64:
    y_blk = x_blk @ HmatT + s @ GyT ;  s' = s @ ALT + x_blk @ MT."""
    sos = np.asarray(sos_key).reshape(-1, 6)
    if not np.iscomplexobj(sos):
        sos = sos.astype(np.float64)
    A, B, C, D = _sos_abcd(sos)
    dtype = A.dtype
    N = A.shape[0]
    powers = np.empty((L + 1, N, N), dtype)
    powers[0] = np.eye(N)
    for i in range(1, L + 1):
        powers[i] = powers[i - 1] @ A
    h = np.empty(L, dtype)
    h[0] = D[0, 0]
    for m in range(1, L):
        h[m] = (C @ powers[m - 1] @ B)[0, 0]
    Hmat = np.zeros((L, L), dtype)
    for m in range(L):
        np.fill_diagonal(Hmat[m:, : L - m], h[m])
    Gy = np.stack([(C @ powers[n])[0] for n in range(L)], axis=0)
    AL = powers[L]
    M = np.stack([(powers[L - 1 - k] @ B)[:, 0] for k in range(L)], axis=1)
    return Hmat.T, Gy.T, AL.T, M.T


def _pick_block(T: int) -> int:
    # L = 128 was swept on a TPU (v5e); kept for parity until it is swept
    # on the H100
    if T <= 128:
        return max(8, T)
    return 128


# Sections per blocked cascade: the lead kernel's state chain holds
# N = 2·S <= 32 states, one per lane of a warp
_MAX_SECTIONS = MAX_STATES // 2

_OPERATOR_NAMES = ("HmatT", "GyT", "ALT", "MT")


def operators_to_torch(ops: dict, device, dtype: torch.dtype) -> dict:
    """Host block operators → tensors on ``device`` for a signal of ``dtype``.

    ``ops`` holds any of ``HmatT``, ``GyT``, ``ALT``, ``MT`` (from
    `_block_operators` or `sosfilt_bank_operators`), ``rem_ops`` (the
    remainder-block list of `sosfilt_bank_operators`, or None) and ``zi``
    (an initial state in scipy's ``(..., S, 2)`` layout, or None). Integer
    entries (``L``, ``n_full``, ``rem``), the host bank ``sos`` and the
    bank kernel's operators (``kernel``) pass through. ``HmatT`` becomes
    ``dtype``; the state operators and ``zi`` become ``state_dtype(dtype)``.
    """
    sdt = state_dtype(dtype)

    def conv(v, dt):
        # contiguous once here: the builders return transposed views, which
        # the kernels would otherwise copy on every call
        return torch.as_tensor(v, dtype=dt, device=device).contiguous()

    out = {}
    for k, v in ops.items():
        if v is None or isinstance(v, (int, dict)) or k == "sos":
            out[k] = v
        elif k == "rem_ops":
            out[k] = [conv(m, dtype if i == 0 else sdt) for i, m in enumerate(v)]
        else:
            out[k] = conv(v, dtype if k == "HmatT" else sdt)
    return out


@lru_cache(maxsize=64)
def _device_operators(key: tuple, L: int, dtype: torch.dtype, device: torch.device):
    """`_block_operators` as tensors on ``device`` for a signal of ``dtype``,
    cached so that repeated calls pay the host-to-device copies once."""
    ops = operators_to_torch(
        dict(zip(_OPERATOR_NAMES, _block_operators(key, L))), device, dtype
    )
    return tuple(ops[k] for k in _OPERATOR_NAMES)


def sosfilt_block(
    sos: np.ndarray,
    x: torch.Tensor,
    zi=None,
    block_size: int | None = None,
):
    """Blocked ``sosfilt`` over the last axis of ``x (..., T)``.

    Matches ``scipy.signal.sosfilt`` numerically, including the ``zi``/``zf``
    state layout ``(..., S, 2)``. Returns ``(y, zf)``: ``y`` in the input's
    dtype, ``zf`` in the state path's (`cuda_iir.state_dtype`: float64 for
    float32 data), as the lead carries it. The full blocks go
    through `cuda_iir.sosfilt_lead` (the CUDA kernel for float32 CUDA input,
    at any number of blocks), the remainder tail through one more block
    product. A cascade of more than 16 sections runs as a series of
    cascades of at most 16.
    """
    sos = np.asarray(sos)
    sos = sos.astype(np.complex128 if np.iscomplexobj(sos) else np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got {sos.shape}")
    S = sos.shape[0]
    N = 2 * S
    T = x.shape[-1]
    if T == 0:
        sdt = state_dtype(
            torch.promote_types(x.dtype, torch.complex64) if np.iscomplexobj(sos) else x.dtype
        )
        zf = (
            torch.as_tensor(zi, dtype=sdt, device=x.device)
            if zi is not None
            else torch.zeros(x.shape[:-1] + (S, 2), dtype=sdt, device=x.device)
        )
        return x, zf
    if S > _MAX_SECTIONS:
        # exact: the cascade's state is its sections' states in order
        zi = None if zi is None else torch.as_tensor(zi, device=x.device)
        zfs = []
        for first in range(0, S, _MAX_SECTIONS):
            part = slice(first, first + _MAX_SECTIONS)
            x, zf = sosfilt_block(
                sos[part], x, None if zi is None else zi[..., part, :], block_size
            )
            zfs.append(zf)
        return x, torch.cat(zfs, dim=-2)
    L = min(block_size or _pick_block(T), T)
    key = tuple(sos.reshape(-1).tolist())
    compute_dtype = torch.promote_types(
        x.dtype, torch.complex64 if np.iscomplexobj(sos) else x.dtype
    )
    x = x.to(compute_dtype)
    batch = x.shape[:-1]
    B = math.prod(batch)
    H, G, A, M = _device_operators(key, L, compute_dtype, x.device)
    s0 = (
        torch.as_tensor(zi, dtype=A.dtype, device=x.device).reshape(B, N)
        if zi is not None
        else A.new_zeros((B, N))
    )

    n_full = T // L
    rem = T - n_full * L
    if n_full > 0:
        xb = x[..., : n_full * L].reshape(B, n_full, L)
        # every float32 lead takes `sosfilt_lead` (B2 on a CUDA tensor, at
        # any block count); the kernel takes float32 only
        lead = sosfilt_lead if compute_dtype == torch.float32 else sosfilt_lead_plain
        y, s_end = lead(H, G, A, M, xb, s0)
        y = y.reshape(B, n_full * L)
    else:
        s_end = s0
        y = x.new_zeros((B, 0))

    if rem:
        Hr, Gr, Ar, Mr = _device_operators(key, rem, compute_dtype, x.device)
        x_tail = x[..., n_full * L :].reshape(B, rem)
        y_tail = ((x_tail @ Hr).to(Gr.dtype) + s_end @ Gr).to(compute_dtype)
        s_end = s_end @ Ar + x_tail.to(Mr.dtype) @ Mr
        y = torch.cat([y, y_tail], dim=-1)

    # the state stays in the state path's dtype (float64 for float32 data)
    zf = s_end.reshape(batch + (S, 2))
    return y.reshape(batch + (T,)), zf


def lfilter_block(
    b: np.ndarray,
    a: np.ndarray,
    x: torch.Tensor,
    zi=None,
    block_size: int | None = None,
):
    """Blocked ``lfilter`` (TDF2 state ``(..., N)``), same machinery with the
    single (b, a) system expressed as one pseudo-section when order ≤ 2, or
    a cascade via tf2sos otherwise (zi path requires order ≤ 2)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    order = max(len(a), len(b)) - 1
    if order <= 2:
        bp = np.zeros(3)
        ap = np.zeros(3)
        bp[: len(b)] = b
        ap[: len(a)] = a
        sos = np.concatenate([bp, ap])[None, :]
        zi2 = None
        if zi is not None:
            sdt = state_dtype(x.dtype)
            zi2 = torch.zeros(x.shape[:-1] + (1, 2), dtype=sdt, device=x.device)
            zi2[..., 0, :order] = torch.as_tensor(zi, dtype=sdt, device=x.device)
        y, zf = sosfilt_block(sos, x, zi=zi2, block_size=block_size)
        return y, zf[..., 0, :order]
    if zi is not None:
        raise NotImplementedError(
            "Blocked lfilter with initial state is limited to order <= 2."
        )
    from scipy.signal import tf2sos

    y, _ = sosfilt_block(tf2sos(b, a), x, block_size=block_size)
    zf = torch.zeros(x.shape[:-1] + (order,), dtype=state_dtype(x.dtype), device=x.device)
    return y, zf


def stack_sos_bank(cascades) -> np.ndarray | None:
    """SOS cascades ``(S_b, 6)`` stacked ``(B, S_max, 6)``, shorter ones
    padded with identity sections; None when real and complex cascades mix
    (no band is silently promoted)."""
    cascades = [np.asarray(s) for s in cascades]
    flags = [np.iscomplexobj(s) for s in cascades]
    if any(flags) and not all(flags):
        return None
    identity = np.array([[1.0, 0, 0, 1.0, 0, 0]], np.complex128 if flags[0] else np.float64)
    max_s = max(s.shape[0] for s in cascades)
    return np.stack([np.vstack([s] + [identity] * (max_s - s.shape[0])) for s in cascades])


def sosfilt_bank_operators(
    sos_bank: np.ndarray, T: int, block_size: int | None = None
):
    """Stacked block operators for a bank of same-order SOS cascades.

    ``sos_bank (B, S, 6)`` → dict of host f64 (or c128 for complex
    cascades, e.g. gammatone) arrays: HmatT (B,L,L), GyT (B,N,L),
    ALT (B,N,N), MT (B,L,N) plus the remainder-block variants, as in the
    JAX package, and ``sos``, the bank itself, from which the kernel's
    route builds its stages (`bank_kernel_stages`).
    """
    sos_bank = np.asarray(sos_bank)
    sos_bank = sos_bank.astype(np.complex128 if np.iscomplexobj(sos_bank) else np.float64)
    if sos_bank.ndim != 3 or sos_bank.shape[-1] != 6:
        raise ValueError(f"sos_bank must be (B, S, 6), got {sos_bank.shape}")
    L = min(block_size or _pick_block(T), T)
    n_full = T // L
    rem = T - n_full * L
    ops = {"L": L, "n_full": n_full, "rem": rem, "sos": sos_bank}
    for name in _OPERATOR_NAMES:
        ops[name] = []
    ops["rem_ops"] = [] if rem else None
    for b in range(sos_bank.shape[0]):
        key = tuple(sos_bank[b].reshape(-1).tolist())
        H, G, A, M = _block_operators(key, L)
        ops["HmatT"].append(H)
        ops["GyT"].append(G)
        ops["ALT"].append(A)
        ops["MT"].append(M)
        if rem:
            ops["rem_ops"].append(_block_operators(key, rem))
    for name in _OPERATOR_NAMES:
        ops[name] = np.stack(ops[name])
    if rem:
        ops["rem_ops"] = [
            np.stack([band[i] for band in ops["rem_ops"]])
            for i in range(4)
        ]
    return ops


@lru_cache(maxsize=16)
def _bank_kernel_stages(key: bytes, shape: tuple, np_dtype: str, T: int, L: int,
                        device: torch.device) -> tuple:
    bank = np.frombuffer(key, dtype=np_dtype).reshape(shape)
    cplx = np.iscomplexobj(bank)
    per = MAX_LANES // (4 if cplx else 2)

    def stage(part):
        ops = operators_to_torch(sosfilt_bank_operators(part, T, L), device,
                                 torch.complex64 if cplx else torch.float32)
        ops["kernel"] = cuda_iir_bank.kernel_operators(ops)
        return ops

    rest = tuple(
        tuple(stage(bank[b : b + 1, s : s + per]) for s in range(per, shape[1], per))
        for b in range(shape[0])
    ) if shape[1] > per else ()
    return stage(bank[:, :per]), rest


def bank_kernel_stages(sos_bank: np.ndarray, T: int, device, block_size: int | None = None):
    """The bank's operators as the kernel runs them, on ``device``, built
    once per (bank, T, L, device) and cached: ``(first, rest)``.

    The kernel's chain holds at most `cuda_iir_bank.MAX_LANES` real state
    lanes, 16 real or 8 complex sections. ``first`` covers the first
    sections of every band on the shared input; ``rest[b]`` (empty unless a
    cascade is longer) holds band b's further sections as single-band
    stages, each run on that band's output. Exact: a cascade is its
    sections in series. Each stage carries the kernel's real form
    (``kernel``) and float32 signal dtype.
    """
    bank = np.ascontiguousarray(sos_bank)
    T = int(T)
    L = min(block_size or _pick_block(T), T)
    return _bank_kernel_stages(bank.tobytes(), bank.shape, bank.dtype.str, T, L,
                               torch.device(device))


def _bank_stage(ops: dict, x2: torch.Tensor, lead) -> torch.Tensor:
    """One bank's operators ``ops`` on real ``x2 (R, T)`` → planes
    ``(P, B, R, T)``: the full blocks through ``lead`` (the kernel or its
    plain version), the remainder tail as one more block product."""
    L, n_full, rem = ops["L"], ops["n_full"], ops["rem"]
    R, T = x2.shape
    if n_full * L + rem != T:
        raise ValueError("operators were built for another signal length")
    complex_ops = ops["HmatT"].is_complex()
    n_bands = ops["HmatT"].shape[0]
    out = torch.empty((2 if complex_ops else 1, n_bands, R, T), dtype=x2.dtype,
                      device=x2.device)
    if n_full > 0:
        s_end = lead(ops, x2, out)  # (B, R, N)
    else:
        s_end = ops["GyT"].new_zeros((n_bands, R, ops["GyT"].shape[1]))
    if rem:
        Hr, Gr, _, _ = ops["rem_ops"]
        x_tail = x2[:, n_full * L :].to(Hr.dtype)
        y_tail = torch.einsum("rl,blm->brm", x_tail, Hr).to(Gr.dtype) + (
            torch.einsum("brn,bnl->brl", s_end, Gr)
        )
        tail = out[..., n_full * L :]
        if complex_ops:
            tail[0], tail[1] = y_tail.real, y_tail.imag
        else:
            tail[0] = y_tail
    return out


def _kernel_route(stages: tuple, x2: torch.Tensor) -> torch.Tensor:
    """`bank_kernel_stages` on float32 ``x2 (R, T)`` on the card, every
    stage's full blocks through the kernel → planes ``(P, B, R, T)``. A
    complex stage on a band's complex output ``u + iv`` filters ``u`` and
    ``v`` as real rows and recombines: ``F(u) + i·F(v)``."""
    first, rest = stages
    out = _bank_stage(first, x2, sosfilt_bank_lead_cuda)
    R = x2.shape[0]
    for b, band_stages in enumerate(rest):
        for st in band_stages:
            if out.shape[0] == 2:
                p = _bank_stage(st, out[:, b].reshape(2 * R, -1), sosfilt_bank_lead_cuda)[:, 0]
                out[0, b] = p[0, :R] - p[1, R:]
                out[1, b] = p[1, :R] + p[0, R:]
            else:
                out[0, b] = _bank_stage(st, out[0, b], sosfilt_bank_lead_cuda)[0, 0]
    return out


def sosfilt_bank_apply_planes(ops: dict, x: torch.Tensor):
    """Apply a bank of blocked SOS cascades to real ``x (..., T)`` (zero
    initial state) → ``(real, imag)``, each ``(B, ..., T)``; ``imag`` is
    None for a real bank. Both are views of one ``(2, B, ..., T)`` buffer,
    so each band's planes are taken without a copy.

    ``ops`` comes from `sosfilt_bank_operators`, as numpy arrays or already
    converted by `operators_to_torch`. Same math as `sosfilt_block` with a
    leading band axis. Route: on a CUDA tensor (switch
    `_config.set_bank_kernel` not "off") every full block goes through the
    bank kernel, on the operators of `bank_kernel_stages`; the input must
    then be float32. Otherwise the whole bank's operators run through the
    kernel's plain version. The remainder tail is one more block product.
    """
    if x.is_complex():
        raise TypeError("the bank filters real input")
    batch, T = x.shape[:-1], x.shape[-1]
    R = math.prod(batch)
    x2 = x.reshape(R, T).contiguous()
    if _config.use_kernel(_config.bank_kernel(), x):
        if x.dtype != torch.float32:
            raise TypeError(
                f"the bank kernel takes float32 input, got {x.dtype}; switch it "
                "'off' (`set_bank_kernel`) to filter other dtypes on the card"
            )
        out = _kernel_route(bank_kernel_stages(ops["sos"], T, x.device, ops["L"]), x2)
    else:
        complex_ops = (
            ops["HmatT"].is_complex()
            if torch.is_tensor(ops["HmatT"])
            else np.iscomplexobj(ops["HmatT"])
        )
        compute_dtype = torch.promote_types(
            x.dtype, torch.complex64 if complex_ops else x.dtype
        )
        ops = operators_to_torch(ops, x.device, compute_dtype)
        out = _bank_stage(ops, x2, sosfilt_bank_lead_plain)
    out = out.reshape(out.shape[:2] + batch + (T,))
    return out[0], (out[1] if out.shape[0] == 2 else None)


def sosfilt_bank_apply(ops: dict, x: torch.Tensor) -> torch.Tensor:
    """`sosfilt_bank_apply_planes` as one tensor ``(B, ..., T)``: complex
    for a complex bank."""
    re, im = sosfilt_bank_apply_planes(ops, x)
    return re if im is None else torch.complex(re, im)


@lru_cache(maxsize=16)
def _bank_device_operators(key: bytes, shape: tuple, np_dtype: str, T: int,
                           dtype: torch.dtype, device: torch.device) -> dict:
    bank = np.frombuffer(key, dtype=np_dtype).reshape(shape)
    compute_dtype = torch.promote_types(
        dtype, torch.complex64 if np.iscomplexobj(bank) else dtype
    )
    return operators_to_torch(sosfilt_bank_operators(bank, T), device, compute_dtype)


def bank_device_operators(sos_bank: np.ndarray, T: int, dtype: torch.dtype, device) -> dict:
    """`sosfilt_bank_operators` of ``sos_bank`` for real signals of length
    ``T`` and ``dtype``, on ``device``, built once per (bank, T, dtype,
    device) and cached."""
    bank = np.ascontiguousarray(sos_bank)
    return _bank_device_operators(bank.tobytes(), bank.shape, bank.dtype.str, int(T),
                                  dtype, torch.device(device))
