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
from .._trace import spanned
from . import cuda_iir_bank
from .cuda_iir import MAX_STATES, sosfilt_lead, state_dtype
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


def _abcd_operators(A, B, C, D, L: int):
    """Block operators of the state-space system (A, B, C, D) for blocks of
    ``L`` samples, in its dtype: (HmatT (L,L), GyT (N,L), ALT (N,N), MT (L,N))
    with y_blk = x_blk @ HmatT + s @ GyT ;  s' = s @ ALT + x_blk @ MT."""
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


@lru_cache(maxsize=256)
def _block_operators(sos_key: tuple, L: int):
    """`_abcd_operators` of the SOS cascade ``sos_key`` (flattened (S, 6)),
    float64 (complex128 for a complex cascade)."""
    sos = np.asarray(sos_key).reshape(-1, 6)
    if not np.iscomplexobj(sos):
        sos = sos.astype(np.float64)
    return _abcd_operators(*_sos_abcd(sos), L)


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


@_config.device_cache(64)
def _device_operators(key: tuple, L: int, dtype: torch.dtype, device: torch.device):
    """`_block_operators` as tensors on ``device`` for a signal of
    ``dtype``, cached so that repeated calls pay the host-to-device copies
    once."""
    ops = operators_to_torch(
        dict(zip(_OPERATOR_NAMES, _block_operators(key, L))), device, dtype
    )
    return tuple(ops[k] for k in _OPERATOR_NAMES)


def _run_blocks(key: tuple, x: torch.Tensor, s0: torch.Tensor, L: int):
    """``x (B, T)`` in its compute dtype from the state ``s0 (B, N)``
    through the blocked cascade ``key``: the full blocks through
    `cuda_iir.sosfilt_lead` (B2 for float32 on a CUDA tensor, at any block
    count; the plain version for other dtypes), the remainder tail as one
    more block product. Returns ``(y (B, T), s_end (B, N))``, the state in
    the state path's dtype."""
    B, T = x.shape
    H, G, A, M = _device_operators(key, L, x.dtype, x.device)
    n_full = T // L
    rem = T - n_full * L
    if n_full > 0:
        xb = x[:, : n_full * L].reshape(B, n_full, L)
        y, s_end = sosfilt_lead(H, G, A, M, xb, s0)
        y = y.reshape(B, n_full * L)
    else:
        s_end = s0
        y = x.new_zeros((B, 0))
    if rem:
        Hr, Gr, Ar, Mr = _device_operators(key, rem, x.dtype, x.device)
        x_tail = x[:, n_full * L :]
        y_tail = ((x_tail @ Hr).to(Gr.dtype) + s_end @ Gr).to(x.dtype)
        s_end = s_end @ Ar + x_tail.to(Mr.dtype) @ Mr
        y = torch.cat([y, y_tail], dim=-1)
    return y, s_end


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
    sdt = state_dtype(compute_dtype)
    s0 = (
        torch.as_tensor(zi, dtype=sdt, device=x.device).reshape(B, N)
        if zi is not None
        else torch.zeros((B, N), dtype=sdt, device=x.device)
    )
    y, s_end = _run_blocks(key, x.reshape(B, T), s0, L)

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


def _polish_poles(a: np.ndarray, p: np.ndarray, steps: int = 6) -> np.ndarray:
    """The roots ``p`` of the polynomial ``a`` refined by Newton steps in
    extended precision (``np.clongdouble``), each step kept only where it
    lowers |a(p)|: the clustered poles of a low-cutoff filter are found to
    ~1e-7 in float64, which moves its response by a few 1e-6."""
    c = np.asarray(a, np.longdouble)
    dc = np.polyder(c)
    z = np.asarray(p, np.clongdouble)
    res = np.abs(np.polyval(c, z))
    for _ in range(steps):
        d = np.polyval(dc, z)
        ok = d != 0
        step = np.where(ok, np.polyval(c, z) / np.where(ok, d, 1), 0)
        cand = z - step
        better = np.abs(np.polyval(c, cand)) < res
        z = np.where(better, cand, z)
        res = np.where(better, np.abs(np.polyval(c, cand)), res)
    return z.astype(np.complex128)


def _observability(A: np.ndarray, C: np.ndarray, n: int):
    """``[C; C A; …; C A^(n-1)]`` (the zero-input output of each state) of
    a float64 system, exactly, as an mpmath matrix (50 digits)."""
    import mpmath

    Am = mpmath.matrix(A.tolist())
    rows = [mpmath.matrix([C[0].tolist()])]
    for _ in range(n - 1):
        rows.append(rows[-1] * Am)
    return mpmath.matrix([[r[0, j] for j in range(A.shape[0])] for r in rows])


@lru_cache(maxsize=64)
def _ba_cascade(ba_key: tuple):
    """``(sos, to_cascade (2S, N), to_tdf2 (N, 2S))`` of the IIR direct form
    ``ba_key = (b, a)``: the SOS cascade of its zeros and its poles (roots
    of ``a`` refined in extended precision), and the maps between its
    states and the TDF2 state of ``(b, a)`` that give the same zero-input
    output over its 2S samples (2S = N, or N + 1 for an odd order, whose
    extra mode sits at the origin). The observability matrices are ill
    conditioned (~1e15 for a narrow band at low frequencies), so the maps
    are solved exactly (mpmath, 50 digits) from the float64 systems and
    rounded once."""
    import mpmath
    from scipy.signal import tf2zpk, zpk2sos

    b, a = (np.asarray(v, np.float64) for v in ba_key)
    z, p, k = tf2zpk(b, a)
    # an odd order's real pole and zero in one first-order section
    sos = zpk2sos(z, _polish_poles(a, p), k, pairing="keep_odd")
    Ac, _, Cc, _ = _sos_abcd(sos)
    At, _, Ct, _ = _tdf2_abcd(b, a)
    n = Ac.shape[0]
    with mpmath.workdps(50):
        Oc, Ot = _observability(Ac, Cc, n), _observability(At, Ct, n)
        to_cascade = np.array((mpmath.inverse(Oc) * Ot).tolist(), dtype=np.float64)
        to_tdf2 = np.array((mpmath.inverse(Ot.T * Ot) * (Ot.T * Oc)).tolist(),
                           dtype=np.float64)
    return sos, to_cascade, to_tdf2


def _ba_key(b: np.ndarray, a: np.ndarray) -> tuple:
    """The key of `_ba_cascade`: ``(b, a)`` with trailing zeros trimmed
    and ``a`` normalized, as tuples."""
    b = np.trim_zeros(np.atleast_1d(np.asarray(b, dtype=np.float64)), "b")
    a = np.trim_zeros(np.atleast_1d(np.asarray(a, dtype=np.float64)), "b")
    if len(a) < 2:
        raise ValueError("the cascade route takes an IIR (len(a) > 1)")
    b, a = b / a[0], a / a[0]
    N = max(len(a), len(b)) - 1
    if N > MAX_STATES:
        raise ValueError(f"the blocked lead holds at most {MAX_STATES} states, got N={N}")
    return tuple(b.tolist()), tuple(a.tolist())


def ba_cascade(b: np.ndarray, a: np.ndarray):
    """``(sos, to_cascade (2S, N), to_tdf2 (N, 2S))`` of the IIR direct
    form ``(b, a)`` (`_ba_cascade`), its trailing zeros trimmed and ``a``
    normalized."""
    return _ba_cascade(_ba_key(b, a))


@_config.device_cache(64)
def _device_cascade_maps(ba_key: tuple, dtype: torch.dtype, device) -> tuple:
    """``(to_cascade.T (N, 2S), to_tdf2.T (2S, N))`` of `_ba_cascade` on
    ``device``, cached: a stream of blocks uploads them once."""
    _, to_cascade, to_tdf2 = _ba_cascade(ba_key)
    return (torch.as_tensor(to_cascade.T, dtype=dtype, device=device),
            torch.as_tensor(to_tdf2.T, dtype=dtype, device=device))


def cascade_maps(b: np.ndarray, a: np.ndarray, dtype: torch.dtype, device) -> tuple:
    """The state maps of `ba_cascade` as row-vector operators on
    ``device``: ``zi @ to_cascade``, ``zc @ to_tdf2`` (cached)."""
    return _device_cascade_maps(_ba_key(b, a), dtype, torch.device(device))


def lfilter_statespace(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi=None,
                       block_size: int | None = None, zc=None):
    """Stateful ``lfilter`` of the IIR direct form ``(b, a)`` of order N (at
    most `cuda_iir.MAX_STATES`) over the last axis of real ``x (..., T)``,
    run as the SOS cascade of its zeros and poles (`ba_cascade`) through
    `sosfilt_block` (B2 on a float32 CUDA tensor), the state path in
    float64. Returns ``(y, zf, zc_end)``: ``zf (..., N)`` in scipy's TDF2
    layout and ``zc_end (..., 2S)`` the cascade's own final state, both
    float64 (the state dtype).

    The run starts from ``zc`` (a cascade state, as a previous call
    returned it: exact) where it is given, else from the TDF2 state ``zi``
    mapped into the cascade. The map rounds: a TDF2 state in float64 holds
    the cascade's ~1e-8 first-section state to ~5e-8 relative only, so a
    stream that hands back ``zf`` can move by a few 1e-8 of the output's
    scale a handover, one that hands back ``zc_end`` not at all. In the TDF2
    companion basis itself the block operators of a low-cutoff filter are
    too ill-conditioned for any block length (order 6 at 200 Hz, 48 kHz:
    A^128 has entries of 2.3e8 and in float64 a spectral radius of 6.0, so
    the blocked recursion diverges; at L = 8 it is still 1.3e-3 off scipy).
    """
    sos = ba_cascade(b, a)[0]
    batch = x.shape[:-1]
    sdt = state_dtype(x.dtype)
    to_cascade, to_tdf2 = cascade_maps(b, a, sdt, x.device)
    if zc is None:
        s0 = torch.as_tensor(zi, dtype=sdt, device=x.device).expand(batch + (to_cascade.shape[0],))
        zc = s0 @ to_cascade
    zc = torch.as_tensor(zc, dtype=sdt, device=x.device).expand(batch + (to_cascade.shape[1],))
    y, zc_end = sosfilt_block(sos, x, zi=zc.reshape(batch + (-1, 2)), block_size=block_size)
    zc_end = zc_end.reshape(batch + (-1,))
    return y, zc_end @ to_tdf2, zc_end


def lfilter_handover(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi, kept=None):
    """`lfilter_statespace` of ``x (..., T)`` from the TDF2 states ``zi
    (..., N)``, continuing a stream: ``kept`` (None, or ``(handed (...,
    N), zc (..., 2S))`` as the last call returned it) holds the state that
    call handed out and the exact cascade state behind it. Each row whose
    ``zi`` is still the one handed out starts from its cascade state, any
    other (a row of ``handed`` that is NaN, or a state set by hand) from
    ``zi`` mapped into the cascade; the choice is made on the device, so a
    stream never waits on the host. Returns ``(y, zf, (zf, zc_end))``."""
    sdt = state_dtype(x.dtype)
    zi = torch.as_tensor(zi, dtype=sdt, device=x.device)
    zc = zi @ cascade_maps(b, a, sdt, x.device)[0]
    if kept is not None:
        handed, zc_kept = (torch.as_tensor(v, dtype=sdt, device=x.device) for v in kept)
        zc = torch.where(torch.all(zi == handed, dim=-1, keepdim=True), zc_kept, zc)
    y, zf, zc_end = lfilter_statespace(b, a, x, zc=zc)
    return y, zf, (zf, zc_end)


@spanned("dsp.ops.iir_block.stack_sos_bank")
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


@_config.device_cache(16)
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


@spanned("dsp.ops.iir_block.bank_kernel_stages")
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


@spanned("dsp.ops.iir_block.sosfilt_bank_apply_planes")
def sosfilt_bank_apply_planes(ops: dict, x: torch.Tensor):
    """Apply a bank of blocked SOS cascades to real ``x (..., T)`` (zero
    initial state) → ``(real, imag)``, each ``(B, ..., T)``; ``imag`` is
    None for a real bank. Both are views of one ``(2, B, ..., T)`` buffer,
    so each band's planes are taken without a copy.

    ``ops`` comes from `sosfilt_bank_operators`, as numpy arrays or already
    converted by `operators_to_torch`. Same math as `sosfilt_block` with a
    leading band axis. Route: where `_config.use_kernel` ("bank") allows, a
    float32 CUDA tensor, every full block goes through the bank kernel, on
    the operators of `bank_kernel_stages`. Otherwise the whole bank's
    operators run through the kernel's plain version. The remainder tail is
    one more block product.
    """
    if x.is_complex():
        raise TypeError("the bank filters real input")
    batch, T = x.shape[:-1], x.shape[-1]
    R = math.prod(batch)
    x2 = x.reshape(R, T).contiguous()
    if _config.use_kernel("bank", x):
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


@_config.device_cache(16)
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
