"""IIR filter bank: the full blocks of B same-order SOS cascades on one
shared real input, zero initial state.

Replaces the Pallas kernel ``sosfilt_bank_pallas`` (`_bank_kernel_real`,
`_bank_kernel_cplx`; `dsptoolbox_tpu/ops/pallas_iir_bank.py`), which ran the
bank as dense band-concatenated MXU products with the state carried in VMEM
over a sequential grid. The JAX package never dispatched it (it lost to the
XLA doubling prefix on the TPU); its contract is that of
`ops.iir_block.sosfilt_bank_apply`, whose route on a CUDA tensor this
kernel is.

Per band b and L-sample block k, with the block operators of
`iir_block.sosfilt_bank_operators` (``HmatT``, ``GyT``, ``ALT``, ``MT``):

    y[b,k] = x_k H_b + s[b,k] G_b ;   s[b,k+1] = s[b,k] A_b + x_k M_b ;   s[b,0] = 0

Precision follows the port's blocked IIR (`cuda_iir`): ``x_k H`` at fp32
accuracy (on the card three TF32 tensor-core products of a hi/lo split, or
fp32 FFMA), the whole state path (``x M``, the chain, ``s G``) in float64.
The JAX package's float32 bank misses scipy by up to 1e-3 and more on the
lowest 1/3-octave bands; the float64 state keeps them within 5e-6.

The kernel (`csrc/iir_bank.cu`) runs on the operators' real form
(`kernel_operators`): a complex cascade with N complex states becomes
``Ns = 2N`` real state lanes and two output planes (real, imaginary), a
real one ``Ns = N`` lanes and one plane; it takes up to `MAX_LANES` lanes,
and `iir_block.bank_kernel_stages` splits longer cascades into stages.
Bound on the H100: the output bytes (the planes of every band) and the
Toeplitz products; see the source for the three passes. The output pass
runs on the tensor cores for blocks of up to `MMA_MAX_L` samples (x·h as
3×TF32 m16n8k8 ``mma.sync``, s·G as fp64 m16n8k4) and on the CUDA cores
(fp32 FFMA, fp64 FMA) for longer ones (`output_pass`). The wide banks
(`keeps_state_on_chip`: blocks of up to `MMA_MAX_L`, at least
`WIDE_LANES_A_BAND` lanes a band and `WIDE_LANES` in all) keep each block's
state on the chip: only the
state entering each tile of `TILE` blocks goes to device memory, and the
output pass walks the tile itself. The same kernel, with one band and a
start state, is the blocked-IIR lead (`cuda_iir`), through `launch`.

`iir_block.sosfilt_bank_apply_planes` chooses by `_config.use_kernel`
("bank"): a float32 CUDA tensor goes to `sosfilt_bank_lead_cuda` outside
`_config.kernels_off()`; CPU tensors and other dtypes take
`sosfilt_bank_lead_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda

# kernel launches since the last reset (read by run reports)
launches = 0
# of those, the launches that kept the block states on the chip
# (`keeps_state_on_chip`), counted by `launch`
state_on_chip = 0

# real state lanes the kernel's chain holds: one per lane of a warp
MAX_LANES = 32

# longest block whose output pass runs on the tensor cores (one 128-column
# tile of h's Toeplitz operator)
MMA_MAX_L = 128

# fewest band-lanes (bands x real state lanes) and fewest lanes a band that
# keep the block states on the chip, and the blocks of a row per tile there
# (the kernel's tile). Measured on the H100 (PERF.md §6): at 8 lanes a band
# and 16 band-lanes or more the wide route was as fast as the three passes
# or faster (to 0.55x); with 4-6 lanes a band, or one band of 8-12 lanes, it
# was as fast or up to 19 % slower on many rows
WIDE_LANES = 16
WIDE_LANES_A_BAND = 8
TILE = 64

_c = ctypes.c_void_p
_KERNEL = _cuda.Kernel(
    "iir_bank", "dsptb_iir_bank_f32",
    [_c] * 11 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_longlong, _c],
    "IIR bank kernel",
)


def _chunk(K: int) -> int:
    """Chunk length F of the kernel's state chain: serial depth ~2F + K/F,
    least at F = sqrt(K/2)."""
    return max(1, math.ceil(math.sqrt(K / 2)))


def keeps_state_on_chip(L: int, n_bands: int, lanes: int) -> bool:
    """Whether a launch at block length ``L`` over ``n_bands`` bands of
    ``lanes`` real state lanes takes the kernel's wide route, which writes
    no block state to device memory: blocks of up to `MMA_MAX_L` (the
    tensor-core output pass), at least `WIDE_LANES_A_BAND` lanes a band and
    `WIDE_LANES` in all (the filter banks, the chain's crossover, leads of 8
    sections or more). Below that, each tile's walk has too little work
    beside it, and the three passes' state buffer is small."""
    return L <= MMA_MAX_L and lanes >= WIDE_LANES_A_BAND and n_bands * lanes >= WIDE_LANES


def output_pass(L: int) -> str:
    """The output pass the kernel takes at block length ``L``: "mma" (the
    tensor cores) or "ffma" (the CUDA cores)."""
    return "mma" if L <= MMA_MAX_L else "ffma"


def sosfilt_bank_lead_plain(ops: dict, x: torch.Tensor, out: torch.Tensor,
                            s0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: band-batched einsums and the log-depth
    doubling prefix of the block-boundary states.

    ``ops``: device operators (`iir_block.operators_to_torch`) with
    ``n_full`` = K and ``L``; ``x (R, T)`` real; ``s0 (B, R, N)``, the state
    before block 0 (zero when None); writes the real (and, for a complex
    bank, imaginary) parts of the first K·L samples of every band into
    ``out (P, B, R, T)``. Returns the state after block K, ``(B, R, N)`` in
    the state dtype.
    """
    HmatT, GyT = ops["HmatT"], ops["GyT"]  # (B,L,L) (B,N,L)
    L, n_full = ops["L"], ops["n_full"]
    R = x.shape[0]
    n_bands = HmatT.shape[0]
    xb = x[:, : n_full * L].reshape(R, n_full, L).to(HmatT.dtype)
    y_free = torch.einsum("rkl,blm->brkm", xb, HmatT)
    s_starts, s_end = block_states(ops, xb, s0)
    y = y_free.to(GyT.dtype) + torch.einsum("brkn,bnl->brkl", s_starts, GyT)
    y = y.to(HmatT.dtype).reshape(n_bands, R, n_full * L)
    lead = out[..., : n_full * L]
    if y.is_complex():
        lead[0] = y.real
        lead[1] = y.imag
    else:
        lead[0] = y
    return s_end


def block_states(ops: dict, xb: torch.Tensor, s0: torch.Tensor | None = None) -> tuple:
    """The states of `sosfilt_bank_lead_plain`'s blocks by the log-depth
    doubling prefix: for blocks ``xb (R, K, L)`` and the start state ``s0
    (B, R, N)`` (zero when None), ``(starts, end)``: the state entering
    every block, ``(B, R, K, N)``, and the state after block K, ``(B, R,
    N)``, in the state dtype."""
    MT = ops["MT"]  # (B, L, N)
    X = torch.einsum("rkl,bln->brkn", xb.to(MT.dtype), MT)  # (B, R, K, N)
    if s0 is not None:
        # the start state rides through the prefix in the first injection
        s0 = s0.to(X.dtype)
        X[..., 0, :] += torch.einsum("brn,bnm->brm", s0, ops["ALT"])
    # X_k = sum_{j<=k} A^{k-j} v_j: the log-depth doubling prefix
    ALt_pow = ops["ALT"]  # (B, N, N)
    shift = 1
    while shift < X.shape[-2]:
        upd = torch.einsum("brkn,bnm->brkm", X[..., :-shift, :], ALt_pow)
        X = torch.cat([X[..., :shift, :], X[..., shift:, :] + upd], dim=-2)
        ALt_pow = torch.einsum("bnm,bmp->bnp", ALt_pow, ALt_pow)
        shift *= 2
    # block k sees X_{k-1}; block 0 the start state
    first = torch.zeros_like(X[..., :1, :]) if s0 is None else s0.unsqueeze(-2)
    return torch.cat([first, X[..., :-1, :]], dim=-2), X[..., -1, :]


def kernel_operators(ops: dict) -> dict:
    """The kernel's real form of device operators ``ops`` (float32
    ``HmatT``, float64 or complex128 ``GyT``/``ALT``/``MT``).

    ``h (P, B, L)`` float32 is row 0 of ``HmatT`` (the in-block impulse
    response). A complex bank's state ``s = [Re s, Im s]`` gives
    ``A = [[Ar, Ai], [-Ai, Ar]]``, ``M = [Mr, Mi]`` and the planes
    ``G_re = [Gr; -Gi]``, ``G_im = [Gi; Gr]``. ``M`` is laid out
    ``(L, B·Ns)``: column ``b·Ns + n`` is lane n of band b. Where the bank
    keeps its states on the chip (`keeps_state_on_chip`), ``W`` holds its
    `tile_operators`, and `launch` takes the wide route.
    """
    H, G, A, M = ops["HmatT"], ops["GyT"], ops["ALT"], ops["MT"]
    n_bands, L = H.shape[0], H.shape[-1]
    h = H[:, 0, :]
    if H.is_complex():
        h = torch.stack([h.real, h.imag])
        G = torch.stack([torch.cat([G.real, -G.imag], 1), torch.cat([G.imag, G.real], 1)])
        A = torch.cat([torch.cat([A.real, A.imag], 2), torch.cat([-A.imag, A.real], 2)], 1)
        M = torch.cat([M.real, M.imag], 2)
    else:
        h, G = h[None], G[None]
    lanes = A.shape[-1]
    A, M = A.to(torch.float64).contiguous(), M.to(torch.float64)  # (B, Ns, Ns), (B, L, Ns)
    kops = {
        "h": h.to(torch.float32).contiguous(),
        "G": G.to(torch.float64).contiguous(),
        "A": A,
        "M": M.permute(1, 0, 2).reshape(L, n_bands * lanes).contiguous(),
        "lanes": lanes,
    }
    if keeps_state_on_chip(L, n_bands, lanes):
        kops["W"] = tile_operators(A)
    return kops


def tile_operators(A: torch.Tensor) -> torch.Tensor:
    """``W (B, 6·Ns, Ns)`` of the wide route for the real-form ``A (B, Ns,
    Ns)`` float64: per band ``[A^3; A^2; A; I; A^4; A^64]``. The first four
    take 4 blocks' injections to one super-block's, A^4 steps a super-block
    and A^64 a tile of `TILE` blocks (the kernel's tile)."""
    A2 = A @ A
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    return torch.cat([A2 @ A, A2, A, eye, A2 @ A2, torch.linalg.matrix_power(A, TILE)],
                     1).contiguous()


def launch(kops: dict, x: torch.Tensor, out: torch.Tensor, K: int,
           s0: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the kernel on the real form ``kops`` (`kernel_operators`)
    for the first K blocks of ``x (R, ·)`` (unit time stride) into ``out
    (P, B, R, ·)`` (unit time stride, rows contiguous per plane and band),
    from ``s0 (B, R, Ns)`` float64 or zero. Returns zf ``(B, R, Ns)``
    float64. The route is ``kops``': the wide one where it holds ``W``
    (`tile_operators`), else the three passes. Checks nothing and counts
    only `state_on_chip`: its callers check and count `launches`."""
    global state_on_chip
    h, G, A, M, Ns = kops["h"], kops["G"], kops["A"], kops["M"], kops["lanes"]
    W = kops.get("W")
    P, n_bands, L = h.shape
    R = x.shape[0]
    on_chip = W is not None
    F = TILE if on_chip else _chunk(K)
    # one float64 allocation (a call's host time is of the order of its
    # device time): vs (R·K, B·Ns), none on the wide route; carry (B·R,
    # ceil(K/F), Ns); zf (B, R, Ns)
    n_vs = 0 if on_chip else R * K * n_bands * Ns
    n_carry = n_bands * R * -(-K // F) * Ns
    buf = torch.empty(n_vs + n_carry + n_bands * R * Ns, dtype=torch.float64, device=x.device)
    zf = buf[n_vs + n_carry:].view(n_bands, R, Ns)
    vs = buf.data_ptr()
    _KERNEL.launch(x.get_device(), x.data_ptr(), h.data_ptr(), M.data_ptr(), A.data_ptr(),
                   G.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
                   None if on_chip else vs, vs + 8 * n_vs, zf.data_ptr(),
                   W.data_ptr() if on_chip else None, n_bands, R, K, L, Ns, P, F,
                   x.stride(0), out.stride(2))
    state_on_chip += on_chip
    return zf


def sosfilt_bank_lead_cuda(ops: dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the same result as `sosfilt_bank_lead_plain`. ``x``
    float32 with unit stride along time, ``out`` float32 contiguous, both on
    one CUDA device; any block length L up to ~30,000, at most `MAX_LANES`
    real state lanes."""
    global launches
    if not (x.is_cuda and out.is_cuda and out.device == x.device):
        raise ValueError("sosfilt_bank_lead_cuda needs x and out on one CUDA device")
    if x.dtype != torch.float32 or out.dtype != torch.float32 or x.is_complex():
        raise TypeError("sosfilt_bank_lead_cuda takes real float32 x and out")
    kops = ops.get("kernel") or kernel_operators(ops)
    h, G, A, M, Ns = kops["h"], kops["G"], kops["A"], kops["M"], kops["lanes"]
    if Ns > MAX_LANES:
        raise ValueError(
            f"the kernel holds at most {MAX_LANES} real state lanes, got {Ns}: take "
            "the stages of `iir_block.bank_kernel_stages`, which split longer "
            "cascades"
        )
    if not all(t.device == x.device for t in (h, G, A, M)):
        raise ValueError("the bank's operators lie on another device than x")
    P, n_bands, L = h.shape
    K = ops["n_full"]
    R, T = x.shape
    if x.ndim != 2 or x.stride(1) != 1 or K < 1 or K * L > T:
        raise ValueError("x must be (R, T) with unit time stride and T >= K·L")
    if tuple(out.shape) != (P, n_bands, R, T) or not out.is_contiguous():
        raise ValueError(f"out must be contiguous {(P, n_bands, R, T)}")
    zf = launch(kops, x, out, K)
    launches += 1
    if P == 2:
        N = Ns // 2
        return torch.complex(zf[..., :N], zf[..., N:])
    return zf
