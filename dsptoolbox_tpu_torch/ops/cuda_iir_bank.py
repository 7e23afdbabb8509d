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
(fp32 FFMA, fp64 FMA) for longer ones (`output_pass`).

`iir_block.sosfilt_bank_apply_planes` chooses: a CUDA tensor goes to
`sosfilt_bank_lead_cuda` unless the switch (`_config.set_bank_kernel`) is
"off"; a CPU tensor takes `sosfilt_bank_lead_plain` (the switch "on" makes
it raise).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .cuda_iir import _chunk

# kernel launches since the last reset (read by run reports)
launches = 0

# real state lanes the kernel's chain holds: one per lane of a warp
MAX_LANES = 32

# longest block whose output pass runs on the tensor cores (one 128-column
# tile of h's Toeplitz operator)
MMA_MAX_L = 128

_c = ctypes.c_void_p
_ARGTYPES = [_c] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_longlong, _c]


def output_pass(L: int) -> str:
    """The output pass the kernel takes at block length ``L``: "mma" (the
    tensor cores) or "ffma" (the CUDA cores)."""
    return "mma" if L <= MMA_MAX_L else "ffma"


def sosfilt_bank_lead_plain(ops: dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: band-batched einsums and the log-depth
    doubling prefix of the block-boundary states.

    ``ops``: device operators (`iir_block.operators_to_torch`) with
    ``n_full`` = K and ``L``; ``x (R, T)`` real; writes the real (and, for a
    complex bank, imaginary) parts of the first K·L samples of every band
    into ``out (P, B, R, T)``. Returns the state after block K,
    ``(B, R, N)`` in the state dtype.
    """
    HmatT, GyT, MT = ops["HmatT"], ops["GyT"], ops["MT"]  # (B,L,L) (B,N,L) (B,L,N)
    L, n_full = ops["L"], ops["n_full"]
    R = x.shape[0]
    n_bands = HmatT.shape[0]
    xb = x[:, : n_full * L].reshape(R, n_full, L).to(HmatT.dtype)
    y_free = torch.einsum("rkl,blm->brkm", xb, HmatT)
    X = torch.einsum("rkl,bln->brkn", xb.to(MT.dtype), MT)  # (B, R, K, N)
    # X_k = sum_{j<=k} A^{k-j} v_j: the log-depth doubling prefix
    ALt_pow = ops["ALT"]  # (B, N, N)
    shift = 1
    while shift < n_full:
        upd = torch.einsum("brkn,bnm->brkm", X[..., :-shift, :], ALt_pow)
        X = torch.cat([X[..., :shift, :], X[..., shift:, :] + upd], dim=-2)
        ALt_pow = torch.einsum("bnm,bmp->bnp", ALt_pow, ALt_pow)
        shift *= 2
    # zero initial state: block k sees X_{k-1} (zeros for k=0)
    s_starts = torch.cat([torch.zeros_like(X[..., :1, :]), X[..., :-1, :]], dim=-2)
    y = y_free.to(GyT.dtype) + torch.einsum("brkn,bnl->brkl", s_starts, GyT)
    y = y.to(HmatT.dtype).reshape(n_bands, R, n_full * L)
    lead = out[..., : n_full * L]
    if y.is_complex():
        lead[0] = y.real
        lead[1] = y.imag
    else:
        lead[0] = y
    return X[..., -1, :]


def kernel_operators(ops: dict) -> dict:
    """The kernel's real form of device operators ``ops`` (float32
    ``HmatT``, float64 or complex128 ``GyT``/``ALT``/``MT``).

    ``h (P, B, L)`` float32 is row 0 of ``HmatT`` (the in-block impulse
    response). A complex bank's state ``s = [Re s, Im s]`` gives
    ``A = [[Ar, Ai], [-Ai, Ar]]``, ``M = [Mr, Mi]`` and the planes
    ``G_re = [Gr; -Gi]``, ``G_im = [Gi; Gr]``. ``M`` is laid out
    ``(L, B·Ns)``: column ``b·Ns + n`` is lane n of band b.
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
    return {
        "h": h.to(torch.float32).contiguous(),
        "G": G.to(torch.float64).contiguous(),
        "A": A.to(torch.float64).contiguous(),
        "M": M.to(torch.float64).permute(1, 0, 2).reshape(L, n_bands * lanes).contiguous(),
        "lanes": lanes,
    }


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
    F = _chunk(K)
    vs = torch.empty((R * K, n_bands * Ns), dtype=torch.float64, device=x.device)
    carry = torch.empty((n_bands * R, -(-K // F), Ns), dtype=torch.float64, device=x.device)
    zf = torch.empty((n_bands, R, Ns), dtype=torch.float64, device=x.device)
    fn = _cuda.function("iir_bank", "dsptb_iir_bank_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), h.data_ptr(), M.data_ptr(), A.data_ptr(), G.data_ptr(),
                 out.data_ptr(), vs.data_ptr(), carry.data_ptr(), zf.data_ptr(),
                 n_bands, R, K, L, Ns, P, F, x.stride(0), T, _cuda.stream_of(x))
    _cuda.check(err, "IIR bank kernel")
    launches += 1
    if P == 2:
        N = Ns // 2
        return torch.complex(zf[..., :N], zf[..., N:])
    return zf
