"""The Welch CSM's Gram product: ``Q[f, a, b] = mean_k conj(X[a, k, f])
X[b, k, f]`` of the rFFT's frame spectra ``X (C, K, F)``, with an exactly
real diagonal (`ops.spectral.csm_welch`, ``average="mean"``).

Replaces no Pallas kernel: the JAX package leaves this step to XLA
(``jnp.einsum("akf,bkf->fab", ...)``, `dsptoolbox_tpu/ops/spectral.py:285`).
The plain version copies X into ``(F, C, K)`` for one batched cuBLAS
product: at the session's 32 channels × 5,624 frames × 513 bins that copy
moves 1.48 GB and the product reads the 739 MB once more and computes both
triangles.

What bounds it on the H100: X's bytes and the upper triangle's fp32 FFMA
work, of one order (0.22 and 0.18 ms at the session's shape). The kernel
(`csrc/csm.cu`) reads X where it lies, once per group of channel pairs
(once at 32 channels), a warp's lanes on consecutive bins, and keeps each
lane's pair sums in registers; runs of frames are spread over the card's
SMs and their sums added by a second pass in a fixed order, so a call
repeats bit for bit. The launch plan (`plan`) follows from the shape and
the card alone.

`gram_mean` dispatches by `_config.use_kernel` ("csm"): a complex64 CUDA
tensor goes to the kernel outside `_config.kernels_off()`; CPU tensors and
complex128 take the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _config, _cuda

# calls of the kernel's entry point (a Gram pass and a reduce pass each)
# since the last reset (read by run reports)
launches = 0

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_KERNEL = _cuda.Kernel(
    "csm", "dsptb_csm_gram_c64", [_c, _c, _c, _ll, _ll, _ll, _ll, _ll, _c],
    "csm gram kernel",
)


@functools.lru_cache(maxsize=64)
def plan(C: int, K: int, F: int, index: int) -> tuple[int, int]:
    """``(teams, scratch)`` of a ``(C, K, F)`` product on CUDA device
    ``index``: the kernel's teams (one wave over the card's SMs) and its
    scratch in complex64 values."""
    fn = _cuda.load("csm").dsptb_csm_plan
    fn.argtypes = [_ll, _ll, _ll, ctypes.POINTER(_ll)]
    fn.restype = ctypes.c_int
    out = (_ll * 2)()
    with torch.cuda.device(index):
        _cuda.check(fn(C, K, F, out), "csm gram plan")
    return int(out[0]), int(out[1])


def real_diagonal(Q: torch.Tensor) -> torch.Tensor:
    """The Gram product ``Q (F, C, C)`` with an exact-real diagonal, like
    the reference's |X|² autospectrum branch: the product's diagonal is
    Σ|y|² in its real part."""
    eye = torch.eye(Q.shape[-1], dtype=Q.real.dtype, device=Q.device)
    return Q * (1 - eye) + Q.diagonal(dim1=-2, dim2=-1).real[..., None] * eye


def gram_mean_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``X (C, K, F)`` → ``Q (F, C, C)``. With Y = X
    as ``(F, C, K)`` (one layout copy), ``Q[f, a, b] = (Y Yᴴ)[f, b, a] /
    K``; the batched product reads Yᴴ as a conjugate-transposed view."""
    K = X.shape[-2]
    Y = X.permute(2, 0, 1).contiguous()
    return real_diagonal(torch.matmul(Y, Y.mH).transpose(-1, -2) / K)


def gram_mean_cuda(X: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the same ``Q`` as `gram_mean_plain`, Hermitian by
    construction, from one read of X per channel-pair group. complex64 CUDA
    tensors only."""
    global launches
    index = X.get_device()
    if index < 0:
        raise ValueError("gram_mean_cuda needs X on a CUDA device")
    if X.dtype != torch.complex64:
        raise TypeError("gram_mean_cuda takes complex64 tensors")
    if X.ndim != 3:
        raise ValueError(f"gram_mean_cuda takes X (C, K, F), got shape {tuple(X.shape)}")
    C, K, F = X.shape
    Q = X.new_empty((F, C, C))
    if Q.numel() == 0:
        return Q
    if not X.is_contiguous():
        X = X.contiguous()
    teams, scratch = plan(C, K, F, index)
    part = X.new_empty(scratch)
    _KERNEL.launch(index, X.data_ptr(), Q.data_ptr(), part.data_ptr(), C, K, F, teams, scratch)
    launches += 1
    return Q


def gram_mean(X: torch.Tensor) -> torch.Tensor:
    """``Q[f, a, b] = mean_k conj(X[a, k, f]) X[b, k, f]`` of ``X (C, K,
    F)`` → ``(F, C, C)``, with an exactly real diagonal."""
    if _config.use_kernel("csm", X):
        return gram_mean_cuda(X)
    return gram_mean_plain(X)
