"""The delay-and-sum beamforming map: steering build + quadratic form.

``map[g, f] = Re(h^H C_f h)`` with ``h[f, m, g] = amp[m, g] e^{-i k_f
diff[m, g]}``, for ``amp, diff (M, G)``, wave numbers ``k (F,)`` and the CSM
as real and imaginary parts ``(F, M, M)``. Returns ``(G, F)``.

Replaces the Pallas kernel ``das_map_fused`` / ``_das_kernel``
(`dsptoolbox_tpu/ops/pallas_das.py`), which built the steering tensor in
VMEM and ran the packed-real 2M×2M quadratic form on the MXU, laid out for
lane occupancy (M on sublanes, G padded to 128 lanes) with a rotation
recurrence to save transcendentals.

On the H100 the work is 4·M² fp32 FMAs per (g, f) against M ``sincosf``
for the steering, so the quadratic form is the cost (the steering is 1/64
of it at M = 64): at F = 513, M = 64, G = 900 it is 7.6 G FMA. It runs in
fp32 FFMA, no tensor cores or TF32 (the JAX kernel runs at
``Precision.HIGHEST``). What bounds it is feeding the FMA pipe from shared
memory: every FMA takes a CSM element and a steering element from there,
and at the path's shapes (10-30 bins) there are few blocks to hide the
latency of those loads. The kernel (`csrc/das_map.cu`) gives each block 64
grid points of one bin and 256 threads: the block builds its points'
steering once in shared memory and stages a tile of C_f, transposed, beside
it; four groups of 64 threads each take a quarter of C's rows, a thread
one grid point, and keep eight rows of ``t = C_f h`` in registers, so one
128-bit broadcast load of C feeds four rows and one steering element 32
FMAs; the groups' partial sums are added at the end. C_f is staged and h
built in tiles of up to 64 mics, so every M is taken: for M above 64 the
steering of a column tile is recomputed per row tile (M²/64 extra
``sincosf`` per point). Phases are exact ``sincosf`` per element (they
reach ~70 rad at 8 kHz over half a metre), which is what the plain version
computes, so the JAX kernel's ``uniform_grid`` rotation recurrence has no
counterpart. C is not assumed Hermitian.

The plain version (`das_map_plain`, the JAX package's `_das_map_core`)
materialises the packed steering ``hp (F, G, 2M)`` (236 MB at the sizes
above) and runs the quadratic form as a batched fp32 GEMM.

`das_map` dispatches: a float32 CUDA tensor goes to the kernel unless the
switch (`_config.set_das_kernel`) is "off"; CPU tensors take the plain
version, float64 tensors too unless the switch is "on", which raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _config, _cuda

# kernel launches since the last reset (read by run reports)
launches = 0

_c = ctypes.c_void_p
_KERNEL = _cuda.Kernel("das_map", "dsptb_das_map_f32",
                       [_c] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, _c], "DAS map kernel")


def packed_quadratic_from_hp(hp, c_re, c_im):
    """``map[g, f] = p^T B p`` for a prebuilt packed steering factor
    ``hp (F, G, 2M) = [Re h | Im h]`` and split matrix ``C (F, M, M)``:
    with ``B = [[Cre, -Cim], [Cim, Cre]]``, ``Re(h^H C h) = p^T B p``
    exactly (no Hermitian assumption needed)."""
    B = torch.cat(
        [torch.cat([c_re, -c_im], dim=-1), torch.cat([c_im, c_re], dim=-1)],
        dim=-2,
    )  # (F, 2M, 2M)
    t = torch.bmm(hp, B)  # (F, G, 2M)
    return (hp * t).sum(dim=-1).T


def das_map_plain(amp, diff, k, csm_re, csm_im):
    """Plain PyTorch version: the steering tensor built in full, then the
    packed-real quadratic form (`beamforming._das_map_core`)."""
    ph = k[:, None, None] * diff.T[None]  # (F, G, M)
    amp_t = amp.T[None]
    hp = torch.cat(
        [amp_t * torch.cos(ph), -amp_t * torch.sin(ph)], dim=-1
    )  # (F, G, 2M) = [Re h | Im h]
    return packed_quadratic_from_hp(hp, csm_re, csm_im)


def das_map_cuda(amp, diff, k, csm_re, csm_im):
    """CUDA kernel: the same map as `das_map_plain`. float32 tensors on one
    CUDA device; any M, G and F."""
    global launches
    tensors = (amp, diff, k, csm_re, csm_im)
    if not all(t.is_cuda and t.device == amp.device for t in tensors):
        raise ValueError("das_map_cuda needs all tensors on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("das_map_cuda takes float32 tensors")
    M, G = amp.shape
    F = k.shape[0]
    if (diff.shape != (M, G) or k.ndim != 1 or csm_re.shape != (F, M, M)
            or csm_im.shape != (F, M, M)):
        raise ValueError(
            "shapes must be amp, diff (M, G), k (F,), csm_re, csm_im (F, M, M)"
        )
    out = torch.empty((G, F), dtype=torch.float32, device=amp.device)
    if out.numel() == 0 or M == 0:
        return out.zero_()
    amp, diff, k, csm_re, csm_im = (t.contiguous() for t in tensors)
    _KERNEL.launch(amp.get_device(), amp.data_ptr(), diff.data_ptr(), k.data_ptr(),
                   csm_re.data_ptr(), csm_im.data_ptr(), out.data_ptr(), M, G, F)
    launches += 1
    return out


def das_map(amp, diff, k, csm_re, csm_im):
    """DAS map ``(G, F)`` of steering factors ``amp, diff (M, G)``, wave
    numbers ``k (F,)`` and CSM parts ``(F, M, M)``."""
    mode = _config.das_kernel()
    if mode != "off" and csm_re.dtype != torch.float32:
        if mode == "on":
            raise ValueError(
                "the DAS map kernel is switched 'on' but takes float32 "
                f"tensors, got {csm_re.dtype}"
            )
        return das_map_plain(amp, diff, k, csm_re, csm_im)
    if _config.use_kernel(mode, csm_re):
        return das_map_cuda(amp, diff, k, csm_re, csm_im)
    return das_map_plain(amp, diff, k, csm_re, csm_im)
