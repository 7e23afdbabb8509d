"""The delay-and-sum beamforming map: steering build + quadratic form.

``map[g, f] = Re(h^H C_f h)`` with ``h[f, m, g] = amp[m, g] e^{-i k_f
diff[m, g]}``, for ``amp, diff (M, G)``, wave numbers ``k (F,)`` and the CSM
as real and imaginary parts ``(F, M, M)``. Returns ``(G, F)``.

Replaces the Pallas kernel ``das_map_fused`` / ``_das_kernel``
(`dsptoolbox_tpu/ops/pallas_das.py`), which built the steering tensor in
VMEM and ran the packed-real 2M×2M quadratic form on the MXU, laid out for
lane occupancy (M on sublanes, G padded to 128 lanes) with a rotation
recurrence to save transcendentals.

On the H100 the function needs, per (g, f), M exact ``sincosf`` for the
steering and, since ``Re(hᴴCh) = hᴴ C_H h`` with ``C_H = (C + Cᴴ)/2`` for
any C, 2·M² + 2·M fp32 FMAs over C_H's upper triangle: at F = 513, M = 64,
G = 900 3.8 G FMA, at the DAS path's 10 and 30 bins 75 and 225 M. That is
operations-bound (0.1147 ms at the sweep at 67 TFLOP/s FFMA; 2.2 and 6.7
µs at 10 and 30 bins), and at the path's shapes a few µs of work that only
many warps in flight can cover. The kernel (`csrc/das_map.cu`) gives each
block one bin and 32 grid points (64 where the grid has ≥ 1024 such
blocks, the sweep, where a block also takes three point tiles of its bin),
8 warps. It stages C_f's mic tiles with 16-byte ``cp.async`` along C's rows
(4-byte where M % 4 ≠ 0), issued before the steering build, folds each tile
pair into D = C + Cᴴ's upper triangle in shared memory, and splits the
triangle's steps (row block of 8 rows × column) into 8 equal runs, one a
warp: a thread keeps 8 complex rows of ``t = D h`` in registers, and per
column four 128-bit broadcast loads of D feed 32 FMAs a point. The warps'
sums are added in a fixed order: two launches give bit-identical maps.
M ≤ 64 is one tile of up to 64 mics; M > 64 takes tiles of 32, the next
pair's copies double-buffered behind the current product, the steering of
every mic resident while the padded M is ≤ 256 (`RESIDENT_MAX`), rebuilt
per pair beyond. At 10 bins this is 290 blocks of 8 warps, at least 16
warps an SM. fp32 FFMA, exact ``sincosf`` per element (phases reach ~70
rad at 8 kHz over half a metre), which is what the plain version computes,
so the JAX kernel's ``uniform_grid`` rotation recurrence has no
counterpart; no tensor cores (the JAX kernel runs at
``Precision.HIGHEST``).

What bounds it (`tools/das_phases.py`, device µs a launch from CUDA graphs;
NVIDIA H100 80GB HBM3, 700.00 W): at 10 bins 14.9 µs, of it the product
6.2, the loads of C_f, amp and diff and the sums 4.3, the fold 2.1,
``sincosf`` 0.8, the launch 1.5; at 30 bins 29.0 µs (product 11.7, loads
10.3); at the sweep 317 µs (product 209, about 60 % of the FFMA rate with
the diagonal tiles' zeros, loads 65, ``sincosf`` 34). Each block reads its
bin's C_f and its points' amp and diff from L2, and at 10-30 bins the
blocks start in step, so those loads and the barriers between the phases
are latency nothing hides. Three alternatives measured no faster on the
card: C_f staged once for a cluster of 2 or 4 blocks and shared through
distributed shared memory, half the block staging and folding C_f while
the other half builds the steering, and two points a thread on 32-point
tiles (16 runs a point; `PERF.md` §6).

`design` mirrors the kernel's choice of tiles and split, `unit_steps` a
warp's run of a tile's steps; `kernel_design` asks the built kernel for its
plan and occupancy on the card.

The plain version (`das_map_plain`, the JAX package's `_das_map_core`)
materialises the packed steering ``hp (F, G, 2M)`` (236 MB at the sizes
above) and runs the quadratic form as a batched fp32 GEMM.

`das_map` dispatches by `_config.use_kernel` ("das"): a float32 CUDA tensor
goes to the kernel outside `_config.kernels_off()`; CPU tensors and float64
take the plain version.
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

# the kernel's constants (csrc/das_map.cu)
WARPS = 8  # a block; each warp a run of a tile's steps
ROWS = 8  # rows of a register block
MULTI_R = 32  # mic tile for M > 64
RESIDENT_MAX = 256  # padded M up to which the steering stays resident
P2_MIN_BLOCKS = 1024  # blocks of 64 points for two points a thread
TARGET_BLOCKS = 2048  # fewest blocks of several point tiles
_DESIGN_KEYS = ("R", "P", "points", "warps", "mic_tiles", "pairs", "tiles_per_block",
                "resident", "smem_bytes", "blocks", "blocks_per_sm")


def design(M, G, F):
    """The kernel's plan for (M, G, F), as `csrc/das_map.cu` makes it: mic
    tile ``R``, points a thread ``P``, points of a point tile, warps a
    block, mic tiles and tile pairs, point tiles a block (several, C_f
    staged and folded once, only with one mic tile and where the grid keeps
    `TARGET_BLOCKS` blocks), whether the steering stays resident, shared
    bytes a block and blocks."""
    if M > 64:
        R, P = MULTI_R, 1
    else:
        R = next(r for r in (8, 16, 32, 64) if M <= r)
        P = 2 if R == 64 and -(-G // 64) * F >= P2_MIN_BLOCKS else 1
    n = -(-M // R)
    resident = n * R <= RESIDENT_MAX
    tiles = 2 if n > 1 else 1
    h_rows = n * R if resident else 2 * R
    floats = WARPS * 32 * P + 2 * h_rows * 32 * P + tiles * tiles * 2 * R * (R + 4)
    n_gtiles = -(-G // (32 * P))
    per_block = min(max(n_gtiles * F // TARGET_BLOCKS, 1), n_gtiles) if n == 1 else 1
    return {"R": R, "P": P, "points": 32 * P, "warps": WARPS, "mic_tiles": n,
            "pairs": n * (n + 1) // 2, "tiles_per_block": per_block, "resident": resident,
            "smem_bytes": 4 * floats, "blocks": -(-n_gtiles // per_block) * F}


def unit_steps(R, diag, unit):
    """Warp ``unit``'s run of a tile's steps as segments ``(b, c0, c1)``: row
    block ``b`` (rows ``8b .. 8b + 7`` of the tile), columns ``c0 .. c1 -
    1``. The steps are row block by row block, columns from ``8b`` on the
    diagonal tile (D is zero below it) or 0, to ``R - 1``; each of the
    `WARPS` warps takes an equal run."""
    nb = R // ROWS

    def start(b):
        return ROWS * b if diag else 0

    steps = 4 * nb * (nb + 1) if diag else ROWS * nb * nb
    s0 = unit * steps // WARPS
    rem = (unit + 1) * steps // WARPS - s0
    b, off = 0, s0
    while off >= R - start(b):
        off -= R - start(b)
        b += 1
    c, segs = start(b) + off, []
    while rem > 0:
        n = min(rem, R - c)
        segs.append((b, c, c + n))
        rem -= n
        b += 1
        c = start(b)
    return segs


def kernel_design(M, G, F):
    """`design` as the built kernel reports it on the current CUDA device,
    with ``blocks_per_sm`` from the occupancy calculator."""
    info = (ctypes.c_int * len(_DESIGN_KEYS))()
    fn = _cuda.load("das_map").dsptb_das_map_design
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.check(fn(M, G, F, info), "DAS map kernel design")
    out = dict(zip(_DESIGN_KEYS, info))
    out["resident"] = bool(out["resident"])
    return out


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
    dev = amp.get_device()  # -1 off the card
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError("das_map_cuda needs all tensors on one CUDA device")
    if any(t.dtype is not torch.float32 for t in tensors):
        raise TypeError("das_map_cuda takes float32 tensors")
    M, G = amp.shape
    F = k.shape[0]
    if (diff.shape != (M, G) or k.ndim != 1 or csm_re.shape != (F, M, M)
            or csm_im.shape != (F, M, M)):
        raise ValueError(
            "shapes must be amp, diff (M, G), k (F,), csm_re, csm_im (F, M, M)"
        )
    out = amp.new_empty((G, F))
    if out.numel() == 0 or M == 0:
        return out.zero_()
    if not all(t.is_contiguous() for t in tensors):
        amp, diff, k, csm_re, csm_im = (t.contiguous() for t in tensors)
    _KERNEL.launch(dev, amp.data_ptr(), diff.data_ptr(), k.data_ptr(),
                   csm_re.data_ptr(), csm_im.data_ptr(), out.data_ptr(), M, G, F)
    launches += 1
    return out


def das_map(amp, diff, k, csm_re, csm_im):
    """DAS map ``(G, F)`` of steering factors ``amp, diff (M, G)``, wave
    numbers ``k (F,)`` and CSM parts ``(F, M, M)``."""
    if _config.use_kernel("das", csm_re):
        return das_map_cuda(amp, diff, k, csm_re, csm_im)
    return das_map_plain(amp, diff, k, csm_re, csm_im)
