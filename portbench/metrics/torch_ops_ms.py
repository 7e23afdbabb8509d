"""Device time a call in every operation that is not one of the port's
hand-written kernels (``dsptoolbox_tpu_torch/csrc/*.cu``): cuFFT, copies,
elementwise work, reductions, library products."""

HAND_KERNELS = (
    "frames_warp_kernel", "frames_block_kernel",
    "bank_inject_kernel", "bank_inject_mma_kernel", "chain_local_kernel",
    "chain_carry_kernel", "chain_expand_kernel", "bank_out_kernel", "bank_out_mma_kernel",
    "banded_kernel", "das_map_kernel", "ema_kernel",
)


def read(run):
    t = run.trace
    if t is None:
        return None
    return t.seconds_except(HAND_KERNELS) / t.n_calls * 1e3
