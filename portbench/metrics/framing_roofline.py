"""Kernel B1's share of its roofline: the least time the framing's work of
a call needs (`roofline.framing`: the larger of the bytes at the memory
rate and the operations at the float32 peak) over ``framing.cu``'s device
time a call."""

from portbench.roofline import describe, kernel_share

KERNELS = ("frames_warp_kernel", "frames_block_kernel")
WORK = "framing"


def read(run):
    got = kernel_share(run, KERNELS, WORK)
    return None if got is None else got[0]


def note(run):
    return describe(run, KERNELS, WORK)
