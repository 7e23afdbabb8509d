"""Kernel B3's share of its roofline: the least time the filter banks'
work of a call needs (`roofline.sos_bank`: the larger of the bytes at the
memory rate and the operations at the float32 peak) over ``iir_bank.cu``'s
device time a call."""

from portbench.roofline import describe, kernel_share

KERNELS = ("bank_inject_kernel", "bank_inject_mma_kernel", "chain_local_kernel",
           "chain_carry_kernel", "chain_expand_kernel", "bank_out_kernel", "bank_out_mma_kernel")
WORK = "iir_bank"


def read(run):
    got = kernel_share(run, KERNELS, WORK)
    return None if got is None else got[0]


def note(run):
    return describe(run, KERNELS, WORK)
