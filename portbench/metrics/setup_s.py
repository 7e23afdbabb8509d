"""Set-up time: process start to the first timed call (imports, the CUDA
context, the inputs, the designs and operators, the warm-up; the first run
in a checkout also builds the kernels)."""


def read(run):
    return run.setup_s
