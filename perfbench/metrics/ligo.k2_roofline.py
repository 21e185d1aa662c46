"""K2's share of its roofline over the traced LiGO steps: the least time of
its calls, from their operand shapes, over the device time of the
kernels they launched."""
from perfbench import readers


def read(run):
    return readers.kernel_roofline(run, readers.K2_OPS)
