"""Kernel launches a LiGO step makes, as the trace records them."""
from perfbench import readers


def read(run):
    return readers.launches(run)
