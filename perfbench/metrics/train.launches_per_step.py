"""Kernel launches a train step makes, as the trace records them."""
from perfbench import readers


def read(run):
    return readers.launches(run)
