"""The LiGO step's share of the bf16 peak: the operations the steps of the
traced run's untraced window require (the target's forward and backward,
the operator's grow and its backward) over that window's host seconds."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
