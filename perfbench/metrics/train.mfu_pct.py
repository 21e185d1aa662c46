"""The train step's share of the bf16 peak: the operations the steps of
the traced run's untraced window require (the model's forward and
backward) over that window's host seconds."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
