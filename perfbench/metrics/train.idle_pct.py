"""The share of the training window traced on the device alone in which
nothing ran on the device."""
from perfbench import readers


def read(run):
    return readers.idle(run)
