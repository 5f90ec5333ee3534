"""Kernels #1 and #2 (the fused transformer block, forward and backward) in
training: the sum of their calls' bounds over their device time, percent."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, ("k1", "k2"))
