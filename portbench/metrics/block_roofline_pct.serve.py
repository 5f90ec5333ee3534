"""Kernel #1 in eval (the fused transformer block's forward) while serving:
the sum of its calls' bounds over its device time, percent."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, ("k1",))
