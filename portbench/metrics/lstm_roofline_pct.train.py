"""Kernels #3 and #4 (the LSTM recurrence forward, and its backward with
``dwhh``) in training: the sum of their calls' bounds over their device
time, percent."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, ("k3", "k4"))
