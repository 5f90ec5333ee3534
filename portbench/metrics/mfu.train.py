"""The configuration's model operations a step (forward and backward, no
recompute) times the untraced steps, over their seconds, as a share of the
peak of the configuration's precision, percent."""

from portbench import readers


def read(run):
    return readers.mfu_pct(run, run["flops_per_step"] * run["steps"], run["untraced_s"])
