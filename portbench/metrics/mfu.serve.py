"""The EEG encoder's operations a window times the windows of the dispatches
outside the profiled stretches, over those dispatches' host-clock seconds in
the session's ``embed_eeg``, as a share of the peak of the configuration's
precision, percent: the whole forward's share of the chip while it serves."""

from portbench import readers


def read(run):
    return readers.mfu_pct(run, run["flops_per_window"] * run["dispatched_windows"],
                           run["dispatch_s"])
