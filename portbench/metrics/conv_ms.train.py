"""Device milliseconds a train step in the kernels launched under the
convolution ops (cuDNN's forward and backward), from the steps of the
host-and-device stretch."""

from portbench import readers
from portbench.trace import CONV_OPS


def read(run):
    tr = readers.host_trace(run)
    if tr is None or not run["profiled_steps"]:
        return None
    spent = sum(tr["range_device_s"].get(op, 0.0) for op in CONV_OPS)
    return spent / run["profiled_steps"] * 1e3 if spent > 0.0 else None
