"""Device operations (kernels, copies, sets) a train step, from the
steps of the device-only stretch."""

from portbench import readers


def read(run):
    tr = readers.trace(run)
    if tr is None or tr["window_s"] <= 0.0 or not run["profiled_steps"]:
        return None
    return tr["device_ops"] / run["profiled_steps"]
