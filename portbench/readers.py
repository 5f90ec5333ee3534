"""Arithmetic the per-layer readers share (``metrics/<metric>.py`` each
calls one of these on the run's record).  A reader that finds nothing to
read returns ``None``, and the metric is left out of the result line."""

from __future__ import annotations

from statistics import mean
from typing import Optional

from portbench import flops
from portbench.trace import KERNEL_RANGES, PREFIX


def trace(run: dict) -> Optional[dict]:
    """The stretch that traced the device alone (the host at its pace)."""
    return run.get("trace")


def host_trace(run: dict) -> Optional[dict]:
    """The stretch that traced the host's operations and ranges as well."""
    return run.get("host_trace")


def mean_ms(values) -> Optional[float]:
    return mean(values) * 1e3 if values else None


def roofline_pct(run: dict, keys) -> Optional[float]:
    """Sum of the calls' bounds over the device time of the kernels launched
    under their ranges, in percent."""
    tr = host_trace(run)
    if tr is None:
        return None
    spent = sum(tr["range_device_s"].get(PREFIX + KERNEL_RANGES[k], 0.0) for k in keys)
    bound = sum(run["kernel_bound_s"].get(k, 0.0) for k in keys)
    if spent <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / spent


def idle_pct(run: dict) -> Optional[float]:
    tr = trace(run)
    if tr is None or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(run: dict, flops_done: float, seconds: float) -> Optional[float]:
    if flops_done <= 0.0 or seconds <= 0.0:
        return None
    return 100.0 * flops_done / seconds / flops.PEAK_FLOPS[run["precision"]]
