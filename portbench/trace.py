"""The benchmark's own tracing: host-clock spans around the calls into the
program's layers, ranges around its kernels #1-#4 with each call's bound,
and the reading of a ``torch.profiler`` trace.

Everything here runs only in a traced run (``--trace 1``), which profiles
two stretches of its window: one of the device alone (the idle share, the
device's operations) and one of the host and the device (the breakdown, the
kernel ranges, the convolutions); the end-to-end metrics come from runs
without it.  Spans are kept in memory as
``(name, start, end)`` on the host clock (``time.perf_counter``) and, under
the profiler, also open a ``record_function`` range named
``portbench.<name>`` so that the trace can say what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import flops as fl

PREFIX = "portbench."
# the program's kernels by the function that launches each, as ranges
KERNEL_RANGES = {"k1": "block_fwd", "k2": "block_bwd", "k3": "lstm_fwd", "k4": "lstm_bwd"}
# the cuDNN convolutions: the device time of kernels launched under these ops
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
NAME_CHARS = 160  # of an operation's name in the breakdown


class Spans:
    """Host-clock spans in memory."""

    def __init__(self) -> None:
        self.items: List[Tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        ctx = record_function(PREFIX + name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str, outside: Tuple[float, float] = (0.0, 0.0)) -> List[float]:
        """Durations of the spans ``name`` that do not overlap ``outside``."""
        lo, hi = outside
        return [t1 - t0 for n, t0, t1 in self.items if n == name and (t1 <= lo or t0 >= hi)]


class KernelWatch:
    """Wraps the program's launchers of kernels #1-#4 in ranges and, while
    ``recording``, adds each call's bound (seconds at the precision's peak)
    under the kernel's key."""

    def __init__(self, precision: str) -> None:
        self.precision = precision
        self.recording = False
        self.bound_s: Dict[str, float] = defaultdict(float)
        self._undo: list = []

    def _wrap(self, module, attr: str, key: str, bound) -> None:
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(PREFIX + KERNEL_RANGES[key]):
                out = fn(*args, **kwargs)
            if self.recording:
                self.bound_s[key] += bound(*args, **kwargs)
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def install(self) -> None:
        from transformer_clip_eeg_tpu_torch.ops import fused_block, lstm_scan

        p = self.precision

        def k1(x, params, num_heads, scale, drop=None, save=False):
            b, t, _ = x.shape
            return fl.bound_s(fl.block_fwd_flops(b, t), fl.block_fwd_bytes(b, t, save), p)

        def k2(x, params, g, saved, *rest, **kw):
            b, t, _ = x.shape
            return fl.bound_s(fl.block_bwd_flops(b, t), fl.block_bwd_bytes(b, t), p)

        def k3(xw, whh, return_c, save_gates):
            t, d, b, g4 = xw.shape
            return fl.bound_s(fl.lstm_fwd_flops(t, d, b, g4 // 4),
                              fl.lstm_fwd_bytes(t, d, b, g4 // 4, save_gates), p)

        def k4(whh, h, c, gates, g):
            t, d, b, hidden = h.shape
            return fl.bound_s(fl.lstm_bwd_flops(t, d, b, hidden),
                              fl.lstm_bwd_bytes(t, d, b, hidden), p)

        self._wrap(fused_block, "fused_block_forward_cuda", "k1", k1)
        self._wrap(fused_block, "fused_block_backward", "k2", k2)
        self._wrap(lstm_scan, "_launch_forward", "k3", k3)
        self._wrap(lstm_scan, "lstm_scan_backward", "k4", k4)

    def uninstall(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


class Profiled:
    """``torch.profiler`` over one stretch of a window.  With ``host`` it
    records the host's operations and ranges as well as the device's (what
    the breakdown, the kernel ranges and the convolution ops need), which
    slows the host; without it only the device's, so the host runs at its
    untraced pace and the stretch's idle share is the window's.  Two marker
    operations bracket the stretch on the device: the traced window runs
    from the first's start to the last's end."""

    def __init__(self, device: torch.device, host: bool = True) -> None:
        self.device = device
        self.host = host
        self.prof: Optional[profile] = None
        self.host_s = (0.0, 0.0)
        self._marker = torch.zeros(1, device=device)

    def _activities(self) -> list:
        activities = []
        if self.host or self.device.type != "cuda":
            activities.append(ProfilerActivity.CPU)
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return activities

    def warm_up(self) -> None:
        """Profile one small operation, so that the profiler's first start
        (seconds on the card, where it attaches to CUDA) falls in the
        set-up and not in the window."""
        with profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        """Open the stretch; the device has to be idle (synchronised)."""
        self.host_s = (time.perf_counter(), 0.0)
        self.prof = profile(activities=self._activities())
        self.prof.start()
        self._marker.fill_(1.0)

    def stop(self) -> None:
        """Close the stretch; ``host_s`` spans the profiler's whole cost in
        the window, from its start to its stop."""
        self._marker.fill_(2.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.host_s = (self.host_s[0], time.perf_counter())


def _device_us(evt) -> float:
    val = getattr(evt, "device_time_total", None)
    return float(val if val is not None else evt.cuda_time_total)


def _is_annotation(evt) -> bool:
    """A host range's projection onto the device timeline (from the first to
    the last kernel launched under it)."""
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA and (
        getattr(evt, "is_user_annotation", False) or evt.name.startswith(PREFIX))


def _is_device(evt) -> bool:
    """A kernel, copy or set on the card."""
    from torch.autograd import DeviceType

    return (evt.device_type == DeviceType.CUDA and not _is_annotation(evt)
            and not evt.name.startswith("Activity Buffer"))


def _is_host(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CPU


def _inside(intervals: List[Tuple[float, float]], s: float, t: float) -> bool:
    """Whether ``[s, t]`` lies inside one of the sorted, disjoint
    ``intervals``."""
    i = bisect.bisect_right(intervals, (s, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= s and t <= intervals[i][1]


def summarize(prof: profile, top: int = 10) -> dict:
    """What a trace says: the traced window's length (between the stretch's
    two markers) and the device's busy seconds in it (the union of every
    kernel, copy and set), device operations, device seconds by name and of
    the kernels launched under the benchmark's ranges and the convolution
    ops, and the idle gaps by what the host was doing at their midpoint (the
    innermost host event then open, with its parent).  Without device
    events (the CPU) the window is empty."""
    events = prof.events()
    device, host, annotated = [], [], defaultdict(list)
    for e in events:
        if _is_annotation(e):
            annotated[e.name].append((e.time_range.start, e.time_range.end))
        elif _is_device(e):
            device.append((e.time_range.start, e.time_range.end, e.name))
        elif _is_host(e):
            host.append((e.time_range.start, e.time_range.end, e))
    device.sort()
    if len(device) >= 2:  # the markers bracket the stretch
        w0, w1 = device[0][0], device[-1][1]
        device = device[1:-1]
    else:
        w0 = w1 = 0.0
        device = []
    busy, gaps, cursor = 0.0, [], w0
    for s, t, _ in device:
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in device:
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-6
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    if host:
        for s, t in gaps:
            idle[_host_label(host, starts, (s + t) / 2)[:NAME_CHARS]] += (t - s) * 1e-6
    # the kernels of a kernel range: those inside its projection on the
    # device timeline; of a convolution op: those it launched, itself or
    # through its children
    ranges: Dict[str, float] = defaultdict(float)
    for key in KERNEL_RANGES.values():
        spans = sorted(annotated.get(PREFIX + key, []))
        for s, t, _ in device:
            if spans and _inside(spans, s, t):
                ranges[PREFIX + key] += (t - s) * 1e-6
    for _, _, e in host:
        if e.name in CONV_OPS:
            ranges[e.name] += _device_us(e) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_ops": len(device),
        "range_device_s": dict(ranges),
        "device_ops_top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps_top": sorted(idle.items(), key=lambda kv: -kv[1])[:top],
    }


def _host_label(host: list, starts: List[float], t: float) -> str:
    """The innermost host event open at ``t`` (the latest-starting one that
    covers it) with its parent's name."""
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        s, end, evt = host[i]
        if end >= t:
            parent = getattr(evt, "cpu_parent", None)
            return evt.name if parent is None else f"{parent.name} > {evt.name}"
    return "(no torch op open: Python, a sleep or a lock)"
