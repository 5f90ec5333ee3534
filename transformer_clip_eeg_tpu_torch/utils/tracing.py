"""The port's spans: named host-clock intervals recorded inside the program,
and their mapping onto a ``torch.profiler`` timeline.

One recorder serves the process, so that code as deep as the train step can
open a span without being handed anything.  Recording is off unless a
caller turns it on: ``Trainer.fit`` records each epoch's training (its
``loss.txt`` phases line and ``history[...]["step_s"]`` are read from the
spans), and a benchmark's traced run may record its window.

* :func:`span` opens a span.  Off, it returns one shared object whose enter
  and exit do nothing: no clock read, no allocation, no ``record_function``.
  On, the span is kept in memory as a :class:`Span`, timed with
  ``time.perf_counter_ns``; its parent is the innermost span open on the same
  thread, and its step is the ordinal of the ``train.step`` it lies in.
* :func:`step` opens ``train.step`` with a new ordinal, unless a step is
  already open on the thread (``chunk_train_step`` calls ``train_step``: the
  outermost call holds the one span a step).
* :func:`start` (with ``ranges=True`` each span also opens a
  ``record_function`` range of its name, so it shows in a profiler's host
  events and in ``--profile_dir``'s Chrome trace), :func:`stop`,
  :func:`records`, :func:`clear`.  While recording, a ``gc.callbacks`` hook
  adds a ``gc`` span for each pause of the garbage collector, with its
  generation, and counts the collections by generation (:func:`gc_counts`).

The spans (PERF.md §3 lists what reads each):
``train.step`` (one a step) and its phases ``train.gather`` (the batch
gathered from the resident chunk), ``train.forward`` (mixup, augmentations,
the cast, the dropout seeds, the model with the bank's update, the losses),
``train.backward`` (the gradients, the zero fill, the mean over a mesh),
``train.optimizer`` (the update); the trainer's ``train.fetch`` (loss scalars
to log lines) and ``train.block`` (the end-of-epoch drain); ``gc``.

:func:`on_timeline` maps spans onto a profiler trace's clock from one anchor:
a ``perf_counter_ns()`` reading and that moment's time in the trace.  A
``torch.profiler`` trace keeps its host events on the wall clock, so a
``time.time_ns()`` read beside the anchor, less the trace's start, places
it among them (within 8-15 us, median, on an H100's host).  Its device
events can stand milliseconds apart from its host events within one
profiled stretch, which a caller mapping spans onto device events has to
place.  :func:`idle_by_span`
gives each idle gap of the device to the innermost span open at the gap's
midpoint.

Cost, on the host of an H100 80GB HBM3 (700 W) running the flagship's train
step (about 50 ms of host a step, six spans and about one collection a
step): a span's enter and exit take 0.32 us off, 6.9 us recording and
13.7 us with a range under a profiler, so recording adds about 0.04 ms a
step and the ranges about as much again; 30 alternated pairs of 10-step
blocks read a median of -0.09 ms a step for recording on against off, under
the host's own drift.
"""

from __future__ import annotations

import bisect
import gc
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

STEP = "train.step"
GATHER = "train.gather"
FORWARD = "train.forward"
BACKWARD = "train.backward"
OPTIMIZER = "train.optimizer"
FETCH = "train.fetch"
BLOCK = "train.block"
GC = "gc"
PHASES = (GATHER, FORWARD, BACKWARD, OPTIMIZER)  # they partition a chunk step
OUTSIDE = "(no span open)"  # idle_by_span's label of a gap outside every span


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]  # the innermost span open on the thread at the start
    step: Optional[int]  # the ordinal of the enclosing train.step; None outside one
    thread_id: int
    t0_ns: int  # time.perf_counter_ns()
    t1_ns: int
    generation: Optional[int] = None  # of a gc span


class _Off:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self) -> None:
        self.records: List[Span] = []
        self.ranges = False
        self.gc_counts = [0, 0, 0]
        self.ids = itertools.count(1)
        self.steps = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, innermost last, as ``(span_id, step)``."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = stack = []
            return stack

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.local.gc_t0 = time.perf_counter_ns()
            return
        t1 = time.perf_counter_ns()
        t0 = getattr(self.local, "gc_t0", None)
        if t0 is None:  # the collection began before recording did
            return
        self.local.gc_t0 = None
        stack = self.stack()
        parent, step_ = stack[-1] if stack else (None, None)
        gen = info["generation"]
        self.gc_counts[gen] += 1
        self.records.append(Span(GC, next(self.ids), parent, step_, threading.get_ident(),
                                 t0, t1, gen))


class _Open:
    """A span while it is open."""

    __slots__ = ("rec", "name", "new_step", "span_id", "parent_id", "step", "range", "t0")

    def __init__(self, rec: _Recorder, name: str, new_step: bool) -> None:
        self.rec, self.name, self.new_step = rec, name, new_step

    def __enter__(self) -> None:
        rec = self.rec
        stack = rec.stack()
        self.parent_id, self.step = stack[-1] if stack else (None, None)
        if self.new_step:
            self.step = next(rec.steps)
        self.span_id = next(rec.ids)
        stack.append((self.span_id, self.step))
        self.range = None
        if rec.ranges:
            from torch.autograd.profiler import record_function

            self.range = record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        rec.stack().pop()
        rec.records.append(Span(self.name, self.span_id, self.parent_id, self.step,
                                threading.get_ident(), self.t0, t1))
        return False


_recorder = _Recorder()
_active: Optional[_Recorder] = None  # _recorder while recording


def span(name: str):
    """A context manager that records ``name`` while recording is on."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name, False)


def step():
    """``train.step`` with a new ordinal, or nothing where a step is open."""
    rec = _active
    if rec is None:
        return _OFF
    stack = rec.stack()
    if stack and stack[-1][1] is not None:
        return _OFF
    return _Open(rec, STEP, True)


def start(ranges: bool = False) -> None:
    """Turn recording on (the records kept so far stay); ``ranges`` also
    opens a ``record_function`` range for each span."""
    global _active
    if _active is not None:
        raise RuntimeError("the port's spans are already recording")
    _recorder.ranges = ranges
    gc.callbacks.append(_recorder.on_gc)
    _active = _recorder


def stop() -> None:
    """Turn recording off; the records stay until :func:`clear`."""
    global _active
    if _active is None:
        return
    _active = None
    gc.callbacks.remove(_recorder.on_gc)
    _recorder.ranges = False


def records() -> List[Span]:
    """The spans recorded since the last :func:`clear`, in the order they
    closed (a parent after its children)."""
    return list(_recorder.records)


def gc_counts() -> Tuple[int, int, int]:
    """Collections of generations 0, 1 and 2 while recording."""
    return tuple(_recorder.gc_counts)


def clear() -> None:
    _recorder.records.clear()
    _recorder.gc_counts[:] = [0, 0, 0]


def durations_s(spans: Sequence[Span], name: str) -> List[float]:
    """Seconds of each span named ``name``, in order of start."""
    return [(s.t1_ns - s.t0_ns) * 1e-9 for s in sorted(spans, key=lambda s: s.t0_ns)
            if s.name == name]


def on_timeline(spans: Sequence[Span], anchor_ns: int, anchor_us: float
                ) -> List[Tuple[float, float, Span]]:
    """``(start_us, end_us, span)`` on a profiler trace's clock, sorted by
    start (of two that start together, the longer first): ``anchor_ns`` is
    the host clock (``perf_counter_ns``) at a moment whose time in the trace
    is ``anchor_us``."""
    return sorted(((anchor_us + (s.t0_ns - anchor_ns) * 1e-3,
                    anchor_us + (s.t1_ns - anchor_ns) * 1e-3, s) for s in spans),
                  key=lambda t: (t[0], -t[1]))


def idle_by_span(gaps: Sequence[Tuple[float, float]],
                 timeline: Sequence[Tuple[float, float, Span]]) -> Dict[str, float]:
    """Seconds of the idle ``gaps`` (``(start_us, end_us)`` on the trace's
    clock) by the name of the innermost span of ``timeline`` (from
    :func:`on_timeline`) open at each gap's midpoint: of those open then, the
    one that started last.  A gap outside every span goes to
    :data:`OUTSIDE`."""
    starts = [t[0] for t in timeline]
    reach = list(itertools.accumulate((t[1] for t in timeline), max))  # latest end so far
    out: Dict[str, float] = defaultdict(float)
    for s, t in gaps:
        mid = (s + t) / 2
        label = OUTSIDE
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if reach[i] < mid:  # no span from here back reaches the midpoint
                break
            if timeline[i][1] >= mid:
                label = timeline[i][2].name
                break
        out[label] += (t - s) * 1e-6
    return dict(out)
