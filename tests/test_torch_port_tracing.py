"""The port's spans (``utils/tracing.py``) and the spans of the train step:
off means off, nesting, steps and threads, the collector's pauses, ranges
under a CPU ``torch.profiler``, one ``chunk_train_step`` partitioned by its
phases, and the mapping of spans onto a trace's clock with the attribution
of idle gaps."""

import gc
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer
from transformer_clip_eeg_tpu_torch.train.steps import chunk_train_step
from transformer_clip_eeg_tpu_torch.utils import tracing
from transformer_clip_eeg_tpu_torch.utils.tracing import Span


@pytest.fixture(autouse=True)
def _fresh():
    tracing.stop()
    tracing.clear()
    yield
    tracing.stop()
    tracing.clear()


def _boom(*args, **kwargs):
    raise AssertionError("called while recording is off")


def test_off_reads_no_clock_appends_nothing_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(time, "perf_counter_ns", _boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _boom)
    first = tracing.span(tracing.FORWARD)
    assert tracing.span("another") is first and tracing.step() is first  # one shared object
    with tracing.step():
        with tracing.span(tracing.GATHER):
            pass
    assert tracing.records() == [] and tracing.gc_counts() == (0, 0, 0)


def test_spans_nest_by_thread_and_share_their_steps_ordinal():
    tracing.start()
    with tracing.span("outside"):
        with tracing.step():
            with tracing.span("a"):
                with tracing.step():  # an inner step call opens no second step
                    with tracing.span("b"):
                        pass
        with tracing.step():
            pass

    def worker():
        with tracing.span("thread"):
            with tracing.span("thread.inner"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tracing.stop()
    by = {s.name: s for s in tracing.records() if s.name != tracing.STEP}
    steps = sorted((s for s in tracing.records() if s.name == tracing.STEP),
                   key=lambda s: s.t0_ns)
    assert len(steps) == 2 and steps[0].step != steps[1].step
    assert by["outside"].parent_id is None and by["outside"].step is None
    assert steps[0].parent_id == by["outside"].span_id
    assert by["a"].parent_id == steps[0].span_id and by["a"].step == steps[0].step
    assert by["b"].parent_id == by["a"].span_id and by["b"].step == steps[0].step
    assert steps[1].parent_id == by["outside"].span_id
    main = threading.get_ident()
    assert {by[n].thread_id for n in ("outside", "a", "b")} == {main}
    assert by["thread"].parent_id is None and by["thread"].thread_id != main
    assert by["thread.inner"].parent_id == by["thread"].span_id
    assert by["thread.inner"].thread_id == by["thread"].thread_id
    for s in tracing.records():
        assert s.t0_ns <= s.t1_ns
    assert by["a"].t0_ns <= by["b"].t0_ns and by["b"].t1_ns <= by["a"].t1_ns
    # a parent closes after its children
    names = [s.name for s in tracing.records()]
    assert names.index("b") < names.index("a") < names.index("outside")


def test_the_collectors_pauses_are_gc_spans_with_their_generation():
    tracing.start()
    with tracing.span("work"):
        gc.collect()
    gc.collect(0)
    tracing.stop()
    gc.collect()  # recording is off: no span, no count
    spans = [s for s in tracing.records() if s.name == tracing.GC]
    work = next(s for s in tracing.records() if s.name == "work")
    assert [s.generation for s in spans] == [2, 0]
    assert spans[0].parent_id == work.span_id and spans[1].parent_id is None
    assert work.t0_ns <= spans[0].t0_ns <= spans[0].t1_ns <= work.t1_ns
    assert tracing.gc_counts() == (1, 0, 1)
    tracing.clear()
    assert tracing.records() == [] and tracing.gc_counts() == (0, 0, 0)


def test_start_twice_raises_and_stop_keeps_the_records():
    tracing.start()
    with pytest.raises(RuntimeError):
        tracing.start()
    with tracing.span("kept"):
        pass
    tracing.stop()
    tracing.stop()  # a second stop does nothing
    assert [s.name for s in tracing.records()] == ["kept"]
    assert tracing.span("off") is tracing.span("again")  # the shared no-op


def _chunk_step_inputs(batch=8):
    torch.manual_seed(0)
    cfg = TrainConfig(attention_depth=1, batch_size=batch, speech_dim_override=16)
    model = build_model_from_config(cfg, 32, device="cpu", seed=1)
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate)
    t = cfg.window_length
    eeg = torch.randn(2, 12, t, 64)
    speech = torch.randn(12, t, 16)
    ids = torch.arange(1, 13)
    idx = torch.randperm(12)[:batch]
    subs = torch.randint(0, 2, (batch,))

    def step():
        return chunk_train_step(model, opt, eeg, speech, ids, idx, subs, 7, False,
                                model_arch=cfg.model_arch)

    return step


@pytest.fixture(scope="module")
def chunk_step():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    step = _chunk_step_inputs()
    step()  # first-call costs out of the timed step
    yield step
    torch.set_num_threads(n)


def test_a_chunk_step_is_one_train_step_partitioned_by_its_phases(chunk_step):
    tracing.start()
    chunk_step()
    tracing.stop()
    recs = tracing.records()
    (step,) = [s for s in recs if s.name == tracing.STEP]
    phases = sorted((s for s in recs if s.name in tracing.PHASES), key=lambda s: s.t0_ns)
    assert [s.name for s in phases] == list(tracing.PHASES)
    for s in phases:
        assert s.parent_id == step.span_id and s.step == step.step
        assert step.t0_ns <= s.t0_ns and s.t1_ns <= step.t1_ns
    for a, b in zip(phases, phases[1:]):
        assert a.t1_ns <= b.t0_ns
    covered = sum(s.t1_ns - s.t0_ns for s in phases)
    assert covered >= 0.95 * (step.t1_ns - step.t0_ns)


def test_ranges_show_as_host_events_under_a_cpu_profiler(chunk_step):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.start(ranges=True)
        chunk_step()
        tracing.stop()
        chunk_step()  # recording off: no ranges
    names = [e.name for e in prof.events()]
    for name in (tracing.STEP,) + tracing.PHASES:
        assert names.count(name) == 1, name
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.start()  # recording without ranges
        chunk_step()
        tracing.stop()
    assert not {e.name for e in prof.events()} & {tracing.STEP, *tracing.PHASES}
    assert len([s for s in tracing.records() if s.name == tracing.STEP]) == 2


def test_the_profilers_step_and_the_mapped_span_start_together(chunk_step):
    """The anchor as a traced run takes it: the host clock read beside the
    wall clock, on which the profiler keeps its host events; the mapped
    train.step starts land within a millisecond of the profiler's own
    train.step events (on the CPU; the card's check is in PERF.md)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.start(ranges=True)
        anchor_ns, anchor_wall_ns = time.perf_counter_ns(), time.time_ns()
        for _ in range(3):
            chunk_step()
        tracing.stop()
    anchor_us = (anchor_wall_ns - prof.profiler.kineto_results.trace_start_ns()) / 1e3
    traced = sorted(e.time_range.start for e in prof.events() if e.name == tracing.STEP)
    mapped = [s for s, _, span in tracing.on_timeline(tracing.records(), anchor_ns, anchor_us)
              if span.name == tracing.STEP]
    assert len(traced) == len(mapped) == 3
    assert max(abs(a - b) for a, b in zip(traced, mapped)) < 1000.0


def _span(name, sid, parent, t0_us, t1_us, step=0):
    return Span(name, sid, parent, step, 1, int(t0_us * 1e3), int(t1_us * 1e3))


def test_on_timeline_shifts_by_the_anchor_and_sorts():
    spans = [_span("b", 2, 1, 150, 200), _span("a", 1, None, 100, 300)]
    out = tracing.on_timeline(spans, anchor_ns=100_000, anchor_us=5_000.0)
    assert [(s, e, sp.name) for s, e, sp in out] == [(5_000.0, 5_200.0, "a"),
                                                     (5_050.0, 5_100.0, "b")]


def test_idle_gaps_go_to_the_innermost_span_open_at_their_midpoint():
    # host clock (us): a step 1,000-2,000 with gather 1,000-1,100, forward
    # 1,100-1,500 (a gc pause 1,300-1,350 inside), backward 1,500-1,900,
    # optimizer 1,900-1,990; a second step from 2,500
    spans = [
        _span(tracing.STEP, 1, None, 1_000, 2_000),
        _span(tracing.GATHER, 2, 1, 1_000, 1_100),
        _span(tracing.FORWARD, 3, 1, 1_100, 1_500),
        Span(tracing.GC, 4, 3, 0, 1, int(1_300e3), int(1_350e3), 0),
        _span(tracing.BACKWARD, 5, 1, 1_500, 1_900),
        _span(tracing.OPTIMIZER, 6, 1, 1_900, 1_990),
        _span(tracing.STEP, 7, None, 2_500, 3_000, step=1),
    ]
    # the trace's clock runs 40,000 us behind the host's: anchor 1,000 us on
    # the host is 41,000 us in the trace
    timeline = tracing.on_timeline(spans, anchor_ns=1_000_000, anchor_us=41_000.0)
    gaps = [(41_020, 41_060),   # mid 41,040: gather
            (41_200, 41_260),   # mid 41,230: forward
            (41_310, 41_330),   # mid 41,320: the gc pause inside forward
            (41_480, 41_560),   # mid 41,520: backward (it starts at 41,500)
            (41_950, 41_995),   # mid 41,972.5: optimizer
            (41_992, 41_998),   # mid 41,995: the step, after the optimizer
            (42_100, 42_300),   # mid 42,200: between the steps
            (42_600, 42_700),   # mid 42,650: the second step
            (10, 30)]           # before every span
    out = tracing.idle_by_span(gaps, timeline)
    assert out == pytest.approx({
        tracing.GATHER: 40e-6, tracing.FORWARD: 60e-6, tracing.GC: 20e-6,
        tracing.BACKWARD: 80e-6, tracing.OPTIMIZER: 45e-6, tracing.STEP: 106e-6,
        tracing.OUTSIDE: 220e-6})
    # the whole idle time is attributed once
    assert sum(out.values()) == pytest.approx(sum(t - s for s, t in gaps) * 1e-6)
    # without the offset the gaps fall outside every span
    wrong = tracing.on_timeline(spans, anchor_ns=0, anchor_us=0.0)
    assert tracing.idle_by_span(gaps, wrong) == pytest.approx(
        {tracing.OUTSIDE: sum(t - s for s, t in gaps) * 1e-6})


def test_durations_in_order_of_start():
    spans = [_span("x", 2, None, 300, 350), _span("x", 1, None, 100, 300),
             _span("y", 3, None, 0, 10)]
    assert tracing.durations_s(spans, "x") == pytest.approx([200e-6, 50e-6])
