"""Requests to the embedding service at a fixed rate, in an open loop
(generator ``open_loop_embed``).

The mix's file gives the offered rate (requests a second), the request
sizes (EEG windows a request, log-uniform between ``windows_min`` and
``windows_max``), the window shape, the pool of distinct windows requests
are cut from, the service's micro-batching linger, the session's chunk and
the threads that wait on answers.  Every seed gets the same work: the same
sizes and the same gaps between arrivals (quantiles of the size
distribution and of the exponential), in an order of its own, and its own
cuts from the pool.

Set-up builds the model with the benchmark's weights, the program's
``InferenceSession`` and ``EmbeddingService`` (its ``MicroBatcher`` on),
makes the pool on the card from the seed and sends ``warmup_requests`` of
the sizes that cover every number of chunks a dispatch will take.  In the
window each request is sent at its arrival time whatever the answers
before it did; its latency runs from that time to the answer in the
sender's hands, and every request the window sent is waited for (a minute
past the close at the most) and compared with the reference's embeddings.

In a traced run a proxy around the session's ``embed_eeg`` keeps each
dispatch's host-clock span and runs the profiler in the dispatching thread
over two stretches of ``profile_seconds`` each, from ``profile_at`` of the
window in: the device alone, then the host and the device.  The host-clock
numbers leave out the requests and dispatches that overlap them.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from portbench import harness, spec, weights

LATE_S = 60.0  # how long past the close a request's answer is waited for


def schedule(tr: dict, seconds: float, seed: int) -> tuple:
    """``(arrivals, sizes, offsets)`` of the window's requests: arrival
    seconds from the window's start, windows a request, and where each
    request's windows start in the pool."""
    n = max(1, round(tr["requests_per_s"] * seconds))
    q = (np.arange(n) + 0.5) / n
    lo, hi = tr["windows_min"], tr["windows_max"]
    sizes = np.floor(lo * ((hi + 1) / lo) ** q).astype(np.int64)
    gaps = -np.log1p(-q)
    rng = np.random.default_rng(weights.stream_seed(seed, 4))
    sizes, gaps = rng.permutation(sizes), rng.permutation(gaps)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    if n > 1:
        arrivals *= seconds * (n - 1) / n / arrivals[-1]
    offsets = rng.integers(0, tr["pool_windows"] - sizes + 1)
    return arrivals, sizes, offsets


class SessionProxy:
    """The session, with the host-clock span of every ``embed_eeg`` call.
    It also runs the profiler, in the thread that dispatches (a profiler of
    the host started in another thread sees none of that thread's work):
    each of the two stretches from the first dispatch after the last one
    closed (the first after ``profile_from``) to the first dispatch that ends
    ``profile_seconds`` later or after the window's close, ``until``."""

    def __init__(self, session, ctx, profile_seconds: float) -> None:
        self._session = session
        self._ctx = ctx
        self._from = self._until = float("inf")
        self._seconds = profile_seconds
        self._open = None
        self.profs: list = []
        self.dispatches: list = []  # (start, end, windows)

    def __getattr__(self, name):
        return getattr(self._session, name)

    def embed_eeg(self, windows, *args, **kwargs):
        from portbench.trace import Profiled

        ctx = self._ctx
        t0 = time.perf_counter()
        if self._open is None and len(self.profs) < 2 and t0 >= self._from:
            host = len(self.profs) == 1
            self._open = Profiled(ctx.device, host=host)
            self._open.start()
            ctx.spans.profiling = ctx.kernels.recording = host
        with ctx.spans("embed"):
            out = self._session.embed_eeg(windows, *args, **kwargs)
        t1 = time.perf_counter()
        self.dispatches.append((t0, t1, len(windows)))
        if self._open is not None and t1 >= min(self._open.host_s[0] + self._seconds,
                                                self._until):
            self._open.stop()
            ctx.spans.profiling = ctx.kernels.recording = False
            self.profs.append(self._open)
            self._open = None
        return out


def run(ctx) -> dict:
    from transformer_clip_eeg_tpu_torch.serve import InferenceSession
    from transformer_clip_eeg_tpu_torch.server import EmbeddingService

    tr, dev, seed = ctx.traffic, ctx.device, ctx.seed
    cfg = harness.train_config(ctx.config)
    model = harness.build_model(cfg, tr["bank_size"], seed, dev)
    params, state = weights.snapshot(model)
    session = InferenceSession(model, chunk=tr["session_chunk"], device=dev)
    service = EmbeddingService(session, batch_window_ms=tr["batch_window_ms"])
    pool = make_pool(tr, cfg, seed, dev)
    arrivals, sizes, offsets = schedule(tr, ctx.seconds, seed)
    for n in tr["warmup_requests"]:
        service.embed_eeg({"windows": pool[:n]})
    if ctx.traced:
        from portbench.trace import Profiled

        Profiled(dev, host=False).warm_up()
        Profiled(dev, host=True).warm_up()
    harness.synchronize(dev)
    batcher = service._eeg_batcher
    counts0 = (batcher.requests, batcher.dispatches)
    proxy = None
    if ctx.traced:
        proxy = SessionProxy(session, ctx, tr["profile_seconds"])
        service.session = proxy

    n = len(arrivals)
    records: list = [None] * n  # (offset, size, sent, answered, embeddings)
    errors = [0]
    lock = threading.Lock()

    def send(i: int, sent: float) -> None:
        off, size = int(offsets[i]), int(sizes[i])
        try:
            out = service.embed_eeg({"windows": pool[off:off + size]})
        except Exception:  # noqa: BLE001 -- a failed request is counted, not raised
            with lock:
                errors[0] += 1
            return
        records[i] = (off, size, sent, time.perf_counter(), out)

    executor = ThreadPoolExecutor(max_workers=tr["senders"])
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    if proxy is not None:
        proxy._from, proxy._until = t0 + tr["profile_at"] * ctx.seconds, end
    futures = []
    for i in range(n):
        due = t0 + float(arrivals[i])
        pause = due - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        futures.append(executor.submit(send, i, due))
    _, pending = wait(futures, timeout=max(0.0, end + LATE_S - time.perf_counter()))
    executor.shutdown(wait=not pending, cancel_futures=True)
    counts1 = (batcher.requests, batcher.dispatches)
    service.close()
    peak = harness.memory_peak(dev)

    done = [r for r in records if r is not None]
    latency_ms = np.array([(t_done - sent) * 1e3 for _, _, sent, t_done, _ in done])
    e2e = {"serve_ms_p95": float(np.percentile(latency_ms, 95)) if len(done) else float("inf")}
    answered_windows = int(sum(size for _, size, _, _, _ in done))
    last = max((t_done for _, _, _, t_done, _ in done), default=end)
    stats = {
        "requests": n, "answered": len(done), "windows": answered_windows,
        "offered_windows_per_s": float(sizes.sum()) / ctx.seconds,
        "answered_by_close_windows_per_s": sum(s for _, s, _, t, _ in done if t <= end)
        / ctx.seconds,
        "p50_ms": float(np.percentile(latency_ms, 50)) if len(done) else float("inf"),
        "p95_ms": e2e["serve_ms_p95"],
        "max_ms": float(latency_ms.max()) if len(done) else float("inf"),
        "last_answer_after_close_s": last - end,
        "dispatches": counts1[1] - counts0[1],
    }
    print(f"portbench: {stats}", file=sys.stderr)

    layer = {}
    if ctx.traced:
        layer = traced_layer(ctx, proxy, done, counts0, counts1, answered_windows)
    del service, session, model, proxy
    harness.release(dev)

    ref = spec.load_module("reference", ctx.config_name)
    t_ref = time.perf_counter()
    gap = embed_gap(ref, params, state, pool, done, dev, tr["session_chunk"], tf32=False)
    print(f"portbench: the reference and the comparison of {len(done)} answers took "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return {
        "e2e": e2e,
        "window_start": t0,
        "attempted": n,
        "failed": n - len(done),
        "numbers": {"embed_gap": gap},
        "memory_peak_bytes": peak,
        "layer": layer,
        "stats": stats,
    }


def traced_layer(ctx, proxy, done: list, counts0: tuple, counts1: tuple,
                 windows: int) -> dict:
    """What the per-layer readers read, from the proxy's spans and the two
    traced stretches; the host-clock numbers outside the stretches."""
    from portbench.trace import summarize

    if len(proxy.profs) < 2:
        raise RuntimeError("the traced stretches did not close inside the window; "
                           "lengthen --seconds or shorten profile_seconds")
    lo, hi = proxy.profs[0].host_s[0], proxy.profs[1].host_s[1]
    outside = [rec for rec in done if rec[3] <= lo or rec[2] >= hi]
    print(f"portbench: traced stretches {hi - lo:.3f} s; {len(outside)} of {len(done)} "
          "requests lie outside them", file=sys.stderr)
    dispatches = sorted(proxy.dispatches)
    ends = [d[1] for d in dispatches]
    queue = []
    for _, _, sent, t_done, _ in outside:
        i = bisect.bisect_right(ends, t_done) - 1  # the last dispatch answered by then
        if i >= 0 and dispatches[i][0] >= sent:
            queue.append((dispatches[i][0] - sent) * 1e3)
    clear = [d for d in dispatches if d[1] <= lo or d[0] >= hi]
    flops_mod = spec.load_module("configs", f"{ctx.config_name}_flops")
    return {
        "windows": windows,
        "dispatches": counts1[1] - counts0[1],
        "queue_ms": queue,
        "embed_spans": ctx.spans.durations("embed", (lo, hi)),
        "dispatched_windows": sum(d[2] for d in clear),
        "dispatch_s": sum(d[1] - d[0] for d in clear),
        "flops_per_window": flops_mod.eeg_flops_per_window(),
        "kernel_bound_s": dict(ctx.kernels.bound_s),
        "trace": summarize(proxy.profs[0].prof),
        "host_trace": summarize(proxy.profs[1].prof),
    }


def make_pool(tr: dict, cfg, seed: int, dev) -> np.ndarray:
    """The distinct windows, ``[windows, T, channels]`` N(0, 1), made on the
    card from the seed."""
    gen = torch.Generator(device=dev).manual_seed(weights.stream_seed(seed, 3))
    return torch.randn((tr["pool_windows"], cfg.window_length, tr["channels"]),
                       generator=gen, device=dev).cpu().numpy()


def reference_inputs(ctx) -> tuple:
    """What the reference gets in a run of this seed: ``(weights, state,
    pool)``."""
    cfg = harness.train_config(ctx.config)
    model = harness.build_model(cfg, ctx.traffic["bank_size"], ctx.seed, ctx.device)
    params, state = weights.snapshot(model)
    return params, state, make_pool(ctx.traffic, cfg, ctx.seed, ctx.device)


def reference_embeddings(ref, params: dict, state: dict, pool: np.ndarray, dev, chunk: int,
                         tf32: bool) -> np.ndarray:
    """The reference's embeddings of every pool window, ``[windows, D]``, in
    blocks of ``chunk`` windows."""
    from portbench.reference.common import precision

    p = {k: v.to(dev) for k, v in params.items()}
    s = {k: v.to(dev) for k, v in state.items()}
    out = []
    with precision(tf32):
        for i in range(0, len(pool), chunk):
            x = torch.from_numpy(np.ascontiguousarray(pool[i:i + chunk])).to(dev)
            out.append(ref.embed_eeg(p, s, x).cpu().numpy())
    return np.concatenate(out)


def embed_gap(ref, params, state, pool, done: list, dev, chunk: int, tf32: bool) -> float:
    """The widest gap of any answered request's embeddings from the
    reference's (infinite for an answer of the wrong shape)."""
    want = reference_embeddings(ref, params, state, pool, dev, chunk, tf32)
    worst = 0.0 if done else float("inf")
    for off, size, _, _, out in done:
        got = np.asarray(out)
        if got.shape != want[off:off + size].shape or not np.isfinite(got).all():
            return float("inf")
        worst = max(worst, float(np.abs(got - want[off:off + size]).max()))
    return worst
