"""Serving at scale on the port: the retrieval index at a corpus's size of
candidates, and concurrent clients through the micro-batcher.

Counterpart of the JAX package's ``scripts/bench_retrieval.py`` and
``scripts/bench_microbatch.py``.

* ``serve.RetrievalIndex`` of ``--rows`` L2-normalised rows of the
  flagship's embedding width (192 x 8 = 1,536: 100,000 rows are 614 MB in
  float32): the bulk build's seconds (chunks of 8,192 rows), one-row
  ``add`` p50/p99, ``topk`` p50/p99 for Q = 1 and Q = 16 at k = 10 (each
  call waits for its result), and the card's allocated memory.
* ``server.EmbeddingService`` on the flagship at ``--depth`` (random
  weights from seed 0, batches of ``--chunk``): ``--clients`` threads each
  posting ``--requests`` embedding requests of ``--windows`` EEG windows
  one after another, with coalescing off and on (``MicroBatcher``,
  ``--window_ms``): aggregate requests/s, per-request p50/p99, and the
  batcher's requests and dispatches.  Each coalesced answer is held against
  the one-at-a-time answer to the same request (1e-5 of max |x|).

    python -m transformer_clip_eeg_tpu_torch.tools.serve_rehearsal
    ... --rows 2048 --dim 64 --depth 2 --speech_dim 16 --device cpu

Prints one JSON line per measurement.  Runs on the card unless ``--device
cpu``; with no card ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.models.registry import (
    build_model_from_config,
    resolve_device,
)
from transformer_clip_eeg_tpu_torch.serve import InferenceSession, RetrievalIndex
from transformer_clip_eeg_tpu_torch.server import EmbeddingService
from transformer_clip_eeg_tpu_torch.tools import device_name
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

BUILD_CHUNK = 8192
COALESCE_TOL = 1e-5  # of max |x|: a request's rows at another place in the batch


def pcts(samples: List[float]) -> Tuple[float, float]:
    """p50 and p99 in ms of samples in seconds."""
    a = np.asarray(samples) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def unit_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def candidate_chunks(rows: int, dim: int, seed: int = 0) -> Iterator[np.ndarray]:
    """The index's rows, L2-normalised, in chunks of ``BUILD_CHUNK``."""
    rng = np.random.default_rng(seed)
    for start in range(0, rows, BUILD_CHUNK):
        yield unit_rows(rng, min(BUILD_CHUNK, rows - start), dim)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_index(rows: int, dim: int, device="cuda", reps: int = 50, seed: int = 0) -> dict:
    device = resolve_device(device)
    out = {"rows": rows, "dim": dim}
    idx = RetrievalIndex(dim, capacity=rows + 64, device=device)
    t0 = time.perf_counter()
    for chunk in candidate_chunks(rows, dim, seed):
        idx.add(chunk)
    _sync(device)
    out["bulk_build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    one = unit_rows(rng, 1, dim)
    adds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        idx.add(one)
        _sync(device)
        adds.append(time.perf_counter() - t0)
        idx.size -= 1  # the same row again: the capacity stays
    out["add_p50_ms"], out["add_p99_ms"] = pcts(adds)
    for q in (1, 16):
        queries = unit_rows(rng, q, dim)
        idx.topk(queries, k=10)  # warm
        lat = []
        for i in range(reps):
            t0 = time.perf_counter()
            idx.topk(queries * (1.0 + 1e-6 * i), k=10)  # numpy out: the result is back
            lat.append(time.perf_counter() - t0)
        out[f"topk_q{q}_p50_ms"], out[f"topk_q{q}_p99_ms"] = pcts(lat)
    if device.type == "cuda":
        out["memory_allocated_gb"] = torch.cuda.memory_allocated(device) / 2**30
    return out


def flagship_session(depth: int, speech_dim: int, chunk: int, device) -> InferenceSession:
    cfg = TrainConfig(attention_depth=depth, speech_dim_override=speech_dim)
    model = build_model_from_config(cfg, 512, device="cpu", seed=0)
    return InferenceSession(model, chunk=chunk, device=device)


def client_requests(clients: int, requests: int, windows: int, window: int,
                    seed: int = 0) -> List[List[np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((windows, window, 64)).astype(np.float32)
             for _ in range(requests)] for _ in range(clients)]


def scenario(session: InferenceSession, reqs, batch_window_ms: float):
    """Every client's requests at once through one service; returns the
    record and each request's answer, ``answers[client][i]``."""
    service = EmbeddingService(session, batch_window_ms=batch_window_ms)
    lat, answers = [], [[None] * len(r) for r in reqs]
    lock = threading.Lock()
    errors = []

    def client(c):
        try:
            for i, arr in enumerate(reqs[c]):
                t0 = time.perf_counter()
                answers[c][i] = np.asarray(service.embed_eeg({"windows": arr}))
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(reqs))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        batcher = service._eeg_batcher
        n = sum(len(r) for r in reqs)
        rec = {"batch_window_ms": batch_window_ms, "clients": len(reqs), "requests": n,
               "windows_per_request": int(reqs[0][0].shape[0]),
               "requests_per_s": n / wall, "wall_s": wall}
        rec["p50_ms"], rec["p99_ms"] = pcts(lat) if lat else (None, None)
        if batcher is not None:
            rec["batcher_requests"], rec["dispatches"] = batcher.requests, batcher.dispatches
    finally:
        service.close()
    if errors:
        raise errors[0]
    return rec, answers


def bench_microbatch(clients: int = 8, requests: int = 6, windows: int = 8,
                     window_ms: float = 5.0, speech_dim: int = 1024, depth: int = 10,
                     chunk: int = 128, device="cuda") -> List[dict]:
    """The two scenarios (coalescing off, then on) after one warm-up run, on
    the flagship's 3 s windows (192 samples); the coalesced answers held
    against the one-at-a-time ones."""
    session = flagship_session(depth, speech_dim, chunk, resolve_device(device))
    reqs = client_requests(clients, requests, windows, TrainConfig().window_length)
    scenario(session, reqs, 0.0)  # warm
    records, answers = [], []
    for ms in (0.0, window_ms):
        rec, ans = scenario(session, reqs, ms)
        records.append(rec)
        answers.append(ans)
    scale = max(float(np.abs(a).max()) for row in answers[0] for a in row)
    err = max(float(np.abs(a - b).max()) for ra, rb in zip(*answers) for a, b in zip(ra, rb))
    records[1]["coalesced_vs_alone"] = err / scale
    if not err <= COALESCE_TOL * scale:
        raise AssertionError(f"coalesced answers differ from one-at-a-time ones: {err / scale}")
    if not records[1]["dispatches"] <= records[1]["batcher_requests"] == clients * requests:
        raise AssertionError(f"the batcher's counts: {records[1]}")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 100_000])
    ap.add_argument("--dim", type=int, default=1536)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--windows", type=int, default=8, help="EEG windows a request")
    ap.add_argument("--window_ms", type=float, default=5.0)
    ap.add_argument("--speech_dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=128, help="the embedders' batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(json.dumps({"device": device_name(args.device)}), flush=True)
    for rows in args.rows:
        print(json.dumps({"metric": "retrieval_index", **bench_index(
            rows, args.dim, args.device, args.reps)}), flush=True)
    for rec in bench_microbatch(args.clients, args.requests, args.windows, args.window_ms,
                                args.speech_dim, args.depth, args.chunk,
                                args.device):
        print(json.dumps({"metric": "microbatch", **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
