"""The benchmark's own tests (``python3 -m pytest portbench/tests``): on the
CPU at sizes a test run holds; the tests marked ``gpu`` skip without a card.
They see ``BENCHMARK.json`` with the cells of ``set_aside.json`` added, so the
generators, mixes and limits of the cells set aside stay tested."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips where torch sees none")


def with_set_aside(bench: dict) -> dict:
    """``bench`` with the entries of ``set_aside.json`` that it lacks."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "set_aside.json")) as f:
        aside = json.load(f)
    merged = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in bench[key]}
        merged[key] = bench[key] + [e for e in aside[key] if e["name"] not in names]
    return merged


@pytest.fixture(scope="session", autouse=True)
def _set_aside_cells():
    from portbench import spec

    original = spec.benchmark
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spec, "benchmark", lambda: with_set_aside(original()))
        yield


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to a size the CPU runs in seconds: depth
    1, batch 8, 32-dim speech features, LSTMs of 16 units, a corpus of two
    chunks, a few requests a second."""
    from portbench import spec

    w = spec.workload(spec.benchmark(), cell)
    cfg = spec.load_json("configs", w["config"])
    flags = dict(cfg["flags"], attention_depth=1, batch_size=8, speech_dim_override=32)
    if flags.get("lstm_units", 128) > 16:
        flags["lstm_units"] = 16
    cfg["flags"] = flags
    tr = spec.load_json("traffic", w["traffic"])
    if tr["generator"] == "train_chunks":
        tr.update(subjects_per_chunk=[3, 2], windows_per_chunk=12, warmup_steps=1,
                  profile_steps=2)
    else:
        tr.update(requests_per_s=8, windows_max=6, pool_windows=20, session_chunk=8,
                  senders=4, warmup_requests=[4, 12], profile_seconds=0.3)
    return {"config": cfg, "traffic": tr}
