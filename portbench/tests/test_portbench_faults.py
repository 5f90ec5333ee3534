"""A run with its timed path broken underneath comes out not correct, for
each fault a cell can have (the harness's look for a card skipped; the CPU
at a tiny size; the cells' own limits).  One chip: no exchange to leave out."""

import contextlib

import numpy as np
import pytest

from conftest import tiny
from portbench import harness, readings

SEED = 2**31 + 99


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, "cpu", overrides=tiny(cell))


@contextlib.contextmanager
def state_unchanged():
    """The step computes its losses and leaves the parameters and the
    optimizer's state as they were."""
    from transformer_clip_eeg_tpu_torch.train.state import Optimizer

    original = Optimizer.apply
    Optimizer.apply = lambda self, grads: None
    try:
        yield
    finally:
        Optimizer.apply = original


@contextlib.contextmanager
def serve_half_batch():
    """Each dispatch embeds the first half of its windows and answers zeros
    for the rest."""
    from transformer_clip_eeg_tpu_torch import serve

    original = serve.InferenceSession

    class Half(original):
        def embed_eeg(self, windows, *args, **kwargs):
            half = max(1, len(windows) // 2)
            out = super().embed_eeg(windows[:half], *args, **kwargs)
            return np.concatenate([out, np.zeros_like(out)])[:len(windows)]

    serve.InferenceSession = Half
    try:
        yield
    finally:
        serve.InferenceSession = original


@pytest.mark.parametrize("cell", ["flagship.train", "double_lstm.train",
                                  "flagship.serve_eeg"])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("flagship.train", "half_batch"), ("flagship.train", "state_unchanged"),
    ("double_lstm.train", "half_batch"), ("double_lstm.train", "state_unchanged"),
    ("flagship.serve_eeg", "answer_altered"), ("flagship.serve_eeg", "half_batch")])
def test_fault_is_not_correct(cell, fault):
    if fault == "state_unchanged":
        ctx = state_unchanged()
    elif cell.endswith("serve_eeg") and fault == "half_batch":
        ctx = serve_half_batch()
    else:  # the training cells' half batch, the serving cell's altered answer
        ctx = readings.planted("train_chunks" if cell.endswith(".train") else "open_loop_embed")
    with ctx:
        out = run(cell)
    assert not out["correct"], out["checks"]
