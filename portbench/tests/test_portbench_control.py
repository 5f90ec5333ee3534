"""The control comes out not correct: the reference put in the program's
place, computed in TF32 (the precision below the configurations' float32),
fails a cell's limits.  On the card only (TF32 exists there), at the cells'
widths and depths with a smaller batch and corpus than the timed ones."""

import pytest
import torch

from portbench import checks, harness, readings, spec

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is a precision of the card's tensor cores")
    return "cuda"


def smaller(cell: str) -> dict:
    w = spec.workload(spec.benchmark(), cell)
    cfg = spec.load_json("configs", w["config"])
    cfg["flags"] = dict(cfg["flags"], batch_size=32)
    tr = spec.load_json("traffic", w["traffic"])
    if tr["generator"] == "train_chunks":
        tr.update(subjects_per_chunk=[3, 2], windows_per_chunk=40)
    else:
        tr.update(pool_windows=256)
    return {"config": cfg, "traffic": tr}


@pytest.mark.parametrize("cell", ["flagship.train", "double_lstm.train",
                                  "flagship.serve_eeg"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_is_not_correct(card, cell, seed):
    numbers = readings.control(cell, seed, card, smaller(cell))
    limits = harness.make_context(cell, seed, 0.0, False, "cpu").limits
    assert not checks.verdict(numbers, limits), numbers
