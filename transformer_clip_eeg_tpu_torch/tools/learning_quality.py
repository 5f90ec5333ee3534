"""The learning-quality gate: a model of the flagship's architecture, trained
on the correlated synthetic fixture, must beat chance by a wide margin.

Counterpart of the JAX package's ``scripts/learning_quality_flagship.py``
(depth 10, the flagship's widths) and ``tests/test_learning_quality.py``
(depth 2), with their recipe and thresholds: ``make_fixture(root,
n_stories=4, n_subjects=3, story_seconds=90, speech_dim=16, seed=3)``,
batch 8, 12 epochs, patience 12, no scheduler, datasets of 192-sample
windows at hop 192 (the training set shuffled, seed 0); then the
match-mismatch evaluation on the fixture's ``icassp/TEST_task1_matchmismatch``.
The gate holds when the best validation CE is below 1.4 (the chance
plateau is ln 8 = 2.08), the mean match-mismatch accuracy is at least 0.7
(chance 0.5) and the top-1 retrieval over the 12 candidates at least 0.3
(chance 1/12).

    python -m transformer_clip_eeg_tpu_torch.tools.learning_quality --out <dir>
    ... --compute_dtype bfloat16     (the bf16 training mode)
    ... --attention_depth 2 --lstm_units 16 --latent_dim 4 --device cpu

Prints one JSON line (best and per-epoch validation CE, accuracy, top-1,
training seconds, the dtype, the device with its power limit) and exits 1
when a threshold is missed.  Runs on the card unless ``--device cpu``; with
no card ``--device cuda`` raises.  Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval.match_mismatch import evaluate_model_challenge_2023_mm
from transformer_clip_eeg_tpu_torch.models.registry import resolve_device
from transformer_clip_eeg_tpu_torch.tools import device_name
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.loop import Trainer

FIXTURE = dict(n_stories=4, n_subjects=3, story_seconds=90, speech_dim=16, seed=3)
WINDOW = 192  # samples at 64 Hz, also the hop
MAX_BEST_VAL_CE = 1.4
MIN_MM_ACCURACY = 0.7
MIN_TOP1 = 0.3


def fixture_root(work_dir: str) -> str:
    """The gate's fixture under ``work_dir/data``, written once."""
    root = os.path.join(work_dir, "data")
    if not os.path.exists(os.path.join(root, "fold_split.json")):
        make_fixture(root, **FIXTURE)
    return root


def make_trainer(work_dir: str, *, attention_depth: int = 10, lstm_units: int = 128,
                 latent_dim: int = 8, epochs: int = 12, batch_size: int = 8,
                 compute_dtype: str = "float32", device="cuda") -> Trainer:
    """The gate's trainer, before ``fit``: its run directory is
    ``work_dir/run_<dtype>_depth<d>``, which must not exist yet (a trainer
    resumes from a checkpoint it finds there)."""
    resolve_device(device)  # no card: raise before anything is written
    root = fixture_root(work_dir)
    cfg = TrainConfig(
        data_dir=root, run=0, batch_size=batch_size, epochs=epochs, patience=epochs,
        attention_depth=attention_depth, latent_dim=latent_dim, lstm_units=lstm_units,
        number_of_training_subjects=FIXTURE["n_subjects"],
        speech_dim_override=FIXTURE["speech_dim"], lr_scheduler="no",
        compute_dtype=compute_dtype,
    )
    run_dir = os.path.join(work_dir, f"run_{compute_dtype}_depth{attention_depth}")
    if os.path.exists(run_dir):
        raise FileExistsError(f"{run_dir} exists: the gate trains from scratch")
    files = get_train_val_test_files_final(root, 0, "wav2vec_19", cfg.fold_split_path,
                                           FIXTURE["n_subjects"])
    train_ds = EEGWindowDataset(files[0], files[4], WINDOW, WINDOW, batch_size=batch_size,
                                shuffle=True, shuffle_percentage=1.0, seed=0)
    val_ds = EEGWindowDataset(files[1], files[5], WINDOW, WINDOW, batch_size=batch_size,
                              seed=0)
    return Trainer(cfg, train_ds, val_ds, results_dir=run_dir, device=device)


def evaluate_gate(trainer: Trainer) -> dict:
    """The match-mismatch accuracy and top-1 retrieval of the trainer's
    model on the fixture's challenge set."""
    mm_dir = os.path.join(trainer.cfg.data_dir, "icassp", "TEST_task1_matchmismatch")
    ev, _, ev_topx, _ = evaluate_model_challenge_2023_mm(trainer.model, mm_dir,
                                                         speech_feature="wav2vec_19")
    return {"mm_mean_accuracy": float(np.mean(list(ev.values()))),
            "top1_retrieval": float(np.mean([c[0] for c in ev_topx.values()]))}


def gate_passed(rec: dict) -> bool:
    return (rec["best_val_loss_ce"] < MAX_BEST_VAL_CE
            and rec["mm_mean_accuracy"] >= MIN_MM_ACCURACY
            and rec["top1_retrieval"] >= MIN_TOP1)


def run_gate(work_dir: str, *, attention_depth: int = 10, lstm_units: int = 128,
             latent_dim: int = 8, epochs: int = 12, batch_size: int = 8,
             compute_dtype: str = "float32", device="cuda") -> dict:
    """Train, evaluate and judge one gate run; returns its record
    (``passed`` is the verdict)."""
    trainer = make_trainer(work_dir, attention_depth=attention_depth, lstm_units=lstm_units,
                           latent_dim=latent_dim, epochs=epochs, batch_size=batch_size,
                           compute_dtype=compute_dtype, device=device)
    t0 = time.perf_counter()
    out = trainer.fit()
    train_s = time.perf_counter() - t0
    rec = {
        "device": device_name(device),
        "compute_dtype": compute_dtype,
        "attention_depth": attention_depth,
        "lstm_units": lstm_units,
        "latent_dim": latent_dim,
        "epochs": epochs,
        "batch_size": batch_size,
        "best_val_loss_ce": float(out["best_loss"]),
        "best_epoch": int(out["best_epoch"]),
        "val_loss_ce": [float(h["val_loss_ce"]) for h in out["history"]],
        **evaluate_gate(trainer),
        "train_s": train_s,
        "thresholds": {"best_val_loss_ce_below": MAX_BEST_VAL_CE,
                       "mm_mean_accuracy_at_least": MIN_MM_ACCURACY,
                       "top1_retrieval_at_least": MIN_TOP1},
    }
    rec["passed"] = gate_passed(rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="work directory (fixture and runs)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--attention_depth", type=int, default=10)
    ap.add_argument("--lstm_units", type=int, default=128)
    ap.add_argument("--latent_dim", type=int, default=8)
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run_gate(args.out, attention_depth=args.attention_depth, lstm_units=args.lstm_units,
                   latent_dim=args.latent_dim, epochs=args.epochs, batch_size=args.batch_size,
                   compute_dtype=args.compute_dtype, device=args.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
