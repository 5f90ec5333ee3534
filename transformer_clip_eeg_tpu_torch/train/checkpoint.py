"""The port's checkpoint format, with the reference's best-on-val-CE policy.

Counterpart of ``transformer_clip_eeg_tpu/train/checkpoint.py``.  The JAX
package writes an orbax tree; the port writes one ``torch.save`` file,
``checkpoints/model_ckpt.pt``::

    {"step": int,                  # optimizer steps taken
     "model": state_dict,          # parameters and the memory bank
     "optimizer": {...},           # step, lr and the flat Adam moments
     "scheduler": {...}}           # the LR scheduler's attributes

written atomically (a temporary file, then ``os.replace``), so a crash
mid-write leaves the previous checkpoint whole.  ``best_meta.json`` keeps
the JAX package's format: the val ``loss_ce`` the best checkpoint was saved
at, so a resumed run knows the bar to beat.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

CKPT_NAME = "model_ckpt.pt"
BEST_META_NAME = "best_meta.json"


def checkpoint_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, CKPT_NAME)


def save_checkpoint(checkpoint_dir: str, model, optimizer, scheduler=None) -> str:
    """Atomically (over)write ``<dir>/model_ckpt.pt``."""
    path = checkpoint_path(checkpoint_dir)
    payload = {
        "step": optimizer.step,
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": dict(vars(scheduler)) if scheduler is not None else {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(checkpoint_dir: str, device="cpu") -> Optional[dict]:
    """The saved payload with its tensors on ``device``; None if there is no
    checkpoint."""
    path = checkpoint_path(checkpoint_dir)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(checkpoint_dir: str, model, optimizer=None,
                       scheduler=None) -> Optional[int]:
    """Restore the model (parameters and memory bank), the optimizer's step,
    learning rate and moments, and the scheduler, in place; returns the
    step, or None when there is no checkpoint."""
    device = next(model.parameters()).device
    payload = load_checkpoint(checkpoint_dir, device)
    if payload is None:
        return None
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None:
        vars(scheduler).update(payload["scheduler"])
    return int(payload["step"])


def save_best_meta(checkpoint_dir: str, best_loss: float) -> None:
    """Record the val loss_ce the best checkpoint was saved at; written
    atomically and BEFORE ``save_checkpoint`` (a crash between the two then
    leaves a bar lower than the saved checkpoint's, which keeps it)."""
    path = os.path.join(checkpoint_dir, BEST_META_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"best_loss": float(best_loss)}, f)
    os.replace(tmp, path)


def load_best_meta(checkpoint_dir: str) -> Optional[float]:
    """Best val loss_ce recorded next to the checkpoint; None if absent."""
    path = os.path.join(checkpoint_dir, BEST_META_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return float(json.load(f)["best_loss"])
    except (ValueError, KeyError, OSError):
        return None
