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
at, so a resumed run knows the bar to beat.  The regression evals' probes
are saved bare (:func:`save_params_only`): a ``state_dict`` in one
``torch.save`` file at the path where the JAX package writes its orbax tree.
The reference's own ``checkpoints/model.ckpt`` is read too
(:func:`restore_torch_checkpoint`), where the port's is missing.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

CKPT_NAME = "model_ckpt.pt"
BEST_META_NAME = "best_meta.json"
REFERENCE_CKPT_NAME = "model.ckpt"  # the reference's torch checkpoint


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


def restore_torch_checkpoint(checkpoint_dir: str, model) -> Optional[list]:
    """Load the reference's ``<dir>/model.ckpt`` (a bare ``state_dict``) into
    ``model``, in place: parameters, batch-norm statistics and the memory
    bank, converted by ``utils/torch_import`` against the model's own
    ``state_dict`` with partial-load semantics; each skipped item is printed.
    The optimizer and scheduler are left as they are: the reference reloads
    weights alone (ref ``train_clip_final.py:443-449,541-556``), and so does
    the JAX package.  Returns the report (checkpoint keys that matched
    nothing, leaves skipped for their shape), or None if there is no such
    file."""
    from transformer_clip_eeg_tpu_torch.utils.torch_import import load_torch_state_dict

    path = os.path.join(checkpoint_dir, REFERENCE_CKPT_NAME)
    if not os.path.exists(path):
        return None
    merged, report = load_torch_state_dict(path, model)
    for item in report:
        print(f"torch checkpoint: skipped {item}")
    model.load_state_dict(merged)
    return report


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


def save_params_only(path: str, state_dict: dict) -> None:
    """Atomically write a bare ``state_dict`` (the probes' analogue of the
    reference's per-subject ``.pth`` files, ref
    ``train_clip_helper_functions.py:660-663``), its tensors on the CPU."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def restore_params_only(path: str, device="cpu") -> dict:
    """The ``state_dict`` :func:`save_params_only` wrote, on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)
