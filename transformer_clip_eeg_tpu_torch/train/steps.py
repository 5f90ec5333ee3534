"""The train and validation steps, and the embedding functions.

Counterpart of ``transformer_clip_eeg_tpu/train/steps.py``
(``_split_outputs``, ``make_train_step``, ``make_eval_step``,
``make_embed_fns``).  PyTorch runs eagerly, so a step is a function rather
than a compiled program: forward through both encoders and the head,
backward (the kernels' own backward on the card), the optimizer update,
and the memory bank's EMA update in place.

Warmup (ref ``train_clip_final.py:486-491``): during the first
``warmup_epochs`` epochs the gradient is taken on ``loss_ce`` alone; after
that on ``loss_total``.

Dropout seeds: the step's seed is ``fold_seed(seed, step)`` (the run's seed
folded with the step number, as the JAX step folds its key with
``state.step``), and every dropout layer and transformer block draws its
masks from its own stream of it (``ops.dropout.set_dropout_seeds``), so the
same step on the CPU and on the card drops the same elements.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from transformer_clip_eeg_tpu_torch.models.heads import flatten_features
from transformer_clip_eeg_tpu_torch.ops.dropout import fold_seed, set_dropout_seeds
from transformer_clip_eeg_tpu_torch.ops.layers import l2_normalize


def _split_outputs(model_arch: str, outs) -> Dict[str, torch.Tensor]:
    """Head outputs as named losses: non-KLD heads return ``(loss_ce,
    loss_avg, loss_total)``; KLD heads ``(loss_total, loss_ce, log_pmu2,
    kld_z2)``."""
    if model_arch in ("clip_kld", "clip_kld_latent_proj"):
        loss_total, loss_ce, log_pmu2, kld_z2 = outs
        return {"loss_ce": loss_ce, "loss_total": loss_total,
                "log_pmu2": log_pmu2, "kld_z2": kld_z2}
    loss_ce, loss_avg, loss_total = outs
    return {"loss_ce": loss_ce, "loss_avg": loss_avg, "loss_total": loss_total}


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], seed: int,
               warmup: bool, model_arch: str = "clip_sim_no_latent_proj"
               ) -> Dict[str, torch.Tensor]:
    """One training step on ``batch = {'eeg', 'speech', 'ids'}``: dropout
    from ``fold_seed(seed, optimizer.step)``, the gradient of ``loss_ce``
    (``warmup``) or ``loss_total``, one optimizer update (which bumps the
    step), and the bank's EMA update.  Returns the losses, detached."""
    model.train()
    set_dropout_seeds(model, fold_seed(seed, optimizer.step))
    losses = _split_outputs(model_arch, model(batch["eeg"], batch["speech"], batch["ids"]))
    objective = losses["loss_ce"] if warmup else losses["loss_total"]
    # a parameter the objective does not reach (temperature_eeg in warmup)
    # gets a zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(objective, optimizer.params, allow_unused=True)
    optimizer.apply([torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, optimizer.params)])
    return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              model_arch: str = "clip_sim_no_latent_proj") -> Dict[str, torch.Tensor]:
    """Validation losses in eval mode, without gradients; the memory bank
    still EMA-updates, as the reference's eval forward does."""
    model.eval()
    return _split_outputs(model_arch, model(batch["eeg"], batch["speech"], batch["ids"]))


def make_embed_fns(model) -> Tuple[Callable, Callable]:
    """``(embed_eeg, embed_speech)``: raw windows → flattened, L2-normalised
    embeddings, with the plain flatten the challenge eval uses (not the
    training head's transpose-if-wider quirk)."""

    @torch.inference_mode()
    def embed_eeg(eeg: torch.Tensor) -> torch.Tensor:
        return l2_normalize(flatten_features(model.encode_eeg(eeg)), 1)

    @torch.inference_mode()
    def embed_speech(speech: torch.Tensor) -> torch.Tensor:
        return l2_normalize(flatten_features(model.encode_speech(speech)), 1)

    return embed_eeg, embed_speech
