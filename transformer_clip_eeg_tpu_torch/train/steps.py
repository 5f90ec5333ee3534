"""The train and validation steps, and the embedding functions.

Counterpart of ``transformer_clip_eeg_tpu/train/steps.py``
(``_split_outputs``, ``make_train_step``, ``make_eval_step``, the chunk
steps of the device-resident store, ``make_encode_fn``, ``make_embed_fns``).
PyTorch runs eagerly, so a step is a function rather than a compiled
program: forward through both encoders and the head, backward (the kernels'
own backward on the card), the optimizer update, and the memory bank's EMA
update in place.  The chunk steps gather their batch on the device from a
resident chunk (``train/device_data.gather_batch``) and then run the same
step; the JAX package's ``lax.scan`` over a chunk's batches is the
trainer's plain loop of chunk steps (``train/loop.py``), with the same
per-step seeds, so its losses are those of the per-batch steps.

Warmup (ref ``train_clip_final.py:486-491``): during the first
``warmup_epochs`` epochs the gradient is taken on ``loss_ce`` alone; after
that on ``loss_total``.

Dropout seeds: the step's seed is ``fold_seed(seed, step)`` (the run's seed
folded with the step number, as the JAX step folds its key with
``state.step``), and every dropout layer and transformer block draws its
masks from its own stream of it (``ops.dropout.set_dropout_seeds``), so the
same step on the CPU and on the card drops the same elements.

Mixup and augmentation (``add_eeg``, ``augmentations``; ref
``dataset_loader.py:333-356,424-434``) run on the batch's device before the
encoders, mixup first, as in JAX: mixup draws from
``fold_seed(step_seed, MIXUP_STREAM)`` and the augmentations from
``fold_seed(step_seed, AUGMENT_STREAM)`` (``ops/augment.py``), streams no
dropout layer takes.  Validation runs neither.

Data parallelism (``model.mesh``, set by ``parallel.attach``; JAX's train
step under a mesh): every rank draws the same global batch and steps on its
rows of it.  :func:`train_step` and :func:`eval_step` take this rank's rows;
the chunk steps take the global batch's index vectors and gather this
rank's rows.  Mixup, the augmentations and every dropout mask draw by the
row's global index, the head gathers the embeddings (so every rank's loss
is the global batch's), and the flat gradient is averaged over the ranks
before the optimizer, so each rank's update is the one-process step's.

``compute_dtype="bfloat16"`` (``--compute_dtype``) casts the batch's EEG and
speech to bf16 after mixup and the augmentations, in the train steps only,
as the JAX train step does: the encoders then run in bf16 (every layer
follows its input's dtype, the fused blocks take their bf16 mode), the heads
flatten back to float32, and the parameters, optimizer state, memory bank
and batch-norm statistics stay float32.  The validation steps, the
embedding functions, the eval suite and serving run float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from transformer_clip_eeg_tpu_torch.models.heads import flatten_features
from transformer_clip_eeg_tpu_torch.ops.augment import (
    AUGMENT_STREAM,
    MIXUP_STREAM,
    apply_batch_mixup,
    draw_batch_mixup,
    make_augmentation_fn,
)
from transformer_clip_eeg_tpu_torch.ops.dropout import fold_seed, set_dropout_seeds
from transformer_clip_eeg_tpu_torch.ops.layers import l2_normalize
from transformer_clip_eeg_tpu_torch.parallel.collectives import (
    all_gather_rows,
    mean_gradients,
)
from transformer_clip_eeg_tpu_torch.train.device_data import gather_batch
from transformer_clip_eeg_tpu_torch.utils import tracing


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


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _apply_mixup(key: int, eeg: torch.Tensor, partner_eeg: torch.Tensor,
                 probability: float, row0: int = 0) -> torch.Tensor:
    """Batch-level cross-subject mixup: per row, with ``probability``, the
    convex combination with the same window of a random other subject
    (``partner_eeg``, gathered by the data path), weight ~ U(0, 1); the
    batch's first row is row ``row0`` of the global batch."""
    return apply_batch_mixup(eeg, partner_eeg, **draw_batch_mixup(
        key, eeg.shape[0], probability, eeg.device, row0))


def train_step(model, optimizer, batch: Dict[str, torch.Tensor], seed: int,
               warmup: bool, model_arch: str = "clip_sim_no_latent_proj",
               augmentations: Sequence[str] = (), augmentation_probability: float = 0.5,
               add_eeg: bool = False, compute_dtype: str = "float32"
               ) -> Dict[str, torch.Tensor]:
    """One training step on ``batch = {'eeg', 'speech', 'ids'[,
    'partner_eeg']}``: mixup (``add_eeg``) and the augmentations on the EEG,
    the cast to ``compute_dtype`` (a key of :data:`COMPUTE_DTYPES`), dropout from ``fold_seed(seed, optimizer.step)``, the gradient
    of ``loss_ce`` (``warmup``) or ``loss_total``, one optimizer update
    (which bumps the step), and the bank's EMA update.  Under a mesh
    ``batch`` is this rank's rows and the gradient is the ranks' mean.
    Returns the losses, detached.  Its spans: ``train.step`` (unless the
    caller's step holds it), ``train.forward``, ``train.backward``,
    ``train.optimizer`` (``utils/tracing.py``)."""
    with tracing.step():
        with tracing.span(tracing.FORWARD):
            model.train()
            mesh = model.mesh
            step_seed = fold_seed(seed, optimizer.step)
            eeg = batch["eeg"]
            row0 = 0 if mesh is None else mesh.rank * eeg.shape[0]
            if add_eeg:
                eeg = _apply_mixup(fold_seed(step_seed, MIXUP_STREAM), eeg,
                                   batch["partner_eeg"], augmentation_probability, row0)
            if augmentations:
                augment = make_augmentation_fn(augmentations, augmentation_probability)
                eeg = augment(fold_seed(step_seed, AUGMENT_STREAM), eeg, row0)
            speech = batch["speech"]
            # float32 leaves the batch as it is (a float64 model's too)
            if compute_dtype != "float32":
                cast = COMPUTE_DTYPES[compute_dtype]
                eeg, speech = eeg.to(cast), speech.to(cast)
            set_dropout_seeds(model, step_seed)
            losses = _split_outputs(model_arch, model(eeg, speech, batch["ids"]))
        with tracing.span(tracing.BACKWARD):
            objective = losses["loss_ce"] if warmup else losses["loss_total"]
            # a parameter the objective does not reach (temperature_eeg in warmup)
            # gets a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(objective, optimizer.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, optimizer.params)]
            if mesh is not None:
                grads = mean_gradients(grads, mesh)
        with tracing.span(tracing.OPTIMIZER):
            optimizer.apply(grads)
        return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              model_arch: str = "clip_sim_no_latent_proj") -> Dict[str, torch.Tensor]:
    """Validation losses in eval mode, without gradients; the memory bank
    still EMA-updates, as the reference's eval forward does.  Under a mesh
    ``batch`` is this rank's rows and the losses are the global batch's."""
    model.eval()
    return _split_outputs(model_arch, model(batch["eeg"], batch["speech"], batch["ids"]))


def _rank_rows(mesh, idx, subs, partner):
    """This rank's rows of the global batch's index vectors."""
    if mesh is None:
        return idx, subs, partner
    rows = mesh.rows(idx.shape[0])
    return idx[rows], subs[rows], None if partner is None else partner[rows]


def chunk_train_step(model, optimizer, eeg_chunk, speech_chunk, ids_chunk,
                     idx: torch.Tensor, subs: torch.Tensor, seed: int, warmup: bool,
                     model_arch: str = "clip_sim_no_latent_proj",
                     augmentations: Sequence[str] = (), augmentation_probability: float = 0.5,
                     add_eeg: bool = False, partner: Optional[torch.Tensor] = None,
                     compute_dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """:func:`train_step` on the batch gathered from a resident chunk;
    ``idx``, ``subs`` and (with ``add_eeg``) the mixup partners' subjects
    ``partner`` are int64 index vectors on the chunk's device, the global
    batch's (under a mesh this rank gathers its rows).  A bf16 store
    is gathered, upcast, mixed, augmented and then cast to ``compute_dtype``,
    in the JAX step's order.  The gather is the span ``train.gather``."""
    with tracing.step():
        with tracing.span(tracing.GATHER):
            idx, subs, partner = _rank_rows(model.mesh, idx, subs, partner)
            batch = gather_batch(eeg_chunk, speech_chunk, ids_chunk, idx, subs, add_eeg,
                                 partner)
        return train_step(model, optimizer, batch, seed, warmup, model_arch, augmentations,
                          augmentation_probability, add_eeg, compute_dtype)


def chunk_eval_step(model, eeg_chunk, speech_chunk, ids_chunk, idx: torch.Tensor,
                    subs: torch.Tensor, model_arch: str = "clip_sim_no_latent_proj"
                    ) -> Dict[str, torch.Tensor]:
    """:func:`eval_step` on the batch gathered from a resident chunk (the
    global batch's index vectors, as :func:`chunk_train_step`)."""
    idx, subs, _ = _rank_rows(model.mesh, idx, subs, None)
    return eval_step(model, gather_batch(eeg_chunk, speech_chunk, ids_chunk, idx, subs),
                     model_arch)


def _over_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` applied to this rank's rows of each chunk and the ranks'
    outputs all-gathered, so every rank gets the whole chunk's (JAX
    ``mesh_embed_setup``: the encoders are batch-parallel, and a chunk must
    divide by the ranks); ``fn`` itself without a mesh."""
    if mesh is None:
        return fn

    @torch.inference_mode()
    def sharded(x: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(fn(x[mesh.rows(x.shape[0])]), mesh)

    return sharded


def make_encode_fn(model) -> Callable:
    """The raw EEG encoder (no flatten, no normalisation): the regression
    evals read its per-timestep embeddings ``[B, T', D]``.  Under the
    model's mesh each chunk is split over the ranks."""

    @torch.inference_mode()
    def encode_eeg(eeg: torch.Tensor) -> torch.Tensor:
        return model.encode_eeg(eeg)

    return _over_mesh(encode_eeg, model.mesh)


def make_embed_fns(model) -> Tuple[Callable, Callable]:
    """``(embed_eeg, embed_speech)``: raw windows → flattened, L2-normalised
    embeddings, with the plain flatten the challenge eval uses (not the
    training head's transpose-if-wider quirk).  Under the model's mesh each
    chunk is split over the ranks."""

    @torch.inference_mode()
    def embed_eeg(eeg: torch.Tensor) -> torch.Tensor:
        return l2_normalize(flatten_features(model.encode_eeg(eeg)), 1)

    @torch.inference_mode()
    def embed_speech(speech: torch.Tensor) -> torch.Tensor:
        return l2_normalize(flatten_features(model.encode_speech(speech)), 1)

    return _over_mesh(embed_eeg, model.mesh), _over_mesh(embed_speech, model.mesh)
