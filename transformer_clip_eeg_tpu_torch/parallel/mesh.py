"""The data-parallel mesh: which rank this process is, and its rows.

Counterpart of ``transformer_clip_eeg_tpu/parallel/mesh.py``.  JAX shards
the batch over the ``'data'`` axis of a ``jax.sharding.Mesh``, replicates
the state, and GSPMD inserts one all-gather of the L2-normalised embeddings
before the global B x B similarity and a reduce of the gradients.  The
port builds the same step by hand on ``torch.distributed`` ranks, one
process each (``parallel/distributed.py`` starts and joins them):

* every rank draws the same global batch and keeps rows ``[r B/N, (r+1)
  B/N)`` of it (:meth:`Mesh.rows`; a batch that does not divide raises, as
  JAX's ``NamedSharding`` refuses an uneven batch);
* the encoders run on those rows; each per-row random draw (dropout masks,
  augmentations, mixup) is keyed by the row's global index, so the rows
  drop and draw what they do in the one-process step;
* the heads all-gather the embeddings and the ids, so every rank computes
  the global InfoNCE, the same loss, and the same memory-bank update;
* the flat gradient is averaged over the ranks before the optimizer
  (``parallel/collectives.py``); batch norms take global statistics.

:func:`attach` hands the mesh to the modules that read it.  ``n_model > 1``
(the wav2vec2 extraction's tensor-parallel axis) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch
import torch.distributed as dist
from torch import nn

from transformer_clip_eeg_tpu_torch.parallel.collectives import broadcast_
from transformer_clip_eeg_tpu_torch.parallel.distributed import (
    local_rank_and_size,
    rank_device,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data``-way data-parallel group (the
    default ``torch.distributed`` group)."""

    n_data: int
    rank: int
    device: torch.device
    backend: str
    ranks_on_device: int = 1  # ranks sharing this rank's card (or host)

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files."""
        return self.rank == 0

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a batch of ``global_batch``."""
        if global_batch % self.n_data:
            raise ValueError(f"batch of {global_batch} rows does not divide over the "
                             f"{self.n_data} ranks of the '{DATA_AXIS}' axis")
        b = global_batch // self.n_data
        return slice(self.rank * b, (self.rank + 1) * b)

    def describe(self) -> str:
        """One line for ``loss.txt``: the ranks, the backend, how many share a
        card."""
        where = "card" if self.device.type == "cuda" else "host"
        return (f"data parallel: {self.n_data} ranks over {self.backend}, "
                f"{self.ranks_on_device} on each {where}")


def make_mesh(n_data: int, n_model: int = 1, device="cuda") -> Mesh:
    """This process's :class:`Mesh` in the joined ``torch.distributed``
    group, which must have ``n_data`` ranks."""
    if n_model > 1:
        raise NotImplementedError(
            f"a '{MODEL_AXIS}' axis of {n_model} (the tensor-parallel wav2vec2 extraction) is "
            "not ported to the torch package yet (see ROADMAP.md for the modules still to port)")
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {n_data} ranks needs a torch.distributed group: start "
                         "the ranks with cli.main (which spawns them) or torchrun")
    world = dist.get_world_size()
    if world != n_data:
        raise ValueError(f"mesh of {n_data} data ranks, but the group has {world}")
    rank = dist.get_rank()
    local_rank, local_size = local_rank_and_size(rank, world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        sharing = sum(1 for r in range(local_size) if r % n_cards == local_rank % n_cards)
    else:
        sharing = local_size
    return Mesh(n_data, rank, dev, dist.get_backend(), sharing)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of every array of a global batch (numpy or torch)."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Make every rank's ``tensors`` rank 0's, in place (one broadcast per
    dtype of one flat buffer)."""
    broadcast_(list(tensors), mesh)


def attach(model: nn.Module, mesh) -> None:
    """Hand ``mesh`` (or None) to the head and to every module of its
    encoders that reads it: those with a ``mesh`` attribute (the dropouts,
    the transformer blocks, the batch norms).  A head's own layers run on
    the gathered global batch and keep no mesh."""
    model.mesh = mesh
    for encoder in (model.eegModel, model.speechModel):
        for m in encoder.modules():
            if hasattr(m, "mesh"):
                m.mesh = mesh
