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

:func:`attach` hands the mesh to the modules that read it.

The mesh is JAX's ``('data', 'model')`` grid: ``n_data * n_model`` ranks,
rank ``r`` at ``(r // n_model, r % n_model)``.  The ``'model'`` axis
(``n_model > 1``) tensor-shards the wav2vec2 extraction alone
(``parallel/tp.py``); its ranks of one data row form a tensor-parallel group
(:attr:`Mesh.tp_group`), the ranks of one model column a data group
(:attr:`Mesh.data_group`) over which rows are gathered.  With ``n_model ==
1`` the data group is the whole job (``None``: the default group) and there
is no tensor-parallel group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

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
    """This rank's place in an ``n_data`` x ``n_model`` grid of ranks: its
    data row ``rank`` (the rows of a batch it takes) and its ``model_rank``
    in that row."""

    n_data: int
    rank: int
    device: torch.device
    backend: str
    ranks_on_device: int = 1  # ranks sharing this rank's card (or host)
    n_model: int = 1
    model_rank: int = 0
    data_group: Optional[Any] = None  # this model column's ranks; None: every rank
    tp_group: Optional[Any] = None  # this data row's ranks (n_model > 1)

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files."""
        return self.rank == 0 and self.model_rank == 0

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
        grid = "" if self.n_model == 1 else f" x {self.n_model} '{MODEL_AXIS}'"
        return (f"data parallel: {self.n_data} ranks{grid} over {self.backend}, "
                f"{self.ranks_on_device} on each {where}")


def make_mesh(n_data: int, n_model: int = 1, device="cuda") -> Mesh:
    """This process's :class:`Mesh` in the joined ``torch.distributed``
    group, which must have ``n_data * n_model`` ranks.  Every rank of the
    group must call it (the sub-groups of a ``'model'`` axis are made
    collectively)."""
    if n_model < 1 or n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes need at least one rank")
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {n_data}x{n_model} ranks needs a torch.distributed "
                         "group: start the ranks with the entry point (which spawns them) "
                         "or torchrun")
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
                         f"have {world} ranks")
    rank = dist.get_rank()
    local_rank, local_size = local_rank_and_size(rank, world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        sharing = sum(1 for r in range(local_size) if r % n_cards == local_rank % n_cards)
    else:
        sharing = local_size
    data_group = tp_group = None
    if n_model > 1:
        # every rank makes every group, in the same order; the sub-groups take
        # the default group's backend (gloo when ranks share a card)
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                tp_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    return Mesh(n_data, rank // n_model, dev, dist.get_backend(), sharing, n_model,
                rank % n_model, data_group, tp_group)


def data_axis_only(mesh: Optional[Mesh], what: str) -> None:
    """Raise ``ValueError`` when ``mesh`` has a ``'model'`` axis: ``what``
    runs on the ``'data'`` axis alone."""
    if mesh is not None and mesh.n_model > 1:
        raise ValueError(f"{what} runs on the '{DATA_AXIS}' axis alone; a '{MODEL_AXIS}' "
                         f"axis ({mesh.n_model}) shards the wav2vec2 extraction only")


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
    data_axis_only(mesh, "the CLIP model")
    model.mesh = mesh
    for encoder in (model.eegModel, model.speechModel):
        for m in encoder.modules():
            if hasattr(m, "mesh"):
                m.mesh = mesh
