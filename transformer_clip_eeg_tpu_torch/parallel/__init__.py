"""Data parallelism over ``torch.distributed`` ranks (the JAX package's
``parallel/``: mesh construction, joining a multi-process group, and the
port's own collectives)."""

from transformer_clip_eeg_tpu_torch.parallel.distributed import (
    initialize_distributed,
    launch,
)
from transformer_clip_eeg_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    attach,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "attach",
    "initialize_distributed",
    "launch",
    "make_mesh",
    "replicate",
    "shard_batch",
]
