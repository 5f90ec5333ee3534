"""Data and tensor parallelism over ``torch.distributed`` ranks (the JAX
package's ``parallel/``: the ``('data', 'model')`` mesh, joining a
multi-process group, the wav2vec2 extraction's Megatron layout, and the
port's own collectives)."""

from transformer_clip_eeg_tpu_torch.parallel.distributed import (
    initialize_distributed,
    launch,
    run_on_ranks,
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
from transformer_clip_eeg_tpu_torch.parallel.tp import (
    shard_wav2vec2_state_dict,
    validate_tp,
    wav2vec2_tp_layout,
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
    "run_on_ranks",
    "shard_batch",
    "shard_wav2vec2_state_dict",
    "validate_tp",
    "wav2vec2_tp_layout",
]
