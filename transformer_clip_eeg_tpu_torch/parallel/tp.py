"""Tensor parallelism for the wav2vec2 feature-extraction model.

Counterpart of ``transformer_clip_eeg_tpu/parallel/tp.py``: the Megatron
layout of the wav2vec2 encoder over the ``'model'`` axis.  JAX states it as
GSPMD sharding annotations and lets XLA insert the all-reduces; the port
gives each rank its slices of the weights and the forwards of
``models/wav2vec2.py`` all-reduce by hand (``Attention`` and
``FeedForward`` with a ``tp_group``):

* ``q_proj``, ``k_proj``, ``v_proj`` and ``intermediate_dense`` are
  column-sharded: each rank computes its slice of the heads (the reshape to
  ``[B, T, H, hd]`` keeps the head axis on the shard boundary, so the
  attention is local) and of the FFN's hidden units.  In torch's ``[out,
  in]`` layout that slices the weight's rows, and the bias with them.
* ``out_proj`` and ``output_dense`` are row-sharded: the weight's columns
  are sliced, each rank's product is a partial sum, all-reduced over the
  tensor-parallel group; the bias stays whole and is added once, after it.
* The convolutions, the layer norms, the positional conv and the feature
  projection are replicated.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

COLUMN, ROW, REPLICATED = "column", "row", "replicated"
COLUMN_SHARDED = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
ROW_SHARDED = ("out_proj", "output_dense")


def validate_tp(config, n_model: int) -> None:
    """The tensor-parallel degree must divide the head count and the FFN
    width, so that the sharded reshape to ``[B, T, H, hd]`` stays local
    (JAX's check and texts)."""
    if n_model <= 1:
        return
    if config.num_attention_heads % n_model:
        raise ValueError(f"TP degree {n_model} must divide num_attention_heads "
                         f"{config.num_attention_heads}")
    if config.intermediate_size % n_model:
        raise ValueError(f"TP degree {n_model} must divide intermediate_size "
                         f"{config.intermediate_size}")


def _layout_of(name: str) -> str:
    parts = name.split(".")
    if any(p in COLUMN_SHARDED for p in parts):
        return COLUMN
    if any(p in ROW_SHARDED for p in parts):
        return ROW if parts[-1] == "weight" else REPLICATED
    return REPLICATED


def wav2vec2_tp_layout(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """Each parameter of a ``Wav2Vec2Model`` state_dict and its layout over
    the ``'model'`` axis: ``'column'`` (the output dimension, dim 0 of a
    weight and its bias), ``'row'`` (a weight's input dimension, dim 1) or
    ``'replicated'``."""
    return {name: _layout_of(name) for name in state_dict}


def shard_wav2vec2_state_dict(state_dict: Mapping[str, torch.Tensor], n_model: int,
                              model_rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``model_rank``'s slices of a whole ``Wav2Vec2Model`` state_dict
    for a ``'model'`` axis of ``n_model`` (contiguous copies, so a rank holds
    ``1 / n_model`` of each sharded weight)."""
    out = {}
    for name, t in state_dict.items():
        layout = _layout_of(name)
        if layout == REPLICATED or n_model == 1:
            out[name] = t
            continue
        dim = 0 if layout == COLUMN else 1
        if t.shape[dim] % n_model:
            raise ValueError(f"{name}: {tuple(t.shape)} does not split {n_model} ways on "
                             f"dim {dim}")
        out[name] = t.chunk(n_model, dim)[model_rank].contiguous()
    return out
