"""Transformer blocks with the reference's attention numerics.

Counterpart of ``transformer_clip_eeg_tpu/ops/attention.py``.  Attention
logits are divided by ``emb_size ** 0.5``, the *full* embedding width and not
the head width: a quirk of the reference that trained checkpoints depend on.

Block structure: pre-LN residual blocks, ``x + Drop(MHA(LN(x)))`` then
``x + Drop(FFN(LN(x)))``, 8 heads, FFN expansion 4, exact GELU.  Every
tensor, on the CPU or the card, goes through
:func:`~transformer_clip_eeg_tpu_torch.ops.fused_block.fused_transformer_block`
(the fused kernels on CUDA, their plain twin on the CPU), with the four
dropout masks of the JAX kernel in training mode.  A bf16 input selects the
block's bf16 mode (bf16 operands in every product, float32 sums), as a bf16
activation selects ``mm_dtype='bfloat16'`` in the JAX block: the input's
dtype is the only selector.  The attention and FFN modules below only hold
the parameters, under the flax names.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.dropout import mesh_rows
from transformer_clip_eeg_tpu_torch.ops.fused_block import fused_transformer_block
from transformer_clip_eeg_tpu_torch.ops.layers import Dense, LayerNorm


class MultiHeadAttention(nn.Module):
    """The parameters of self-attention: separate Q/K/V projections and the
    output projection."""

    def __init__(self, emb_size: int):
        super().__init__()
        self.queries = Dense(emb_size, emb_size)
        self.keys = Dense(emb_size, emb_size)
        self.values = Dense(emb_size, emb_size)
        self.projection = Dense(emb_size, emb_size)


class FeedForwardBlock(nn.Module):
    """The parameters of Dense(e→4e) → exact GELU → Dropout → Dense(4e→e)."""

    def __init__(self, emb_size: int, expansion: int = 4):
        super().__init__()
        self.fc1 = Dense(emb_size, expansion * emb_size)
        self.fc2 = Dense(expansion * emb_size, emb_size)


class TransformerEncoderBlock(nn.Module):
    """Pre-LN residual block, run by the fused block on every device.

    ``dropout_seed`` keys the four masks of the next forward in training
    mode (set per step by ``ops.dropout.set_dropout_seeds``); under a mesh
    (``parallel.attach``) they are the global batch's masks of this rank's
    rows."""

    def __init__(
        self,
        emb_size: int,
        num_heads: int = 8,
        drop_p: float = 0.5,
        forward_expansion: int = 4,
        forward_drop_p: float = 0.5,
    ):
        super().__init__()
        self.emb_size, self.num_heads = emb_size, num_heads
        self.drop_p, self.forward_drop_p = drop_p, forward_drop_p
        self.dropout_seed = 0
        self.mesh = None
        self.ln1 = LayerNorm(emb_size)
        self.attn = MultiHeadAttention(emb_size)
        self.ln2 = LayerNorm(emb_size)
        self.ffn = FeedForwardBlock(emb_size, forward_expansion)

    def fused_params(self):
        """The fused kernel's 16-tuple (``ops/fused_block.py``), as views."""
        a, f = self.attn, self.ffn
        return (
            self.ln1.weight, self.ln1.bias,
            a.queries.weight, a.keys.weight, a.values.weight,
            a.queries.bias, a.keys.bias, a.values.bias,
            a.projection.weight, a.projection.bias,
            self.ln2.weight, self.ln2.bias,
            f.fc1.weight, f.fc1.bias, f.fc2.weight, f.fc2.bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        row_offset, global_batch = mesh_rows(self.mesh, x.shape[0])
        return fused_transformer_block(
            x, self.fused_params(), self.num_heads, self.emb_size ** 0.5,
            training=self.training, seed=self.dropout_seed,
            drop_p=self.drop_p, ffn_drop_p=self.forward_drop_p,
            row_offset=row_offset, global_batch=global_batch,
        )


class TransformerEncoder(nn.Module):
    """Stack of ``depth`` blocks, named ``block_0`` … as in the JAX tree."""

    def __init__(self, depth: int, emb_size: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerEncoderBlock(emb_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return x
