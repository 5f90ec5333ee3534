"""The flagship's EEG and speech encoders, on ``[B, T, C]`` activations.

Counterpart of ``transformer_clip_eeg_tpu/models/encoders.py`` for the two
encoders of the default run: :class:`EEGConformerInterleaved` (EEG) and
:class:`EEGConvLSTM` (speech), with the conv :class:`BasicBlock` they share.
Submodules carry the flax module names, so a JAX variable tree maps onto
the ``state_dict`` name for name (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoder
from transformer_clip_eeg_tpu_torch.ops.fused_conv import fused_basic_block
from transformer_clip_eeg_tpu_torch.ops.layers import (
    Conv1d,
    Dense,
    Dropout,
    LayerNormTC,
    gelu_exact,
)
from transformer_clip_eeg_tpu_torch.ops.lstm import LSTM


class BasicBlock(nn.Module):
    """Conv1d(same) → Dropout → joint-[T, C] LayerNorm → exact GELU.

    ``fused`` is the JAX block's ``use_pallas``: off by default, and set by
    no encoder, config field or flag.  When it is on and the block is square
    (input channels = output channels) with dilation 1, the forward is
    :func:`~transformer_clip_eeg_tpu_torch.ops.fused_conv.fused_basic_block`
    on this block's own conv, LayerNorm and dropout parameters and seed
    (kernels #5-#7 on the card, their plain twin on the CPU); any other
    block takes the unfused path, as JAX's rule does (``encoders.py:100-107``).
    The parameters are the same either way.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 64,
        time_dimension: int = 320,
        dropout_rate: float = 0.2,
        dilation: int = 1,
        fused: bool = False,
    ):
        super().__init__()
        self.fused = fused
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation)
        self.dropout = Dropout(dropout_rate)
        self.normalization = LayerNormTC(time_dimension, out_channels)

    @property
    def takes_fused_path(self) -> bool:
        out_c, in_c, _ = self.conv.weight.shape
        return self.fused and in_c == out_c and self.conv.dilation == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_fused_path:
            w = self.conv.weight
            return fused_basic_block(
                x, w, self.conv.bias, self.normalization.weight, self.normalization.bias,
                self.dropout.dropout_seed, w.shape[2], self.dropout.rate, self.training,
            )
        return gelu_exact(self.normalization(self.dropout(self.conv(x))))


class EEGConvLSTM(nn.Module):
    """1×1 spatial map → N BasicBlocks (input skip before all but the last)
    → two biLSTMs.  The default speech encoder."""

    def __init__(
        self,
        units_lstm: int = 128,
        output_dim: int = 64,
        dropout_rate: float = 0.2,
        eeg_dim: int = 64,
        filters: Tuple[int, ...] = (256, 256, 256, 128, 128),
        kernels: Tuple[int, ...] = (64,) * 5,
        dilation_rate: int = 1,
        time_dimension: int = 64 * 5,
    ):
        super().__init__()
        self.output_dim = output_dim
        self.n_blocks = len(filters)
        self.eeg_spatial_mapping = Conv1d(eeg_dim, filters[0], 1)
        for i in range(self.n_blocks):
            self.add_module(f"conv_{i}", BasicBlock(
                filters[max(i - 1, 0)], filters[i], kernels[i], time_dimension,
                dropout_rate, dilation=dilation_rate,
            ))
        self.speech_lstm1 = LSTM(filters[-1], units_lstm, bidirectional=True)
        self.speech_lstm2 = LSTM(2 * units_lstm, output_dim // 2, bidirectional=True)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.eeg_spatial_mapping(x)
        skip = x
        n = self.n_blocks
        for i in range(n):
            # skip added before every block except the last
            x = getattr(self, f"conv_{i}")(x if i == n - 1 else x + skip)
        return self.speech_lstm2(self.speech_lstm1(x))


class EEGConformerInterleaved(nn.Module):
    """``depth``× (conv BasicBlock + one transformer block) → Dense.  The
    default EEG encoder.  The spatially mapped input is added before every
    conv stage and before every transformer stage but the last."""

    def __init__(
        self,
        output_dim: int = 8,
        conformer_input_dim: int = 64,
        dropout_rate: float = 0.2,
        eeg_dim: int = 64,
        filters: Tuple[int, ...] = (64,),
        kernels: Tuple[int, ...] = (64,),
        dilation_rate: int = 1,
        time_dimension: int = 64 * 5,
        depth: int = 4,
    ):
        super().__init__()
        if filters[0] != conformer_input_dim:
            raise ValueError(f"filters[0]={filters[0]} must equal "
                             f"conformer_input_dim={conformer_input_dim}")
        self.output_dim, self.depth = output_dim, depth
        self.eeg_spatial_mapping = Conv1d(eeg_dim, filters[0], 1)
        for i in range(depth):
            self.add_module(f"conv_{i}", BasicBlock(
                filters[0], filters[0], kernels[0], time_dimension, dropout_rate,
                dilation=dilation_rate,
            ))
            self.add_module(f"conformer_{i}", TransformerEncoder(1, conformer_input_dim))
        self.final_layer = Dense(conformer_input_dim, output_dim)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.eeg_spatial_mapping(x)
        skip = x
        for i in range(self.depth):
            x = getattr(self, f"conv_{i}")(x + skip)
            x = getattr(self, f"conformer_{i}")(x if i == self.depth - 1 else x + skip)
        return self.final_layer(x)
