"""The VLAAI baseline EEG decoder, on ``[B, T, C]`` activations.

Counterpart of ``transformer_clip_eeg_tpu/models/vlaai.py``:

* :class:`Extractor`: a 1×1 conv, then five (same-padded Conv1d, joint-[T, C]
  LayerNorm, LeakyReLU) with channels 256, 256, 256, 128, 128 and k=64;
* :class:`OutputContext`: same-padded Conv1d k=64, LayerNorm, LeakyReLU;
* :class:`VLAAI`: one *shared* stack (Extractor → 1×1 recombination →
  OutputContext) applied ``nb_blocks`` times, with the raw input (before the
  first 1×1 conv) added as a skip before every middle block, then a final
  1×1 conv to ``output_dim``.

The LayerNorms' width is the run's window (``time_dimension``), as the JAX
registry wires it.  No kernel of the port is on this path: the convolutions
and norms are PyTorch calls, as in the unfused ``BasicBlock``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import Conv1d, LayerNormTC, leaky_relu


class Extractor(nn.Module):
    def __init__(
        self,
        filters: Tuple[int, ...] = (256, 256, 256, 128, 128),
        kernels: Tuple[int, ...] = (64,) * 5,
        dilation_rate: int = 1,
        input_channels: int = 64,
        time_dimension: int = 64 * 5,
    ):
        super().__init__()
        self.n_layers = len(filters)
        self.eeg = Conv1d(input_channels, input_channels, 1)
        prev = input_channels
        for i, (f, k) in enumerate(zip(filters, kernels)):
            self.add_module(f"conv_{i}", Conv1d(prev, f, k, dilation=dilation_rate))
            self.add_module(f"norm_{i}", LayerNormTC(time_dimension, f))
            prev = f
        self.out_channels = prev

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.eeg(x)
        for i in range(self.n_layers):
            x = leaky_relu(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(x)))
        return x


class OutputContext(nn.Module):
    def __init__(self, in_channels: int = 64, filter_: int = 64, kernel: int = 64,
                 time_dimension: int = 64 * 5):
        super().__init__()
        self.conv1d = Conv1d(in_channels, filter_, kernel)
        self.normalization_fn = LayerNormTC(time_dimension, filter_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.normalization_fn(self.conv1d(x)))


class VLAAI(nn.Module):
    def __init__(
        self,
        nb_blocks: int = 4,
        use_skip: bool = True,
        input_channels: int = 64,
        output_dim: int = 64,
        time_dimension: int = 64 * 5,
        eeg_dim: int = 64,
    ):
        super().__init__()
        self.nb_blocks, self.use_skip, self.output_dim = nb_blocks, use_skip, output_dim
        self.eeg = Conv1d(eeg_dim, input_channels, 1)
        self.extractor = Extractor(input_channels=input_channels,
                                   time_dimension=time_dimension)
        self.linear_recombination = Conv1d(self.extractor.out_channels, input_channels, 1)
        self.output_context = OutputContext(input_channels, input_channels,
                                            time_dimension=time_dimension)
        self.final_linear = Conv1d(input_channels, output_dim, 1)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.output_dim

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x  # the raw input, before the 1x1 conv
        x = self.eeg(x)
        for idx in range(self.nb_blocks):
            if self.use_skip and 0 < idx < self.nb_blocks - 1:
                x = x + skip
            x = self.output_context(self.linear_recombination(self.extractor(x)))
        return self.final_linear(x)
