"""The EEG and speech encoders, on ``[B, T, C]`` activations.

Counterpart of ``transformer_clip_eeg_tpu/models/encoders.py``: the default
run's :class:`EEGConformerInterleaved` (EEG) and :class:`EEGConvLSTM`
(speech), with the conv :class:`BasicBlock` they share, and the rest of the
registry's encoders.  Submodules carry the flax module names, so a JAX
variable tree maps onto the ``state_dict`` name for name
(``utils/convert.py``).

flax infers each layer's input width at init; here every width is a
constructor argument.  ``get_output_dim(window)`` is the reference's
contract, quirks included (``Wav2vecSmallModel`` reports ``window *
filters`` although its stride-3 conv shrinks time); ``output_shape(window)``
is the real ``(T', D)`` of the output, which the heads size their layers
from.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoder
from transformer_clip_eeg_tpu_torch.ops.dropout import mesh_rows
from transformer_clip_eeg_tpu_torch.ops.fused_conv import fused_basic_block
from transformer_clip_eeg_tpu_torch.ops.layers import (
    ACTIVATIONS,
    BatchNorm1d,
    Conv1d,
    Conv2dValidTime,
    Dense,
    Dropout,
    LayerNormTC,
    gelu_exact,
    leaky_relu,
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
            row_offset, global_batch = mesh_rows(self.dropout.mesh, x.shape[0])
            return fused_basic_block(
                x, w, self.conv.bias, self.normalization.weight, self.normalization.bias,
                self.dropout.dropout_seed, w.shape[2], self.dropout.rate, self.training,
                row_offset, global_batch,
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

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, 2 * (self.output_dim // 2)

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

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.eeg_spatial_mapping(x)
        skip = x
        for i in range(self.depth):
            x = getattr(self, f"conv_{i}")(x + skip)
            x = getattr(self, f"conformer_{i}")(x if i == self.depth - 1 else x + skip)
        return self.final_layer(x)


class EEGConformer(nn.Module):
    """N conv BasicBlocks (input skip before all but the last) → one
    depth-``depth`` transformer stack → Dense."""

    def __init__(
        self,
        output_dim: int = 8,
        conformer_input_dim: int = 64,
        dropout_rate: float = 0.2,
        eeg_dim: int = 64,
        filters: Tuple[int, ...] = (64,) * 2,
        kernels: Tuple[int, ...] = (64,) * 2,
        dilation_rate: int = 1,
        time_dimension: int = 64 * 5,
        depth: int = 2,
    ):
        super().__init__()
        self.output_dim, self.n_blocks = output_dim, len(filters)
        self.eeg_spatial_mapping = Conv1d(eeg_dim, filters[0], 1)
        for i in range(self.n_blocks):
            self.add_module(f"conv_{i}", BasicBlock(
                filters[max(i - 1, 0)], filters[i], kernels[i], time_dimension,
                dropout_rate, dilation=dilation_rate,
            ))
        self.transformerEncoder = TransformerEncoder(depth, conformer_input_dim)
        self.final_layer = Dense(conformer_input_dim, output_dim)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.output_dim

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.eeg_spatial_mapping(x)
        skip = x
        n = self.n_blocks
        for i in range(n):
            x = getattr(self, f"conv_{i}")(x if i == n - 1 else x + skip)
        return self.final_layer(self.transformerEncoder(x))


class EEGConvLSTMNew(nn.Module):
    """Conv BasicBlocks straight on the input (skip of the raw input before
    all but the last) → one biLSTM.  ``eeg_spatial_mapping`` is created and
    never applied, as in the reference, so the keys stay compatible."""

    def __init__(
        self,
        output_dim: int = 128,
        dropout_rate: float = 0.2,
        eeg_dim: int = 64,
        filters: Tuple[int, ...] = (256,) * 2,
        kernels: Tuple[int, ...] = (64,) * 2,
        dilation_rate: int = 1,
        input_channels: int = 64,
        time_dimension: int = 64 * 5,
    ):
        super().__init__()
        self.output_dim, self.n_blocks = output_dim, len(filters)
        self.eeg_spatial_mapping = Conv1d(eeg_dim, eeg_dim, 1)  # parameters only
        for i in range(self.n_blocks):
            self.add_module(f"conv_{i}", BasicBlock(
                eeg_dim if i == 0 else filters[i - 1], filters[i], kernels[i],
                time_dimension, dropout_rate, dilation=dilation_rate,
            ))
        self.lstm = LSTM(filters[-1], output_dim // 2, bidirectional=True)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.output_dim

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, 2 * (self.output_dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        n = self.n_blocks
        for i in range(n):
            x = getattr(self, f"conv_{i}")(x if i == n - 1 else x + skip)
        return self.lstm(x)


class EEGModel(nn.Module):
    """BatchNorm → 1×1 conv → BatchNorm → strided valid Conv2d → two
    time-distributed Denses (the registry's 'lstm' EEG encoder)."""

    def __init__(
        self,
        spatial_filters_eeg: int = 32,
        filters_cnn_eeg: int = 16,
        kernel_size_temporal: int = 9,
        stride_temporal: int = 3,
        units_hidden: int = 128,
        units_lstm: int = 32,
        activation: str = "relu",
        eeg_dim: int = 64,
    ):
        super().__init__()
        self.kernel_size_temporal, self.stride_temporal = kernel_size_temporal, stride_temporal
        self.units_lstm = units_lstm
        self.act = ACTIVATIONS[activation]
        self.batchnorm = BatchNorm1d(eeg_dim)
        self.eeg_conv1d = Conv1d(eeg_dim, spatial_filters_eeg, 1)
        self.batchnorm_eeg = BatchNorm1d(spatial_filters_eeg)
        self.eeg_conv2d = Conv2dValidTime(filters_cnn_eeg, kernel_size_temporal,
                                          stride_temporal)
        self.eeg_td1 = Dense(filters_cnn_eeg * spatial_filters_eeg, units_hidden)
        self.eeg_td2 = Dense(units_hidden, units_lstm)

    def get_output_dim(self, input_window_size: int) -> int:
        return int((input_window_size - self.kernel_size_temporal) / self.stride_temporal
                   + 1) * self.units_lstm

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return (Conv2dValidTime.output_length(input_window_size, self.kernel_size_temporal,
                                              self.stride_temporal), self.units_lstm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.act
        x = self.batchnorm_eeg(act(self.eeg_conv1d(self.batchnorm(x))))
        x = act(self.eeg_conv2d(x))
        return act(self.eeg_td2(act(self.eeg_td1(x))))


class EEGExtended(EEGModel):
    """The same stack as :class:`EEGModel`, a class of its own as in the
    reference."""


class EEGLstm(nn.Module):
    """BatchNorm → 1×1 conv → BatchNorm → two stacked unidirectional LSTMs
    (the registry's 'double_lstm', for either stream)."""

    def __init__(
        self,
        spatial_filters: int = 32,
        units_lstm: int = 64,
        speech_dim: int = 64,
        activation: str = "leaky_relu",
    ):
        super().__init__()
        self.units_lstm = units_lstm
        self.act = ACTIVATIONS[activation]
        self.batchnorm_mel1 = BatchNorm1d(speech_dim)
        self.speech_conv1d = Conv1d(speech_dim, spatial_filters, 1)
        self.batchnorm_mel2 = BatchNorm1d(spatial_filters)
        self.speech_lstm1 = LSTM(spatial_filters, units_lstm)
        self.speech_lstm2 = LSTM(units_lstm, units_lstm)

    def get_output_dim(self, input_window_size: int) -> int:
        return input_window_size * self.units_lstm

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, self.units_lstm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batchnorm_mel2(self.act(self.speech_conv1d(self.batchnorm_mel1(x))))
        return self.speech_lstm2(self.speech_lstm1(x))


class MelModel(nn.Module):
    """BatchNorm → 1×1 conv → BatchNorm → strided valid Conv2d → LSTM (the
    registry's 'lstm' speech encoder)."""

    def __init__(
        self,
        spatial_filters: int = 8,
        filters_cnn: int = 16,
        kernel_size_temporal: int = 9,
        stride_temporal: int = 3,
        units_lstm: int = 32,
        speech_dim: int = 28,
        activation: str = "relu",
    ):
        super().__init__()
        self.kernel_size_temporal, self.stride_temporal = kernel_size_temporal, stride_temporal
        self.units_lstm = units_lstm
        self.act = ACTIVATIONS[activation]
        self.batchnorm_mel1 = BatchNorm1d(speech_dim)
        self.speech_conv1d = Conv1d(speech_dim, spatial_filters, 1)
        self.batchnorm_mel2 = BatchNorm1d(spatial_filters)
        self.speech_conv2d = Conv2dValidTime(filters_cnn, kernel_size_temporal,
                                             stride_temporal)
        self.speech_lstm = LSTM(filters_cnn * spatial_filters, units_lstm)

    def get_output_dim(self, input_window_size: int) -> int:
        return int((input_window_size - self.kernel_size_temporal) / self.stride_temporal
                   + 1) * self.units_lstm

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return (Conv2dValidTime.output_length(input_window_size, self.kernel_size_temporal,
                                              self.stride_temporal), self.units_lstm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.act
        x = self.batchnorm_mel2(act(self.speech_conv1d(self.batchnorm_mel1(x))))
        return self.speech_lstm(act(self.speech_conv2d(x)))


class Wav2vecSmallModel(nn.Module):
    """BatchNorm → strided valid Conv1d → LeakyReLU."""

    def __init__(
        self,
        spatial_filters: int = 64,
        kernel_size_temporal: int = 3,
        stride_temporal: int = 3,
        speech_dim: int = 1024,
    ):
        super().__init__()
        self.spatial_filters = spatial_filters
        self.kernel_size_temporal, self.stride_temporal = kernel_size_temporal, stride_temporal
        self.batchnorm_mel1 = BatchNorm1d(speech_dim)
        self.speech_conv1d = Conv1d(speech_dim, spatial_filters, kernel_size_temporal,
                                    stride=stride_temporal, padding="valid")

    def get_output_dim(self, input_window_size: int) -> int:
        # the reference's quirk: the stride-3 time shrink is not counted
        return int(input_window_size * self.spatial_filters)

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return (Conv2dValidTime.output_length(input_window_size, self.kernel_size_temporal,
                                              self.stride_temporal), self.spatial_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.speech_conv1d(self.batchnorm_mel1(x)))


class SpeechSmallConv(nn.Module):
    """Same-padded Conv1d → Dropout → joint-[T, C] LayerNorm → LeakyReLU
    (the registry's 'smallConv')."""

    def __init__(
        self,
        output_dim: int = 64,
        kernel_size_temporal: int = 20,
        dropout_rate: float = 0.2,
        speech_dim: int = 1024,
        time_dimension: int = 64 * 5,
    ):
        super().__init__()
        self.output_dim = output_dim
        self.speech_spatial_mapping = Conv1d(speech_dim, output_dim, kernel_size_temporal)
        self.dropout = Dropout(dropout_rate)
        self.layernorm = LayerNormTC(time_dimension, output_dim)

    def get_output_dim(self, input_window_size: int) -> int:
        return int(input_window_size * self.output_dim)

    def output_shape(self, input_window_size: int) -> Tuple[int, int]:
        return input_window_size, self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.layernorm(self.dropout(self.speech_spatial_mapping(x))))
