"""The auxiliary baseline networks, kept for experiment parity.

Counterpart of ``transformer_clip_eeg_tpu/models/baselines.py`` (ref
``ClassificationHead`` clip_model.py:102-125, ``FCNN`` :1496-1522, ``CNN``
(EEGNet-style) :1525-1597).  No command line builds them, as in the
reference and JAX.  The modules follow ``self.training``: batch statistics
and dropout in training mode, running statistics in eval mode.  Running
statistics are buffers, as in the port's ``BatchNorm1d``; ``utils/convert.
state_dict_from_jax`` carries JAX's variables across.  Plain PyTorch calls
throughout: no kernel of the port lies on this path (none of JAX's does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import Dense, Dropout, elu, torch_uniform_init


class ClassificationHead(nn.Module):
    """Flatten → ``in_features``→256→32→4 MLP with ELU and dropout; returns
    (flattened, logits).  JAX infers ``in_features`` (2440 in the reference)
    from its input."""

    def __init__(self, in_features: int = 2440):
        super().__init__()
        self.fc1 = Dense(in_features, 256)
        self.drop1 = Dropout(0.5)
        self.fc2 = Dense(256, 32)
        self.drop2 = Dropout(0.3)
        self.fc3 = Dense(32, 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(x.shape[0], -1)
        out = self.drop1(elu(self.fc1(x)))
        out = self.drop2(elu(self.fc2(out)))
        return x, self.fc3(out)


class SqueezeLayer(nn.Module):
    """``torch.squeeze(x, axis)``: a no-op on a non-unit axis (ref
    clip_model.py:127-133)."""

    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.squeeze(self.axis)


class Conv2d(nn.Module):
    """Torch-layout grouped Conv2d, stride 1, ``'same'`` (torch's split: the
    odd pad on the right) or ``'valid'``: ``[B, C, H, W]``, weight ``[O,
    I/groups, kH, kW]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 padding: str = "valid", groups: int = 1):
        super().__init__()
        if padding not in ("same", "valid"):
            raise ValueError(f"padding {padding!r}: 'same' or 'valid'")
        kh, kw = kernel_size
        self.padding, self.groups = padding, groups
        self.fan_in = (in_channels // groups) * kh * kw
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.fan_in, generator)
        torch_uniform_init(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "same":
            kh, kw = self.weight.shape[2:]
            x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        return F.conv2d(x, self.weight, self.bias, groups=self.groups)


class BatchNorm2d(nn.Module):
    """torch ``nn.BatchNorm2d(C)`` over ``[B, C, H, W]``: batch statistics
    (biased variance) in training mode, ``running_var`` updated with the
    unbiased one at momentum 0.1; running statistics in eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, self.momentum, self.eps)


class ConvBlock(nn.Module):
    """Conv2d → BatchNorm2d → ReLU or ELU (ref clip_model.py:644-655)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 padding: str = "valid", activation: str = "relu"):
        super().__init__()
        if activation not in ("relu", "elu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.conv = Conv2d(in_channels, out_channels, kernel_size, padding=padding)
        self.batchnorm = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batchnorm(self.conv(x))
        return F.relu(x) if self.activation == "relu" else elu(x)


class FCNN(nn.Module):
    """Fully connected ladder decoder (ref clip_model.py:1496-1522):
    ``num_hidden`` tanh layers whose widths fall linearly from the flattened
    input to 1; ``[B, ...]`` → ``[B]``."""

    def __init__(self, num_hidden: int = 1, dropout_rate: float = 0.3,
                 input_length: int = 50, num_input_channels: int = 63):
        super().__init__()
        units = np.round(np.linspace(1, input_length * num_input_channels,
                                     num_hidden + 2)[::-1]).astype(int)
        self.n_hidden = len(units) - 2
        for i in range(len(units) - 1):
            setattr(self, f"fc_{i}", Dense(int(units[i]), int(units[i + 1])))
            if i < self.n_hidden:
                setattr(self, f"drop_{i}", Dropout(dropout_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_hidden):
            x = getattr(self, f"drop_{i}")(torch.tanh(getattr(self, f"fc_{i}")(x)))
        return getattr(self, f"fc_{self.n_hidden}")(x).reshape(-1)


class CNN(nn.Module):
    """EEGNet-style CNN decoder (ref clip_model.py:1525-1597): ``[B, C, T]``
    → ``[B]``.  A temporal conv, a depthwise spatial conv, ELU and average
    pooling by 2, a separable conv, ELU and pooling by 5, then a Dense."""

    def __init__(self, F1: int = 16, D: int = 16, F2: int = 16, dropout_rate: float = 0.25,
                 input_length: int = 50, num_input_channels: int = 63):
        super().__init__()
        self.tp1, self.tp2 = 2, 5
        self.conv1 = Conv2d(1, F1, (1, 3), padding="same")
        self.bnorm1 = BatchNorm2d(F1)
        self.conv2 = Conv2d(F1, F1 * D, (num_input_channels, 1), groups=F1)
        self.bnorm2 = BatchNorm2d(F1 * D)
        self.dropout1 = Dropout(dropout_rate)
        self.conv3 = Conv2d(F1 * D, F1 * D, (1, 3), padding="same", groups=F1 * D)
        self.conv4 = Conv2d(F1 * D, F2, (1, 1))
        self.bnorm3 = BatchNorm2d(F2)
        self.dropout2 = Dropout(dropout_rate)
        width = (input_length // self.tp1) // self.tp2
        self.linear = Dense(F2 * width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bnorm1(self.conv1(x[:, None]))
        out = elu(self.bnorm2(self.conv2(out)))
        out = self.dropout1(F.avg_pool2d(out, (1, self.tp1)))
        out = self.conv4(self.conv3(out))
        out = elu(self.bnorm3(out))
        out = self.dropout2(F.avg_pool2d(out, (1, self.tp2)))
        return self.linear(out.reshape(out.shape[0], -1)).reshape(-1)
