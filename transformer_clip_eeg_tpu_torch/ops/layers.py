"""Core layers, in torch, on ``[B, T, C]`` activations.

Counterpart of ``transformer_clip_eeg_tpu/ops/layers.py``.  Every layer takes
and returns the JAX package's ``[B, T, C]`` layout; weights are stored in
torch's own layouts (``Linear`` ``[out, in]``, ``Conv1d`` ``[out, in, K]``).

Numerics kept from the reference:

* torch ``padding='same'`` for even kernels pads ``total // 2`` before and
  the rest after;
* :class:`LayerNormTC` normalises jointly over time *and* channels, with an
  elementwise affine stored ``[T, C]`` (the JAX package's layout; the
  reference's ``nn.LayerNorm([C, T])`` holds the transpose);
* exact (erf) GELU;
* torch's default init ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weights and
  biases of linear and conv layers.

Each module with parameters has ``reset_parameters(generator)``, drawing from
an explicit ``torch.Generator`` (see :func:`init_parameters`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.dropout import dropout_mask


def torch_uniform_init(
    tensor: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]
) -> None:
    """In place: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's Linear/Conv init."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every submodule that defines ``reset_parameters(generator)``,
    in registration order, from one generator."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch ``nn.GELU()``."""
    return F.gelu(x)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)``: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class Dense(nn.Module):
    """Linear layer on the last axis; weight ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.in_features, generator)
        torch_uniform_init(self.bias, self.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def same_padding(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """torch padding='same': total = d*(k-1); before = total//2, after = rest."""
    total = dilation * (kernel_size - 1)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """1-D 'same' convolution over the time axis of ``[B, T, C]`` input.

    Weight ``[C_out, C_in, K]`` as torch stores it; the input is permuted to
    ``[B, C, T]`` for ``F.conv1d`` and back.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.fan_in = in_channels * kernel_size
        self.padding = same_padding(kernel_size, dilation)
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.fan_in, generator)
        torch_uniform_init(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = F.pad(x.transpose(1, 2), self.padding)
        y = F.conv1d(xc, self.weight, self.bias, dilation=self.dilation)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """Last-axis LayerNorm, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


class LayerNormTC(nn.Module):
    """Joint time+channel LayerNorm over ``[B, T, C]``, affine ``[T, C]``."""

    def __init__(self, time_dim: int, channel_dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(time_dim, channel_dim))
        self.bias = nn.Parameter(torch.zeros(time_dim, channel_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


class Dropout(nn.Module):
    """Inverted dropout in training mode.  The mask is the port's one mask
    function (``ops/dropout.py``) keyed by ``dropout_seed``, over the
    row-major index of ``x``, so the CPU and the card drop the same
    elements; ``ops.dropout.set_dropout_seeds`` gives each layer its own
    seed per step."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.dropout_seed = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return x * dropout_mask(self.dropout_seed, x.shape, self.rate, x.device)
