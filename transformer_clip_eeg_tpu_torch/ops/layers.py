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
* exact (erf) GELU; LeakyReLU with torch's slope 0.01;
* :class:`BatchNorm1d` normalises with the biased batch variance and keeps
  the unbiased one in ``running_var`` (torch's rule);
* under a data-parallel mesh (``mesh``, set by ``parallel.attach``) the
  layers see this rank's rows of the global batch: :class:`BatchNorm1d`
  takes the global batch's statistics and :class:`Dropout` the global
  batch's masks, as the JAX layers do under GSPMD;
* torch's default init ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weights and
  biases of linear and conv layers.

Every layer follows the dtype of its input, as the JAX layers do under
``--compute_dtype bfloat16`` (no ``torch.autocast``, whose per-operation
lists are another function).  A bfloat16 input takes JAX's rounding points:
Dense and the convolutions cast their weights to the input's dtype and round
the product before adding the bias in that dtype; the LayerNorms and
:class:`BatchNorm1d` take their statistics in float32 (running statistics
stay float32), round the normalised value and apply the affine in the input's
dtype; :class:`Dropout` divides in it.  A float32 input runs the float32
code unchanged (and float64 likewise).

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
from transformer_clip_eeg_tpu_torch.parallel.collectives import all_reduce_sum


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


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch ``nn.LeakyReLU`` default (slope 0.01)."""
    return F.leaky_relu(x, negative_slope)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "gelu": gelu_exact,
    "elu": elu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)``: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class Dense(nn.Module):
    """Linear layer on the last axis; weight ``[out, in]``, bias unless
    ``bias=False``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.in_features, generator)
        if self.bias is not None:
            torch_uniform_init(self.bias, self.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not low_precision(x):
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x, self.weight.to(x.dtype))  # rounded, then the bias added, as JAX
        return y if self.bias is None else y + self.bias.to(x.dtype)


def low_precision(x: torch.Tensor) -> bool:
    """Whether ``x`` is a bfloat16 activation, which the layers follow at
    JAX's rounding points; float32 and float64 run unchanged."""
    return x.dtype == torch.bfloat16


def upcast(x: torch.Tensor) -> torch.Tensor:
    """A low-precision ``x`` in float32 (the float32 kernels' inputs); any
    other ``x`` as it is."""
    return x.float() if low_precision(x) else x


def _conv1d_low(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                **kw) -> torch.Tensor:
    """``F.conv1d`` of a low-precision ``x [B, C, T]`` with ``w`` cast to its
    dtype: products of bf16 values summed in float32 and rounded once, as
    JAX's bf16 convolution, then the bias added in that dtype.  On the card
    the product is cuDNN's bf16 convolution; on the CPU it is the float32
    convolution of the same operands, rounded, because oneDNN's bf16
    convolution returns wrong values at some shapes (kernel widths that are
    multiples of 8 at narrow channel counts, off by tens, with PyTorch 2.13)."""
    wl = w.to(x.dtype)
    if x.device.type == "cpu":
        y = F.conv1d(x.float(), wl.float(), **kw).to(x.dtype)
    else:
        y = F.conv1d(x, wl, **kw)
    return y + bias.to(x.dtype)[:, None]


def _affine(y: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """A normalised float32 ``y`` rounded to ``x``'s dtype, then scaled and
    shifted in that dtype (the JAX norms' low-precision rule)."""
    return y.to(x.dtype) * weight.to(x.dtype) + bias.to(x.dtype)


def same_padding(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """torch padding='same': total = d*(k-1); before = total//2, after = rest."""
    total = dilation * (kernel_size - 1)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """1-D convolution over the time axis of ``[B, T, C]`` input, ``padding``
    'same' (torch's split of an even kernel's padding, then ``stride``, as
    the JAX layer pads) or 'valid'.

    Weight ``[C_out, C_in, K]`` as torch stores it; the input is permuted to
    ``[B, C, T]`` for ``F.conv1d`` and back.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, stride: int = 1, padding: str = "same"):
        super().__init__()
        if padding not in ("same", "valid"):
            raise ValueError(f"unsupported padding {padding!r}")
        self.fan_in = in_channels * kernel_size
        self.padding = same_padding(kernel_size, dilation) if padding == "same" else (0, 0)
        self.dilation, self.stride = dilation, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.fan_in, generator)
        torch_uniform_init(self.bias, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = F.pad(x.transpose(1, 2), self.padding)
        if not low_precision(x):
            y = F.conv1d(xc, self.weight, self.bias, stride=self.stride,
                         dilation=self.dilation)
        else:
            y = _conv1d_low(xc, self.weight, self.bias, stride=self.stride,
                            dilation=self.dilation)
        return y.transpose(1, 2)


class Conv2dValidTime(nn.Module):
    """The reference's ``Conv2d(1, F, (kT, 1), stride=(sT, 1), 'valid')``: a
    temporal conv applied to each spatial channel alone, ``F`` filters each.

    ``[B, T, S]`` → ``[B, T', F * S]`` with the feature axis flattened
    filter-major and spatial-minor, as the reference reshapes it;
    ``T' = (T - kT) // sT + 1``.  Weight ``[F, 1, kT]``.
    """

    def __init__(self, filters: int, kernel_size: int, stride: int):
        super().__init__()
        self.filters, self.kernel_size, self.stride = filters, kernel_size, stride
        self.weight = nn.Parameter(torch.empty(filters, 1, kernel_size))
        self.bias = nn.Parameter(torch.empty(filters))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_uniform_init(self.weight, self.kernel_size, generator)
        torch_uniform_init(self.bias, self.kernel_size, generator)

    @staticmethod
    def output_length(t: int, kernel_size: int, stride: int) -> int:
        return (t - kernel_size) // stride + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, s = x.shape
        # spatial channels folded into the batch, a valid strided conv1d over time
        xb = x.transpose(1, 2).reshape(b * s, 1, t)
        if not low_precision(x):
            y = F.conv1d(xb, self.weight, self.bias, stride=self.stride)
        else:
            y = _conv1d_low(xb, self.weight, self.bias, stride=self.stride)
        t_out = y.shape[-1]
        # [B*S, F, T'] -> [B, T', F, S] -> flatten (F, S)
        return y.reshape(b, s, self.filters, t_out).permute(0, 3, 2, 1).reshape(
            b, t_out, self.filters * s)


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
        if not low_precision(x):
            return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)
        y = F.layer_norm(x.float(), self.weight.shape, None, None, self.eps)
        return _affine(y, x, self.weight, self.bias)


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
        if not low_precision(x):
            return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)
        y = F.layer_norm(x.float(), self.weight.shape, None, None, self.eps)
        return _affine(y, x, self.weight, self.bias)


class BatchNorm1d(nn.Module):
    """torch ``nn.BatchNorm1d(C)`` over the channel axis of ``[B, T, C]``:
    each channel normalised over (batch, time).  In training mode with the
    biased batch variance, and ``running_var`` updated with the unbiased one
    (momentum 0.1: ``new = 0.9 * old + 0.1 * batch``); in eval mode with the
    running statistics.  These are buffers, so ``state_dict`` and the
    checkpoint carry them (the JAX layer's ``batch_stats``).

    Under a mesh of several ranks the training statistics are the global
    batch's, as JAX's under GSPMD: the mean, then the biased variance about
    it, each a sum all-reduced over the ranks with its gradient (two passes,
    as the JAX layer takes them), and the unbiased count is the global one.
    ``nn.SyncBatchNorm`` is not used: it refuses CPU tensors."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.mesh = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _global_normalise(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows [n, C]`` (float32) normalised by the global batch's
        statistics, which also move the running ones."""
        n = rows.shape[0] * self.mesh.n_data
        mean = all_reduce_sum(rows.sum(0)) / n
        centred = rows - mean
        var = all_reduce_sum((centred * centred).sum(0)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m * n / max(n - 1, 1))
        return centred * torch.rsqrt(var + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape(-1, x.shape[-1])
        if self.training and self.mesh is not None and self.mesh.n_data > 1:
            y = self._global_normalise(upcast(rows))
            if not low_precision(x):
                return (y * self.weight + self.bias).reshape(x.shape)
            return _affine(y, x, self.weight, self.bias).reshape(x.shape)
        if not low_precision(x):
            y = F.batch_norm(rows, self.running_mean, self.running_var, self.weight,
                             self.bias, self.training, self.momentum, self.eps)
            return y.reshape(x.shape)
        y = F.batch_norm(rows.float(), self.running_mean, self.running_var, None, None,
                         self.training, self.momentum, self.eps)
        return _affine(y, x, self.weight, self.bias).reshape(x.shape)


class Dropout(nn.Module):
    """Inverted dropout in training mode.  The mask is the port's one mask
    function (``ops/dropout.py``) keyed by ``dropout_seed``, over the
    row-major index of ``x``, so the CPU and the card drop the same
    elements; ``ops.dropout.set_dropout_seeds`` gives each layer its own
    seed per step.  Under a mesh the index is the global batch's (this
    rank's rows start ``rank * x.numel()`` elements in)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.dropout_seed = 0
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        offset = 0 if self.mesh is None else self.mesh.rank * x.numel()
        mask = dropout_mask(self.dropout_seed, x.shape, self.rate, x.device, offset)
        if not low_precision(x):
            return x * mask
        # JAX's where(keep, x / keep_prob, 0), the division in x's dtype
        keep = torch.tensor(1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(mask != 0, x / keep, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
