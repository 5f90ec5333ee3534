"""The envelope-regression probe and the Pearson losses.

Counterpart of ``transformer_clip_eeg_tpu/models/regression.py`` (ref
``train_clip_helper_functions.py:1107-1140``): the probe is one same-padded
Conv1d (``input_dim -> output_dim``, k=32) and a LeakyReLU, trained with a
negative-Pearson loss (the cosine of mean-centred signals over time).  It
runs on ``[B, T, C]`` activations, as the JAX probe does; the conv is
``F.conv1d`` (cuDNN on the card), as JAX computes it outside any Pallas
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import Conv1d


def pearson_loss(x: torch.Tensor, y: torch.Tensor, dim: int = 1,
                 eps: float = 1e-6) -> torch.Tensor:
    """Negative Pearson r per channel, averaged over the batch: torch
    ``PearsonLoss`` (helper:1107-1117).  ``[B, T, C]`` → ``[C]``."""
    xc = x - x.mean(dim, keepdim=True)
    yc = y - y.mean(dim, keepdim=True)
    num = (xc * yc).sum(dim)
    den = (torch.linalg.vector_norm(xc, dim=dim).clamp(min=eps)
           * torch.linalg.vector_norm(yc, dim=dim).clamp(min=eps))
    return -(num / den).mean(0)


def pearson_loss_mean(x: torch.Tensor, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """torch ``PearsonLossMean`` (helper:1120-1129)."""
    return pearson_loss(x, y, dim=dim).mean()


class RegressionModel(nn.Module):
    """Conv1d(k=32, same) + LeakyReLU(0.01) (helper:1132-1140):
    ``[B, T, input_dim]`` → ``[B, T, output_dim]``; weights ``conv.weight
    [output_dim, input_dim, k]`` and ``conv.bias``."""

    def __init__(self, input_dim: int, output_dim: int = 1, receptive_field: int = 32):
        super().__init__()
        self.conv = Conv1d(input_dim, output_dim, receptive_field)

    @classmethod
    def from_state_dict(cls, state: dict, device=None) -> "RegressionModel":
        """The probe whose shape and weights ``state`` holds."""
        out_dim, in_dim, k = state["conv.weight"].shape
        model = cls(in_dim, out_dim, k)
        model.load_state_dict(state)
        return model.to(device) if device is not None else model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.conv(x), 0.01)
