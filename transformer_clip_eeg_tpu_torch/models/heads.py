"""The flagship's CLIP head: the loss, the EMA memory bank and the encoders.

Counterpart of ``transformer_clip_eeg_tpu/models/heads.py`` for
``CLIPSimNoLatentProj``: the two encoders, both temperatures and the
``[bank_size + 1, dim]`` memory bank (so a whole JAX variable tree carries
across), the symmetric InfoNCE, and the bank's EMA update.  The ``B x B``
similarity is one ``torch.matmul``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import l2_normalize


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch ``F.cross_entropy`` with integer class targets (mean)."""
    return F.cross_entropy(logits, targets)


def _symmetric_infonce(
    speech_features: torch.Tensor, eeg_features: torch.Tensor, log_temp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``logits = speech @ eeg.T * exp(T)``; cross-entropy against
    ``arange(B)`` both ways.  Returns (speech_loss, eeg_loss, logits)."""
    logits = torch.matmul(speech_features, eeg_features.T) * torch.exp(log_temp)
    targets = torch.arange(logits.shape[0], device=logits.device)
    return cross_entropy(logits, targets), cross_entropy(logits.T, targets), logits


def flatten_features(x: torch.Tensor) -> torch.Tensor:
    """``[B, ...]`` → ``[B, -1]`` in float32 (torch ``flatten(start_dim=1)``)."""
    return x.reshape(x.shape[0], -1).float()


def flatten_maybe_transposed(x: torch.Tensor) -> torch.Tensor:
    """The CLIPSimNoLatentProj quirk: transpose the trailing axes when
    ``shape[1] > shape[2]`` before flattening."""
    if x.dim() == 3 and x.shape[1] > x.shape[2]:
        x = x.transpose(1, 2)
    return flatten_features(x)


class MemoryBank(nn.Module):
    """EMA memory bank keyed by global segment id: ``memory [bank_size + 1,
    dim]``, U(0, 1) at init."""

    def __init__(self, bank_size: int, dim: int, momentum: float = 0.90):
        super().__init__()
        self.momentum = momentum
        self.register_buffer("memory", torch.empty(bank_size + 1, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.memory.uniform_(0.0, 1.0, generator=generator)

    def forward(self, idx: torch.Tensor, data: torch.Tensor,
                update: bool = True) -> torch.Tensor:
        """The rows ``idx`` as they were *before* this call, detached; with
        ``update`` the rows become ``m * rows + (1 - m) * data`` (no gradient,
        written in place)."""
        averages = self.memory[idx].detach()
        if update:
            with torch.no_grad():
                self.memory[idx] = (self.momentum * averages
                                    + (1.0 - self.momentum) * data.detach())
        return averages


class CLIPSimNoLatentProj(nn.Module):
    """The default architecture: no latent projection, the transpose-if-wider
    flatten, and a second InfoNCE between the memory bank's rows and the
    current EEG features with its own temperature."""

    def __init__(
        self,
        eegModel: nn.Module,
        speechModel: nn.Module,
        bank_size: int,
        latent_dim: int,
        temperature: float = 1.0,
        window_length: int = 192,
        lambda_clip: float = 1.0,
        lambda_average: float = 1.0,
        momentum_membank: float = 0.90,
    ):
        super().__init__()
        self.eegModel = eegModel
        self.speechModel = speechModel
        self.init_temperature = float(temperature)
        self.temperature = nn.Parameter(torch.tensor(float(temperature)))
        self.temperature_eeg = nn.Parameter(torch.tensor(float(temperature)))
        self.lambda_clip, self.lambda_average = lambda_clip, lambda_average
        self.eegMemoryBank = MemoryBank(bank_size, latent_dim, momentum_membank)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.temperature.fill_(self.init_temperature)
            self.temperature_eeg.fill_(self.init_temperature)

    def encode_eeg(self, eeg: torch.Tensor) -> torch.Tensor:
        return self.eegModel(eeg)

    def encode_speech(self, speech: torch.Tensor) -> torch.Tensor:
        return self.speechModel(speech)

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor,
                update_membank: bool = True):
        """``(loss_ce, avg_loss, loss_total)`` for a batch of windows and their
        global segment ids; the bank's rows ``ids`` are EMA-updated with the
        batch's EEG features when ``update_membank``."""
        eeg_f = l2_normalize(flatten_maybe_transposed(self.eegModel(eeg)), 1)
        sp_f = l2_normalize(flatten_maybe_transposed(self.speechModel(speech)), 1)
        averages = l2_normalize(self.eegMemoryBank(ids, eeg_f, update=update_membank), 1)
        s_loss, e_loss, _ = _symmetric_infonce(sp_f, eeg_f, self.temperature)
        loss_ce = (s_loss + e_loss) / 2.0
        avg_loss, _, _ = _symmetric_infonce(averages, eeg_f, self.temperature_eeg)
        loss_total = self.lambda_clip * loss_ce + self.lambda_average * avg_loss
        return loss_ce, avg_loss, loss_total
