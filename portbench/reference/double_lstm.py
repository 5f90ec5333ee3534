"""Plain reference of the ``double_lstm`` configuration: ``EEGLstm`` on
both streams (``--eeg_encoder double_lstm --speech_encoder double_lstm``, ``--lstm_units``
at its default 128) under ``clip_kld_latent_proj``, from the names of its
parameters.

Each encoder: BatchNorm over the input channels, a 1x1 conv to 128, leaky
ReLU (slope 0.01), BatchNorm, then two unidirectional LSTMs of H=128.  Head:
both outputs flattened ``[B, T * H]``; linear projection heads (Dense to
16, leaky ReLU, Dense to 8) give the EEG posterior's mean and log variance
and the speech embedding; the InfoNCE of the L2-normalised speech embedding
against the normalised EEG mean, both ways (``loss_ce``); the lower bound
from the per-segment prior ``mu_eeg_lookup``: ``log_pmu2`` (its density
under N(0, 1)) and ``kld_z2`` (the KL of the posterior to N(prior row,
0.5^2)); ``loss_total = loss_ce + lambda * (kld_z2 - log_pmu2)``.  No
dropout, no sampling.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Params,
    batch_norm,
    conv_same,
    dense,
    infonce,
    l2_normalize,
    lstm,
)


def encoder(p: Params, state: Params, x: torch.Tensor, name: str, training: bool
            ) -> torch.Tensor:
    x = batch_norm(x, p, state, f"{name}.batchnorm_mel1", training)
    x = F.leaky_relu(conv_same(x, p, f"{name}.speech_conv1d"), 0.01)
    x = batch_norm(x, p, state, f"{name}.batchnorm_mel2", training)
    x = lstm(x, p, f"{name}.speech_lstm1", bidirectional=False)
    return lstm(x, p, f"{name}.speech_lstm2", bidirectional=False)


def projection(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return dense(F.leaky_relu(dense(x, p, f"{name}.projection"), 0.01), p,
                 f"{name}.last_linear")


def losses(p: Params, state: Params, batch: Dict[str, torch.Tensor], step_seed: int,
           lambda_clip: float = 1.0, lambda_lower_bound: float = 0.0
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    eeg = encoder(p, state, batch["eeg"], "eegModel", True)
    speech = encoder(p, state, batch["speech"], "speechModel", True)
    eeg_f, sp_f = eeg.reshape(eeg.shape[0], -1), speech.reshape(speech.shape[0], -1)
    z_mu = projection(eeg_f, p, "eeg_mu_linear")
    z_logvar = projection(eeg_f, p, "eeg_logvar_linear")
    sp_z = projection(sp_f, p, "speech_latent_projection")
    prior = p["mu_eeg_lookup"][batch["ids"]]
    log_pmu2 = torch.mean(-0.5 * (math.log(2 * math.pi) + prior ** 2), dim=1)
    q_logvar = math.log(0.5 ** 2)
    kld_z2 = torch.mean(-0.5 * (1 + z_logvar - q_logvar - ((z_mu - prior) ** 2
                                                        + torch.exp(z_logvar))
                                / math.exp(q_logvar)), dim=1)
    lower_bound = torch.mean(-log_pmu2 + kld_z2)
    s_loss, e_loss = infonce(l2_normalize(sp_z), l2_normalize(z_mu), p["temperature"])
    loss_ce = (s_loss + e_loss) / 2.0
    total = lambda_clip * loss_ce + lambda_lower_bound * lower_bound
    return {"loss_total": total, "loss_ce": loss_ce, "log_pmu2": log_pmu2.mean(),
            "kld_z2": kld_z2.mean()}, total


@torch.no_grad()
def embed_eeg(p: Params, state: Params, eeg: torch.Tensor) -> torch.Tensor:
    """Served EEG embeddings: the encoder in eval mode (running statistics),
    flattened, L2-normalised."""
    out = encoder(p, state, eeg, "eegModel", False)
    return l2_normalize(out.reshape(out.shape[0], -1))
