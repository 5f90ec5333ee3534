"""Plain reference of the ``flagship`` configuration: the reference's default
run (``EEGConformerInterleaved`` depth 10 on the EEG, ``convLSTM`` on the
wav2vec-19 features, ``clip_sim_no_latent_proj``), from the names of its
parameters.

EEG: a 1x1 spatial map, then per level a conv block (Conv1d 'same', K=64,
dropout 0.2, LayerNorm over time and channels jointly, GELU) on ``x + skip``
and a transformer block on ``x + skip`` (the last on ``x``), then a Dense to
8.  Speech: a 1x1 map from 1,024 to 64, one conv block (K=32, dropout 0.4)
and two biLSTMs (H=128, then H=4).  Head: both outputs transposed to
``[B, 8, T]`` and flattened, L2-normalised; the InfoNCE of speech against
EEG both ways (``loss_ce``), the memory bank's rows (as they were) against
the EEG (``loss_avg``, one way), ``loss_total = loss_ce + lambda * loss_avg``,
and the bank's rows moved to ``0.9 rows + 0.1 eeg``.

Dropout streams: the layers that draw masks, in the model's module order,
are numbered 0, 1, ...: EEG conv block i is 2i, its transformer block
2i + 1, the speech conv block 2 * depth.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Params,
    conv_same,
    dense,
    dropout_mask,
    fold,
    infonce,
    l2_normalize,
    layer_norm,
    lstm,
    transformer_block,
)

HEADS = 8
EEG_DROP, SPEECH_DROP = 0.2, 0.4


def depth(p: Params) -> int:
    return sum(1 for k in p if k.startswith("eegModel.conformer_") and k.endswith("ln1.weight"))


def conv_block(x: torch.Tensor, p: Params, name: str, rate: float, seed, training: bool
               ) -> torch.Tensor:
    y = conv_same(x, p, f"{name}.conv")
    if training:
        y = y * dropout_mask(seed, y.shape, rate, y.device)
    return F.gelu(layer_norm(y, p, f"{name}.normalization"))


def eeg_encoder(p: Params, eeg: torch.Tensor, step_seed: int, training: bool) -> torch.Tensor:
    n = depth(p)
    x = conv_same(eeg, p, "eegModel.eeg_spatial_mapping")
    skip = x
    for i in range(n):
        x = conv_block(x + skip, p, f"eegModel.conv_{i}", EEG_DROP, fold(step_seed, 2 * i),
                       training)
        x = transformer_block(x if i == n - 1 else x + skip, p, f"eegModel.conformer_{i}.block_0",
                              HEADS, fold(step_seed, 2 * i + 1), training)
    return dense(x, p, "eegModel.final_layer")


def speech_encoder(p: Params, speech: torch.Tensor, step_seed: int, training: bool
                   ) -> torch.Tensor:
    x = conv_same(speech, p, "speechModel.eeg_spatial_mapping")
    x = conv_block(x, p, "speechModel.conv_0", SPEECH_DROP, fold(step_seed, 2 * depth(p)),
                   training)
    x = lstm(x, p, "speechModel.speech_lstm1", bidirectional=True)
    return lstm(x, p, "speechModel.speech_lstm2", bidirectional=True)


def transposed_flat(x: torch.Tensor) -> torch.Tensor:
    """The head's flatten: ``[B, T, C]`` with T > C is transposed first."""
    if x.shape[1] > x.shape[2]:
        x = x.transpose(1, 2)
    return x.reshape(x.shape[0], -1)


def losses(p: Params, state: Params, batch: Dict[str, torch.Tensor], step_seed: int,
           lambda_clip: float = 1.0, lambda_avg: float = 0.0
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One training forward: the losses and the objective; the memory bank
    in ``state`` moves (no gradient)."""
    eeg_f = l2_normalize(transposed_flat(eeg_encoder(p, batch["eeg"], step_seed, True)))
    sp_f = l2_normalize(transposed_flat(speech_encoder(p, batch["speech"], step_seed, True)))
    bank = state["eegMemoryBank.memory"]
    ids = batch["ids"]
    rows = bank[ids].clone()
    with torch.no_grad():
        bank[ids] = 0.9 * rows + 0.1 * eeg_f.detach()
    s_loss, e_loss = infonce(sp_f, eeg_f, p["temperature"])
    loss_ce = (s_loss + e_loss) / 2.0
    loss_avg, _ = infonce(l2_normalize(rows), eeg_f, p["temperature_eeg"])
    total = lambda_clip * loss_ce + lambda_avg * loss_avg
    return {"loss_ce": loss_ce, "loss_avg": loss_avg, "loss_total": total}, total


@torch.no_grad()
def embed_eeg(p: Params, state: Params, eeg: torch.Tensor) -> torch.Tensor:
    """Served EEG embeddings: the encoder in eval mode, flattened as
    ``[B, T * C]`` (no transpose), L2-normalised."""
    out = eeg_encoder(p, eeg, 0, False)
    return l2_normalize(out.reshape(out.shape[0], -1))
