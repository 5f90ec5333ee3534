"""Encoder and head factories for the flagship configuration.

Counterpart of ``transformer_clip_eeg_tpu/models/registry.py``, with the
same flag values and defaults.  Only the default run's branches are ported:
the ``EEGConformerInterleaved`` EEG encoder, the ``convLSTM`` speech encoder
and the ``clip_sim_no_latent_proj`` head.  Any other name raises
``NotImplementedError``; ROADMAP.md lists what is still to port.
:func:`build_model_from_config` assembles the whole model from a
``TrainConfig`` with seeded weights, for the trainer and for serving.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.models.encoders import (
    EEGConformerInterleaved,
    EEGConvLSTM,
)
from transformer_clip_eeg_tpu_torch.models.heads import CLIPSimNoLatentProj
from transformer_clip_eeg_tpu_torch.ops.layers import init_parameters


def _not_ported(kind: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kind} {name!r} is not ported to the torch package yet (see "
        "ROADMAP.md for the modules still to port)"
    )


def load_eeg_encoder(
    eeg_encoder: str,
    units_lstm: int,
    spatial_filters: int,
    number_conv_layers: int,
    window_length: int,
    latent_dim: int,
    attention_depth: int,
) -> nn.Module:
    if eeg_encoder == "EEGConformerInterleaved":
        return EEGConformerInterleaved(
            output_dim=latent_dim,
            conformer_input_dim=64,
            dropout_rate=0.2,
            eeg_dim=64,
            filters=(64,) * number_conv_layers,
            kernels=(64,) * number_conv_layers,
            dilation_rate=1,
            time_dimension=window_length,
            depth=attention_depth,
        )
    raise _not_ported("eeg_encoder", eeg_encoder)


def load_speech_encoder(
    speech_encoder: str,
    units_lstm: int,
    spatial_filters: int,
    number_conv_layers: int,
    window_length: int,
    stride_temporal: int,
    speech_dimension: int,
    latent_dim: int,
) -> nn.Module:
    if speech_encoder == "convLSTM":
        return EEGConvLSTM(
            units_lstm=128,
            output_dim=latent_dim,
            dropout_rate=0.4,
            eeg_dim=speech_dimension,
            filters=(64,) * number_conv_layers,
            kernels=(32,) * number_conv_layers,
            dilation_rate=1,
            time_dimension=window_length,
        )
    raise _not_ported("speech_encoder", speech_encoder)


def build_model(
    model_arch: str,
    eeg: nn.Module,
    speech: nn.Module,
    *,
    window_length: int,
    temperature: float,
    latent_dim: int,
    bank_size: int,
    lambda_clip_loss: float = 1.0,
    lambda_sim_loss: float = 0.0,
    momentum_membank: float = 0.90,
) -> nn.Module:
    """For 'clip_sim_no_latent_proj' the memory-bank row width is the speech
    encoder's output dim, as in the reference."""
    if model_arch == "clip_sim_no_latent_proj":
        return CLIPSimNoLatentProj(
            eegModel=eeg,
            speechModel=speech,
            bank_size=bank_size,
            latent_dim=speech.get_output_dim(window_length),
            temperature=temperature,
            window_length=window_length,
            lambda_clip=lambda_clip_loss,
            lambda_average=lambda_sim_loss,
            momentum_membank=momentum_membank,
        )
    raise _not_ported("model_arch", model_arch)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA on a host without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def build_model_from_config(cfg, bank_size: int, device="cuda", seed: int = 0):
    """Assemble the model as the trainer does, from a ``TrainConfig`` alone,
    with every parameter drawn from ``torch.Generator().manual_seed(seed)``
    (on the CPU, so a seed gives the same weights on any device), in eval
    mode on ``device``."""
    dev = resolve_device(device)
    eeg_enc = load_eeg_encoder(
        cfg.eeg_encoder, cfg.lstm_units, cfg.spatial_filters,
        cfg.number_conv_layers, cfg.window_length, cfg.latent_dim,
        cfg.attention_depth,
    )
    speech_enc = load_speech_encoder(
        cfg.speech_encoder, cfg.lstm_units, cfg.spatial_filters,
        cfg.number_conv_layers, cfg.window_length, cfg.stride_temporal,
        cfg.speech_dimension, cfg.latent_dim,
    )
    model = build_model(
        cfg.model_arch, eeg_enc, speech_enc,
        window_length=cfg.window_length,
        temperature=cfg.temperature,
        latent_dim=cfg.latent_dim,
        bank_size=bank_size,
        lambda_clip_loss=cfg.lambda_clip_loss,
        lambda_sim_loss=cfg.lambda_sim_loss,
        momentum_membank=cfg.momentum_membank,
    )
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
