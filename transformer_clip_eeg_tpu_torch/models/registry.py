"""Encoder and head factories, and the whole model from a ``TrainConfig``.

Counterpart of ``transformer_clip_eeg_tpu/models/registry.py``, with the
same flag values, defaults and errors: every ``--eeg_encoder``,
``--speech_encoder`` and ``--model_arch`` the JAX registry builds, and the
same ``ValueError`` for a name it refuses (the JAX CLI also offers the
speech encoders 'conformer' and 'no', which its registry refuses).  The
port's layers need their input widths at construction, which flax infers:
the EEG encoders take 64 channels, the speech encoders ``speech_dimension``.
:func:`build_model_from_config` assembles the whole model from a
``TrainConfig`` with seeded weights, for the trainer and for serving.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.models.encoders import (
    EEGConformer,
    EEGConformerInterleaved,
    EEGConvLSTM,
    EEGConvLSTMNew,
    EEGLstm,
    EEGModel,
    MelModel,
    SpeechSmallConv,
    Wav2vecSmallModel,
)
from transformer_clip_eeg_tpu_torch.models.heads import (
    CLIPKLDNoLatentProj,
    CLIPKLDWithLatentProj,
    CLIPNoContrastiveLearning,
    CLIPSim,
    CLIPSimMultiplePositives,
    CLIPSimNoLatentProj,
)
from transformer_clip_eeg_tpu_torch.models.vlaai import VLAAI
from transformer_clip_eeg_tpu_torch.ops.layers import init_parameters


def load_eeg_encoder(
    eeg_encoder: str,
    units_lstm: int,
    spatial_filters: int,
    number_conv_layers: int,
    window_length: int,
    latent_dim: int,
    attention_depth: int,
) -> nn.Module:
    if eeg_encoder == "lstm":
        return EEGModel(
            spatial_filters_eeg=32,
            filters_cnn_eeg=16,
            kernel_size_temporal=9,
            stride_temporal=3,
            units_hidden=128,
            units_lstm=units_lstm,
            activation="leaky_relu",
        )
    if eeg_encoder == "double_lstm":
        return EEGLstm(speech_dim=64, units_lstm=units_lstm, spatial_filters=spatial_filters)
    if eeg_encoder == "vlaai":
        # the LayerNorms take the run's window, as the JAX registry wires them
        return VLAAI(time_dimension=window_length)
    if eeg_encoder == "convLSTM":
        return EEGConvLSTM(
            units_lstm=128,
            output_dim=latent_dim,
            dropout_rate=0.4,
            eeg_dim=64,
            filters=(64,) * number_conv_layers,
            kernels=(32,) * number_conv_layers,
            dilation_rate=1,
            time_dimension=window_length,
        )
    if eeg_encoder == "convLSTMnew":
        return EEGConvLSTMNew(
            output_dim=latent_dim,
            dropout_rate=0.4,
            eeg_dim=64,
            filters=(64,) * number_conv_layers,
            kernels=(64,) * number_conv_layers,
            dilation_rate=1,
            time_dimension=window_length,
        )
    if eeg_encoder in ("conformer", "EEGConformerInterleaved"):
        cls = EEGConformer if eeg_encoder == "conformer" else EEGConformerInterleaved
        return cls(
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
    raise ValueError(f"unknown eeg_encoder {eeg_encoder!r}")


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
    if speech_encoder == "lstm":
        return MelModel(
            spatial_filters=spatial_filters,
            filters_cnn=16,
            kernel_size_temporal=9,
            stride_temporal=stride_temporal,
            units_lstm=units_lstm,
            speech_dim=speech_dimension,
            activation="leaky_relu",
        )
    if speech_encoder == "double_lstm":
        return EEGLstm(speech_dim=speech_dimension, units_lstm=units_lstm,
                       spatial_filters=spatial_filters)
    if speech_encoder == "Wav2vecSmallModel":
        return Wav2vecSmallModel(speech_dim=speech_dimension, spatial_filters=units_lstm,
                                 stride_temporal=stride_temporal)
    if speech_encoder == "smallConv":
        return SpeechSmallConv(
            output_dim=latent_dim,
            kernel_size_temporal=16,
            dropout_rate=0.4,
            speech_dim=speech_dimension,
            time_dimension=window_length,
        )
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
    raise ValueError(f"unknown speech_encoder {speech_encoder!r}")


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
    """The head around the two encoders.  For 'clip_sim_no_latent_proj' and
    'clip_kld' the latent width is re-derived from the speech encoder's
    ``get_output_dim``, as in the reference; the KLD heads take ``bank_size``
    as their number of classes."""
    if model_arch in ("clip_sim_no_latent_proj", "clip_kld"):
        latent_dim = speech.get_output_dim(window_length)
    common = dict(eegModel=eeg, speechModel=speech, temperature=temperature,
                  window_length=window_length, lambda_clip=lambda_clip_loss)
    if model_arch == "clip_sim":
        return CLIPSim(bank_size=bank_size, latent_dim=latent_dim,
                       lambda_average=lambda_sim_loss, momentum_membank=momentum_membank,
                       **common)
    if model_arch == "clip_sim_no_latent_proj":
        return CLIPSimNoLatentProj(bank_size=bank_size, latent_dim=latent_dim,
                                   lambda_average=lambda_sim_loss,
                                   momentum_membank=momentum_membank, **common)
    if model_arch == "clip_mp":
        return CLIPSimMultiplePositives(lambda_average=lambda_sim_loss, **common)
    if model_arch in ("clip_kld", "clip_kld_latent_proj"):
        cls = CLIPKLDNoLatentProj if model_arch == "clip_kld" else CLIPKLDWithLatentProj
        # JAX also passes lambda_discriminative, which neither head reads
        return cls(latent_dimension=latent_dim, number_of_classes=bank_size,
                   lambda_lower_bound=lambda_sim_loss, **common)
    if model_arch == "no_contrastive_learning":
        return CLIPNoContrastiveLearning(eegModel=eeg, speechModel=speech,
                                         window_length=window_length)
    raise ValueError(f"unknown model_arch {model_arch!r}")


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
