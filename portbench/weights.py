"""Weights from the seed, made on the device in two large draws.

Every parameter and buffer of the model is assigned by its layer's kind, as
PyTorch's defaults do it: linear, convolution and LSTM weights and biases
U(-a, a) with ``a = 1 / sqrt(fan_in)`` (an LSTM's ``1 / sqrt(hidden)``),
normalisation scales 1 and shifts 0 (running statistics 0 and 1), the
memory bank U(0, 1), a KLD head's prior means N(0, 1), and the temperatures
the configuration states.  One ``torch.rand`` and one ``torch.randn`` on a
generator seeded from ``--seed`` supply every random value; a layer of a
kind not listed here stops the run.
"""

from __future__ import annotations

import math

import torch

FAN_IN = {
    "Dense": lambda m: m.in_features,
    "Conv1d": lambda m: m.fan_in,
    "Conv2dValidTime": lambda m: m.kernel_size,
    "LSTM": lambda m: m.hidden_size,
}
NORMS = ("LayerNorm", "LayerNormTC", "BatchNorm1d")
ONES = ("weight", "running_var")


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one purpose (weights, data, requests) of a run."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int, device) -> None:
    uniform, normal, fills = [], [], []
    for mod in model.modules():
        kind = type(mod).__name__
        own = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for name, t in own:
            if kind in FAN_IN:
                a = 1.0 / math.sqrt(FAN_IN[kind](mod))
                uniform.append((t, -a, a))
            elif kind in NORMS:
                fills.append((t, 1.0 if name in ONES else 0.0))
            elif kind == "MemoryBank":
                uniform.append((t, 0.0, 1.0))
            elif name in ("temperature", "temperature_eeg"):
                fills.append((t, float(mod.init_temperature)))
            elif name == "mu_eeg_lookup":
                normal.append(t)
            else:
                raise ValueError(f"no rule for the weights of {kind}.{name}")
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    u = torch.rand(sum(t.numel() for t, _, _ in uniform), generator=gen, device=device)
    z = torch.randn(sum(t.numel() for t in normal), generator=gen, device=device)
    at = 0
    for t, lo, hi in uniform:
        t.copy_((u[at:at + t.numel()] * (hi - lo) + lo).view_as(t))
        at += t.numel()
    at = 0
    for t in normal:
        t.copy_(z[at:at + t.numel()].view_as(t))
        at += t.numel()
    for t, v in fills:
        t.fill_(v)


def snapshot(model: torch.nn.Module, device="cpu") -> tuple:
    """Copies of the parameters and of the floating buffers, by name."""
    params = {k: v.detach().to(device, copy=True) for k, v in model.named_parameters()}
    buffers = {k: v.detach().to(device, copy=True) for k, v in model.named_buffers()
               if v.is_floating_point()}
    return params, buffers
