"""Normalisation and overlap-add for the evaluation suite, in torch.

Counterpart of ``mvn_normalize``, ``hann_window`` and ``overlap_add_hann`` in
``transformer_clip_eeg_tpu/ops/windowing.py`` (the reference does these in
host numpy, ``train_clip_helper_functions.py:136,306-325``).  They run on
whatever device their input lies on.
"""

from __future__ import annotations

import math

import torch


def mvn_normalize(x: torch.Tensor, dims=(0, 1)) -> torch.Tensor:
    """Mean-variance normalisation over ``dims`` (the eval-time EEG contract,
    ref train_clip_helper_functions.py:136); the population std, as
    ``jnp.std``."""
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=0)
    return (x - mean) / std


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The periodic Hann window, ``torch.hann_window``'s default:
    0.5 * (1 - cos(2 pi k / n))."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * k / n))


def overlap_add_hann(segments: torch.Tensor, total_length: int,
                     window_length: int) -> torch.Tensor:
    """Hann-weighted 50%-overlap-add with boundary correction (ref
    train_clip_helper_functions.py:306-325): every segment is weighted by a
    Hann window, except that the first half of the first segment and the
    last half of the last get weight 1; segments are summed at hops of
    ``window_length // 2``; samples past ``total_length`` are dropped.

    ``segments [n_segments, window_length]`` → ``[total_length]``.
    """
    n_seg = segments.shape[0]
    hop = window_length // 2
    hann = hann_window(window_length, segments.dtype, segments.device).repeat(n_seg, 1)
    hann[0, :hop] = 1.0
    hann[-1, hop:] = 1.0
    weighted = (segments * hann).reshape(-1)
    idx = (torch.arange(n_seg, device=segments.device)[:, None] * hop
           + torch.arange(window_length, device=segments.device)[None, :]).reshape(-1)
    keep = idx < total_length
    out = torch.zeros(total_length, dtype=segments.dtype, device=segments.device)
    return out.index_add_(0, idx[keep], weighted[keep])
