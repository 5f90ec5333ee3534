"""EEG data augmentation: the eight braindecode transforms and the mixups.

Counterpart of ``transformer_clip_eeg_tpu/ops/augment.py`` (the reference
delegates to braindecode with the hard-coded ``BEST_AUG_PARAMS``, ref
``dataset_loader.py:113-165``).

Axis quirk, kept on purpose: the reference feeds batches of shape ``[bs,
window, 64]`` to braindecode, whose transforms take axis 1 as "channels"
and axis 2 as "time".  So ChannelsDropout drops *time rows* and the FFTs run
over the 64 electrodes.  These functions take the same ``[B, C, T]`` view
of the raw batch.

Each transform applies per sample with probability ``p`` and is split in
two: ``draw_<name>(key, x, p, ...)`` makes its random tensors and
``apply_<name>(x, ...)`` is a plain function of the batch and those
tensors; ``<name>(key, x, p)`` is the one after the other.  Every draw comes
from the port's counter hash (:func:`~transformer_clip_eeg_tpu_torch.ops.
dropout.hash_bits`) of the element's linear index under a 31-bit key, on
the batch's device: uniforms from the top 24 of the 32 bits (exact in
float32), normals by Box-Muller, Bernoullis as ``uniform < p``.  The CPU and
the card therefore draw the same numbers, and nothing here reads a value
back to the host, so the draws can sit inside a captured CUDA graph.
``jax.random``'s streams cannot be matched; the tests hold each application
against JAX's function fed with JAX's own draws.

Every draw's leading axis is the batch.  ``row0`` says which row of the
global batch a data-parallel rank's first row is: its draws are then rows
``[row0, row0 + B)`` of the global batch's (the linear index shifted by
``row0`` rows), so N ranks augment and mix as one process does.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Sequence

import torch

from transformer_clip_eeg_tpu_torch.ops.dropout import fold_seed, hash_bits, linear_index

# ref dataset_loader.py:115-144
BEST_AUG_PARAMS = {
    "GaussianNoise": {"std": 0.16},
    "FrequencyShift": {"max_delta_freq": 0.6, "sfreq": 100},
    "FTSurrogate": {"phase_noise_magnitude": 1.0},
    "SmoothTimeMask": {"mask_len_samples": 20},
    "ChannelsDropout": {"p_drop": 0.2},
    "ChannelsShuffle": {"p_shuffle": 0.6},
    "BandstopFilter": {"bandwidth": 0.6, "sfreq": 100},
}

# the train step's streams of its step seed; a model's dropout layers take
# the streams 0, 1, ... (ops.dropout.set_dropout_seeds), never these
AUGMENT_STREAM = 0x80000000
MIXUP_STREAM = 0x80000001


# -- draws ---------------------------------------------------------------------

def _index(shape, device, row0: int) -> torch.Tensor:
    """The linear index of ``shape`` as rows ``row0...`` of a larger batch."""
    return linear_index(shape, device) + row0 * math.prod(shape[1:])


def uniform(key: int, shape, device, lo: float = 0.0, hi: float = 1.0,
            row0: int = 0) -> torch.Tensor:
    """float32 uniforms in ``[lo, hi)``: the top 24 hash bits of each
    element's linear index, scaled."""
    bits = hash_bits(key, _index(shape, device, row0))
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return u * (hi - lo) + lo


def normal(key: int, shape, device, row0: int = 0) -> torch.Tensor:
    """Standard normals by Box-Muller from two uniform streams of ``key``."""
    u1 = 1.0 - uniform(fold_seed(key, 0), shape, device, row0=row0)  # in (0, 1]
    u2 = uniform(fold_seed(key, 1), shape, device, row0=row0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def bernoulli(key: int, p: float, shape, device, row0: int = 0) -> torch.Tensor:
    return uniform(key, shape, device, row0=row0) < p


def randint(key: int, n: int, shape, device) -> torch.Tensor:
    """int64 in ``[0, n)``: ``floor(bits * n / 2**32)``."""
    return (hash_bits(key, linear_index(shape, device)) * int(n)) >> 32


def _mask(key: int, x: torch.Tensor, p: float, row0: int) -> torch.Tensor:
    """[B] booleans: which samples get the transform (stream 0 of ``key``)."""
    return bernoulli(fold_seed(key, 0), p, (x.shape[0],), x.device, row0)


def _apply_masked(mask: torch.Tensor, augmented: torch.Tensor,
                  original: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None, None], augmented, original)


# -- the transforms --------------------------------------------------------------

def draw_sign_flip(key: int, x: torch.Tensor, p: float, row0: int = 0
                   ) -> Dict[str, torch.Tensor]:
    return {"mask": _mask(key, x, p, row0)}


def apply_sign_flip(x, mask):
    return _apply_masked(mask, -x, x)


def draw_gaussian_noise(key: int, x: torch.Tensor, p: float, std: float = 0.16,
                        row0: int = 0):
    return {"mask": _mask(key, x, p, row0),
            "noise": std * normal(fold_seed(key, 1), x.shape, x.device, row0).to(x.dtype)}


def apply_gaussian_noise(x, mask, noise):
    return _apply_masked(mask, x + noise, x)


def _n_half(t: int) -> int:
    return t // 2 - 1 if t % 2 == 0 else (t - 1) // 2


def draw_ft_surrogate(key: int, x: torch.Tensor, p: float,
                      phase_noise_magnitude: float = 1.0, row0: int = 0):
    b, t = x.shape[0], x.shape[2]
    phases = uniform(fold_seed(key, 1), (b, 1, _n_half(t)), x.device, row0=row0) * (
        phase_noise_magnitude * 2 * math.pi)
    return {"mask": _mask(key, x, p, row0), "phases": phases}


def apply_ft_surrogate(x, mask, phases):
    """Rotate the Fourier phases along the time axis by ``phases`` ``[B, 1,
    n_half]`` (one draw shared across channels, braindecode's
    ``channel_indep=False``), Hermitian so the result stays real."""
    b, t = x.shape[0], x.shape[2]
    f = torch.fft.fft(x.to(torch.float32), dim=2)
    rot = torch.polar(torch.ones_like(phases), phases)
    one = torch.ones((b, 1, 1), dtype=rot.dtype, device=x.device)
    back = torch.conj(torch.flip(rot, dims=[2]))
    parts = [one, rot, one, back] if t % 2 == 0 else [one, rot, back]
    aug = torch.fft.ifft(f * torch.cat(parts, dim=2), dim=2).real.to(x.dtype)
    return _apply_masked(mask, aug, x)


def draw_frequency_shift(key: int, x: torch.Tensor, p: float, max_delta_freq: float = 0.6,
                         sfreq: float = 100.0, row0: int = 0):
    delta = uniform(fold_seed(key, 1), (x.shape[0], 1, 1), x.device, -max_delta_freq,
                    max_delta_freq, row0)
    return {"mask": _mask(key, x, p, row0), "delta": delta}


def apply_frequency_shift(x, mask, delta, sfreq: float = 100.0):
    """Shift the spectrum by ``delta`` Hz ``[B, 1, 1]`` through the analytic
    signal (negative frequencies zeroed, positive ones doubled)."""
    t = x.shape[2]
    xf = torch.fft.fft(x.to(torch.float32), dim=2)
    k = torch.arange(t, device=x.device)
    h = 2.0 * ((k > 0) & (k < (t + 1) // 2)).float() + (k == 0).float()
    if t % 2 == 0:
        h = h + (k == t // 2).float()
    analytic = torch.fft.ifft(xf * h, dim=2)
    times = torch.arange(t, dtype=torch.float32, device=x.device) / sfreq
    angle = (2 * math.pi) * delta * times
    shifted = analytic * torch.polar(torch.ones_like(angle), angle)
    return _apply_masked(mask, shifted.real.to(x.dtype), x)


def draw_bandstop_filter(key: int, x: torch.Tensor, p: float, bandwidth: float = 0.6,
                         sfreq: float = 100.0, row0: int = 0):
    hi = max(sfreq / 2.0 - bandwidth - 1.0, 1.0 + 1e-3)
    f0 = uniform(fold_seed(key, 1), (x.shape[0], 1, 1), x.device, 1.0, hi, row0)
    return {"mask": _mask(key, x, p, row0), "f0": f0}


def apply_bandstop_filter(x, mask, f0, bandwidth: float = 0.6, sfreq: float = 100.0):
    """Zero the band ``[f0, f0 + bandwidth]`` Hz ``[B, 1, 1]`` of the
    spectrum (a brick-wall mask where braindecode uses an IIR notch)."""
    t = x.shape[2]
    freqs = torch.fft.fftfreq(t, d=1.0 / sfreq, device=x.device).abs()
    stop = (freqs >= f0) & (freqs <= f0 + bandwidth)
    xf = torch.fft.fft(x.to(torch.float32), dim=2)
    aug = torch.fft.ifft(torch.where(stop, torch.zeros_like(xf), xf), dim=2).real
    return _apply_masked(mask, aug.to(x.dtype), x)


def draw_smooth_time_mask(key: int, x: torch.Tensor, p: float, mask_len_samples: int = 20,
                          row0: int = 0):
    t = x.shape[2]
    start = uniform(fold_seed(key, 1), (x.shape[0], 1, 1), x.device, 0.0,
                    float(max(t - mask_len_samples, 1)), row0)
    return {"mask": _mask(key, x, p, row0), "start": start}


def apply_smooth_time_mask(x, mask, start, mask_len_samples: int = 20):
    """Zero ``mask_len_samples`` steps from ``start`` ``[B, 1, 1]``, the edges
    two sigmoids of temperature 2."""
    tgrid = torch.arange(x.shape[2], dtype=torch.float32, device=x.device)[None, None, :]
    window = torch.sigmoid(2.0 * (tgrid - start)) * torch.sigmoid(
        -2.0 * (tgrid - start - mask_len_samples))
    return _apply_masked(mask, x * (1.0 - window).to(x.dtype), x)


def draw_channels_dropout(key: int, x: torch.Tensor, p: float, p_drop: float = 0.2,
                          row0: int = 0):
    keep = bernoulli(fold_seed(key, 1), 1.0 - p_drop, (x.shape[0], x.shape[1], 1), x.device,
                     row0)
    return {"mask": _mask(key, x, p, row0), "keep": keep}


def apply_channels_dropout(x, mask, keep):
    return _apply_masked(mask, x * keep.to(x.dtype), x)


def draw_channels_shuffle(key: int, x: torch.Tensor, p: float, p_shuffle: float = 0.6,
                          row0: int = 0):
    b, c = x.shape[0], x.shape[1]
    return {"mask": _mask(key, x, p, row0),
            "in_subset": bernoulli(fold_seed(key, 1), p_shuffle, (b, c), x.device, row0),
            "noise": uniform(fold_seed(key, 2), (b, c), x.device, row0=row0)}


def shuffle_permutation(in_subset: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` row permutations that reorder each sample's selected rows
    by ascending ``noise`` and leave the others in place, by two stable
    sorts (no host sync).  The j-th selected slot takes the j-th row of the
    random order; the unselected rows sort after the selected ones, in
    ascending order, in both sorts, so they map to themselves."""
    order = torch.sort(torch.where(in_subset, noise, torch.full_like(noise, math.inf)),
                       dim=1, stable=True).indices
    slots = torch.sort((~in_subset).to(torch.uint8), dim=1, stable=True).indices
    return torch.empty_like(order).scatter_(1, slots, order)


def apply_channels_shuffle(x, mask, in_subset, noise):
    perm = shuffle_permutation(in_subset, noise)
    aug = torch.gather(x, 1, perm[:, :, None].expand(x.shape))
    return _apply_masked(mask, aug, x)


def _compose(draw, apply, shared: Sequence[str] = ()):
    """``fn(key, x, p, **params)``: ``apply(x, **draw(key, x, p, **params))``;
    ``shared`` names the parameters the application takes too."""
    def fn(key: int, x: torch.Tensor, p: float, row0: int = 0, **params) -> torch.Tensor:
        kw = {k: params[k] for k in shared if k in params}
        return apply(x, **draw(key, x, p, row0=row0, **params), **kw)
    return fn


sign_flip = _compose(draw_sign_flip, apply_sign_flip)
gaussian_noise = _compose(draw_gaussian_noise, apply_gaussian_noise)
ft_surrogate = _compose(draw_ft_surrogate, apply_ft_surrogate)
frequency_shift = _compose(draw_frequency_shift, apply_frequency_shift, ("sfreq",))
bandstop_filter = _compose(draw_bandstop_filter, apply_bandstop_filter,
                           ("bandwidth", "sfreq"))
smooth_time_mask = _compose(draw_smooth_time_mask, apply_smooth_time_mask,
                            ("mask_len_samples",))
channels_dropout = _compose(draw_channels_dropout, apply_channels_dropout)
channels_shuffle = _compose(draw_channels_shuffle, apply_channels_shuffle)

TRANSFORMS: Dict[str, Callable] = {
    "SignFlip": sign_flip,
    "GaussianNoise": gaussian_noise,
    "FTSurrogate": ft_surrogate,
    "FrequencyShift": frequency_shift,
    "BandstopFilter": bandstop_filter,
    "SmoothTimeMask": smooth_time_mask,
    "ChannelsDropout": channels_dropout,
    "ChannelsShuffle": channels_shuffle,
}

DRAWS: Dict[str, Callable] = {
    "SignFlip": draw_sign_flip,
    "GaussianNoise": draw_gaussian_noise,
    "FTSurrogate": draw_ft_surrogate,
    "FrequencyShift": draw_frequency_shift,
    "BandstopFilter": draw_bandstop_filter,
    "SmoothTimeMask": draw_smooth_time_mask,
    "ChannelsDropout": draw_channels_dropout,
    "ChannelsShuffle": draw_channels_shuffle,
}


def make_augmentation_fn(names: Sequence[str], probability: float
                         ) -> Callable[..., torch.Tensor]:
    """The named transforms with ``BEST_AUG_PARAMS``, composed into ``fn(key,
    batch, row0=0) -> batch`` (ref dataset_loader.py:147-165); the i-th
    transform draws from ``fold_seed(key, i)``."""
    steps = []
    for name in names:
        if name not in TRANSFORMS:
            raise ValueError(f"unknown augmentation {name!r}")
        steps.append(partial(TRANSFORMS[name], p=probability, **BEST_AUG_PARAMS.get(name, {})))

    def apply(key: int, batch: torch.Tensor, row0: int = 0) -> torch.Tensor:
        for i, step in enumerate(steps):
            batch = step(fold_seed(key, i), batch, row0=row0)
        return batch

    return apply


# -- mixup ---------------------------------------------------------------------

def draw_batch_mixup(key: int, b: int, probability: float, device,
                     row0: int = 0) -> Dict[str, torch.Tensor]:
    """Per batch row: whether it mixes (``uniform < probability``) and its
    weight ``alpha`` on the partner, ~ U(0, 1)."""
    return {"do_aug": bernoulli(fold_seed(key, 0), probability, (b,), device, row0),
            "alphas": uniform(fold_seed(key, 1), (b,), device, row0=row0)}


def apply_batch_mixup(eeg, partner_eeg, do_aug, alphas):
    """``m * eeg + (1 - m) * partner_eeg`` with ``m = 1 - alpha * do_aug``
    per row (the train step's mixup, JAX ``train/steps.py _apply_mixup``)."""
    m = (1.0 - alphas * do_aug)[:, None, None]
    return (m * eeg + (1.0 - m) * partner_eeg).to(eeg.dtype)


def draw_mixup_eeg(key: int, eeg: torch.Tensor, probability: float) -> Dict[str, torch.Tensor]:
    n_subs, n_win = eeg.shape[0], eeg.shape[1]
    shape = (n_subs, n_win)
    return {"do_aug": bernoulli(fold_seed(key, 0), probability, shape, eeg.device),
            "alphas": uniform(fold_seed(key, 1), shape, eeg.device),
            "partner": randint(fold_seed(key, 2), n_subs, shape, eeg.device)}


def apply_mixup_eeg(eeg, do_aug, alphas, partner):
    """Per (subject, window) of a chunk ``[n_subs, n_win, wl, 64]``: the
    convex combination with the same window of subject ``partner``."""
    n_win = eeg.shape[1]
    partner_eeg = eeg[partner, torch.arange(n_win, device=eeg.device)[None, :]]
    m = (1.0 - alphas * do_aug)[..., None, None]
    return (m * eeg + (1.0 - m) * partner_eeg).to(eeg.dtype)


def mixup_eeg(key: int, eeg: torch.Tensor, probability: float) -> torch.Tensor:
    """Cross-subject mixup of a whole chunk ('addEEG', ref
    dataset_loader.py:333-356), vectorised."""
    return apply_mixup_eeg(eeg, **draw_mixup_eeg(key, eeg, probability))
