"""Torch port, the EEG augmentations and the mixups (``ops/augment.py``,
``train/steps._apply_mixup``, the dataset's host iterator and the chunk
store's mixup partners) against the JAX package on the CPU.

``jax.random``'s streams cannot be matched, so each application is fed
JAX's own draws (the JAX function's key splits repeated here) and held to
JAX's output within 1e-5; the port's own draws are held to their
distributions.  The host iterator and the store's partners draw from numpy
and equal JAX's bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.data.dataset import EEGWindowDataset as JDataset
from transformer_clip_eeg_tpu.ops import augment as jaug
from transformer_clip_eeg_tpu.train.device_data import DeviceChunkStore as JStore
from transformer_clip_eeg_tpu.train.steps import _apply_mixup as j_apply_mixup
from transformer_clip_eeg_tpu_torch.data.dataset import EEGDatasetSimdata, EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.ops import augment as aug
from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore
from transformer_clip_eeg_tpu_torch.train.steps import _apply_mixup

TOL = 1e-5  # of max |x|: f32 FFTs and elementwise math in another order
B, C = 6, 12
P = 0.5
split = jax.random.split


def _x(t, seed=0, b=B, c=C):
    return np.random.default_rng(seed).standard_normal((b, c, t)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(name, key, x, p):
    """The JAX function's draws for ``x`` under ``key``, by its own splits,
    as the port's application arguments."""
    b, c, t = x.shape
    prm = aug.BEST_AUG_PARAMS.get(name, {})
    if name == "ChannelsShuffle":
        k1, k2, k3 = split(key, 3)
        noise = jnp.stack([jax.random.uniform(k, (c,)) for k in split(k3, b)])
        return {"mask": jax.random.bernoulli(k1, p, (b,)),
                "in_subset": jax.random.bernoulli(k2, prm["p_shuffle"], (b, c)),
                "noise": noise}
    k1, k2 = split(key)
    out = {"mask": jax.random.bernoulli(k1, p, (b,))}
    if name == "GaussianNoise":
        out["noise"] = prm["std"] * jax.random.normal(k2, x.shape, x.dtype)
    elif name == "FTSurrogate":
        n_half = t // 2 - 1 if t % 2 == 0 else (t - 1) // 2
        out["phases"] = (jax.random.uniform(k2, (b, 1, n_half))
                         * prm["phase_noise_magnitude"] * 2 * jnp.pi)
    elif name == "FrequencyShift":
        m = prm["max_delta_freq"]
        out["delta"] = jax.random.uniform(k2, (b, 1, 1), minval=-m, maxval=m)
    elif name == "BandstopFilter":
        hi = max(prm["sfreq"] / 2.0 - prm["bandwidth"] - 1.0, 1.0 + 1e-3)
        out["f0"] = jax.random.uniform(k2, (b, 1, 1), minval=1.0, maxval=hi)
    elif name == "SmoothTimeMask":
        out["start"] = jax.random.uniform(
            k2, (b, 1, 1), minval=0.0, maxval=max(t - prm["mask_len_samples"], 1))
    elif name == "ChannelsDropout":
        out["keep"] = jax.random.bernoulli(k2, 1.0 - prm["p_drop"], (b, c, 1))
    return out


APPLY = {
    "SignFlip": (jaug.sign_flip, aug.apply_sign_flip, ()),
    "GaussianNoise": (jaug.gaussian_noise, aug.apply_gaussian_noise, ()),
    "FTSurrogate": (jaug.ft_surrogate, aug.apply_ft_surrogate, ()),
    "FrequencyShift": (jaug.frequency_shift, aug.apply_frequency_shift, ("sfreq",)),
    "BandstopFilter": (jaug.bandstop_filter, aug.apply_bandstop_filter, ("bandwidth", "sfreq")),
    "SmoothTimeMask": (jaug.smooth_time_mask, aug.apply_smooth_time_mask,
                       ("mask_len_samples",)),
    "ChannelsDropout": (jaug.channels_dropout, aug.apply_channels_dropout, ()),
    "ChannelsShuffle": (jaug.channels_shuffle, aug.apply_channels_shuffle, ()),
}
DRAW = aug.DRAWS
NAMES = list(APPLY)


@pytest.mark.parametrize("t", [64, 63], ids=["even", "odd"])
@pytest.mark.parametrize("name", NAMES)
def test_application_matches_jax_on_its_draws(name, t):
    """Every sample of the port's application equals JAX's transform under
    the same key; the odd length takes the FFT transforms' other branch."""
    jfn, apply, shared = APPLY[name]
    prm = aug.BEST_AUG_PARAMS.get(name, {})
    x = _x(t, seed=t)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jfn(key, jnp.asarray(x), P, **prm))
    draws = {k: _t(v) for k, v in _jax_draws(name, key, jnp.asarray(x), P).items()}
    got = apply(_t(x), **draws, **{k: prm[k] for k in shared})
    assert got.shape == x.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL * float(np.abs(x).max()), err
    mask = draws["mask"].numpy()
    assert 0 < mask.sum() < B  # both branches of the per-sample choice ran
    np.testing.assert_array_equal(got.numpy()[~mask], x[~mask])


def test_fold_seed_is_the_hash_on_the_host():
    """The host's ``fold_seed`` (Python integers) is the device hash's draw."""
    from transformer_clip_eeg_tpu_torch.ops.dropout import hash_bits

    rng = np.random.default_rng(1)
    seeds, ns = rng.integers(0, 2**32, 500), rng.integers(0, 2**32, 500)
    want = (hash_bits(torch.from_numpy(seeds.astype(np.int64)),
                      torch.from_numpy(ns.astype(np.int64))) & 0x7FFFFFFF).tolist()
    assert [aug.fold_seed(int(s), int(n)) for s, n in zip(seeds, ns)] == want
    assert aug.fold_seed(7, aug.AUGMENT_STREAM) != aug.fold_seed(7, aug.MIXUP_STREAM)


def test_make_augmentation_fn_composes_in_order():
    x = _t(_x(64))
    fn = aug.make_augmentation_fn(["SignFlip", "ChannelsDropout"], 1.0)
    want = aug.channels_dropout(aug.fold_seed(5, 1),
                                aug.sign_flip(aug.fold_seed(5, 0), x, 1.0), 1.0, p_drop=0.2)
    assert torch.equal(fn(5, x), want)
    assert torch.equal(fn(5, x), fn(5, x)) and not torch.equal(fn(5, x), fn(6, x))
    with pytest.raises(ValueError, match="unknown augmentation"):
        aug.make_augmentation_fn(["Mixup"], 0.5)


@pytest.mark.parametrize("name", NAMES)
def test_invariants(name):
    """p=0 is the identity; p=1 marks every sample and gives the
    application on every sample; shapes and dtype are kept; the same seed
    draws the same tensors and another seed others."""
    fn = aug.TRANSFORMS[name]
    prm = aug.BEST_AUG_PARAMS.get(name, {})
    x = _t(_x(64, b=32))
    assert torch.equal(fn(3, x, 0.0, **prm), x)
    d1 = DRAW[name](3, x, 1.0, **prm)
    assert bool(d1["mask"].all())
    shared = {k: prm[k] for k in APPLY[name][2]}
    y = fn(3, x, 1.0, **prm)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert torch.equal(y, APPLY[name][1](x, **d1, **shared))
    if name in ("SignFlip", "GaussianNoise", "FTSurrogate", "FrequencyShift",
                "SmoothTimeMask"):
        assert bool((y != x).flatten(1).any(1).all())  # every sample changed
    d2, d3 = DRAW[name](3, x, 0.5, **prm), DRAW[name](4, x, 0.5, **prm)
    for k in d2:
        assert torch.equal(d2[k], DRAW[name](3, x, 0.5, **prm)[k])
        assert not torch.equal(d2[k], d3[k]), k


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_augmented_share_and_draw_ranges(p):
    """Over 20,000 samples the augmented share is within 5 sigma of p; the
    noise has std 0.16; delta f, f0 and the mask's start stay in range."""
    n = 20_000
    x = torch.zeros(n, 4, 64)
    share = float(aug.draw_sign_flip(11, x, p)["mask"].float().mean())
    assert abs(share - p) <= 5 * math.sqrt(p * (1 - p) / n)
    noise = aug.draw_gaussian_noise(11, torch.zeros(64, 192, 64), p)["noise"]
    assert abs(float(noise.std()) - 0.16) < 0.16 * 0.01 and abs(float(noise.mean())) < 1e-3
    delta = aug.draw_frequency_shift(11, x, p)["delta"]
    assert -0.6 <= float(delta.min()) and float(delta.max()) < 0.6 and delta.shape == (n, 1, 1)
    f0 = aug.draw_bandstop_filter(11, x, p)["f0"]
    assert 1.0 <= float(f0.min()) and float(f0.max()) < 50 - 0.6 - 1
    start = aug.draw_smooth_time_mask(11, x, p)["start"]
    assert 0.0 <= float(start.min()) and float(start.max()) < 64 - 20
    keep = aug.draw_channels_dropout(11, x, p)["keep"]
    assert abs(float(keep.float().mean()) - 0.8) < 0.01
    u = aug.uniform(11, (n,), "cpu")
    assert float(u.min()) >= 0 and float(u.max()) < 1 and abs(float(u.mean()) - 0.5) < 0.01


def test_channels_shuffle_only_permutes_the_selected_rows():
    x = _t(_x(16, b=64, c=24))
    d = aug.draw_channels_shuffle(9, x, 1.0)
    perm = aug.shuffle_permutation(d["in_subset"], d["noise"])
    y = aug.apply_channels_shuffle(x, **d)
    ar = torch.arange(24).expand(64, 24)
    assert torch.equal(perm.sort(dim=1).values, ar)  # a permutation per sample
    sel = d["in_subset"]
    assert torch.equal(perm[~sel], ar[~sel])  # unselected rows stay
    assert bool(sel.gather(1, perm)[sel].all())  # selected rows come from selected rows
    assert torch.equal(y, torch.gather(x, 1, perm[:, :, None].expand(x.shape)))
    # the sorted rows are equal: only the order changed
    assert torch.equal(y.sort(dim=1).values, x.sort(dim=1).values)
    assert not torch.equal(y, x)


def test_batch_mixup_matches_jax_on_its_draws():
    rng = np.random.default_rng(2)
    eeg, partner = (rng.standard_normal((B, 32, 64)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_apply_mixup(key, jnp.asarray(eeg), jnp.asarray(partner), P))
    k1, k2 = split(key)
    do_aug = jax.random.uniform(k1, (B,)) < P
    alphas = jax.random.uniform(k2, (B,))
    got = aug.apply_batch_mixup(_t(eeg), _t(partner), _t(do_aug), _t(alphas))
    assert 0 < int(np.asarray(do_aug).sum()) < B
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * float(np.abs(eeg).max()), rtol=0)
    # the step's own draws: rows mixed or kept, the share near p
    out = _apply_mixup(8, _t(eeg), _t(partner), 1.0)
    assert not bool((out == _t(eeg)).flatten(1).all(1).any())
    assert torch.equal(_apply_mixup(8, _t(eeg), _t(partner), 0.0), _t(eeg))
    share = float(aug.draw_batch_mixup(8, 20_000, P, "cpu")["do_aug"].float().mean())
    assert abs(share - P) <= 5 * math.sqrt(P * (1 - P) / 20_000)


def test_chunk_mixup_matches_jax_on_its_draws():
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((3, 10, 8, 64)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jaug.mixup_eeg(key, jnp.asarray(eeg), P))
    k1, k2, k3 = split(key, 3)
    draws = {"do_aug": jax.random.uniform(k1, (3, 10)) < P,
             "alphas": jax.random.uniform(k2, (3, 10)),
             "partner": jax.random.randint(k3, (3, 10), 0, 3)}
    got = aug.apply_mixup_eeg(_t(eeg), **{k: _t(v) for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * float(np.abs(eeg).max()), rtol=0)
    d = aug.draw_mixup_eeg(1, _t(eeg), P)
    assert int(d["partner"].min()) >= 0 and int(d["partner"].max()) < 3
    assert d["partner"].dtype == torch.int64
    assert torch.equal(aug.mixup_eeg(1, _t(eeg), P), aug.apply_mixup_eeg(_t(eeg), **d))


# -- numpy draws: the host iterator and the chunk store ------------------------

SP_D, WL, BS = 16, 64, 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparrkulee_aug"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    return root


def _dataset(root, cls, **kw):
    files = get_train_val_test_files_final(root, 0, "wav2vec_19", f"{root}/fold_split.json", 3)
    return cls(files[0], files[4], WL, WL, batch_size=BS, shuffle=True,
               shuffle_percentage=1.0, seed=7, **kw)


@pytest.mark.parametrize("add_eeg", [False, True], ids=["plain", "addEEG"])
def test_host_iterator_and_mixup_equal_jax(root, add_eeg):
    """``__iter__`` (with ``_mixup`` when ``addEEG``) yields JAX's batches
    bit for bit over two epochs, and leaves the rng where JAX leaves it."""
    mine = _dataset(root, EEGWindowDataset, addEEG=add_eeg)
    theirs = _dataset(root, JDataset, addEEG=add_eeg)
    n = 0
    for _ in range(2):
        for a, b in zip(mine, theirs, strict=True):
            np.testing.assert_array_equal(a[0], b[0])
            for x, y in zip(a[1], b[1], strict=True):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])
            n += 1
    assert n > 10 and mine.batches_keys == theirs.batches_keys
    key = mine.batches_keys[0]
    np.testing.assert_array_equal(mine._mixup(mine.chunks[key]["eeg"]),
                                  theirs._mixup(theirs.chunks[key]["eeg"]))
    assert mine.rng.integers(1 << 30) == theirs.rng.integers(1 << 30)
    assert EEGDatasetSimdata is EEGWindowDataset


def test_host_iterator_augments_and_keeps_the_rng_aligned(root):
    """With an augmentation each batch is the port's transform of JAX's
    un-augmented batch, keyed by the same draw from ``rng``, which stays
    aligned with JAX's."""
    mine = _dataset(root, EEGWindowDataset, data_augmentation=["SignFlip"],
                    data_augmentation_probability=0.5)
    theirs = _dataset(root, JDataset, data_augmentation=["SignFlip"],
                      data_augmentation_probability=0.5)
    n_flipped = 0
    for a, b in zip(mine, theirs, strict=True):
        assert a[0].shape == b[0].shape and a[0].dtype == np.float32
        # a sign flip of each sample, whichever the draws
        np.testing.assert_array_equal(np.abs(a[0]), np.abs(b[0]))
        n_flipped += int(not np.array_equal(a[0], b[0]))
        np.testing.assert_array_equal(a[2], b[2])
    assert n_flipped > 0
    assert mine.rng.integers(1 << 30) == theirs.rng.integers(1 << 30)


@pytest.mark.parametrize("walk", ["epoch_batches", "epoch_chunk_batches"])
def test_store_mixup_partners_equal_jax(root, walk):
    """With ``add_eeg`` the store draws its partner matrices where the JAX
    store does: index, subject and partner matrices equal over two epochs,
    partners only among the chunk's real subjects."""
    mine = DeviceChunkStore(_dataset(root, EEGWindowDataset), device="cpu", prefetch=False)
    theirs = JStore(_dataset(root, JDataset), prefetch=False)
    n = 0
    for _ in range(2):
        for a, b in zip(getattr(mine, walk)(add_eeg=True), getattr(theirs, walk)(add_eeg=True),
                        strict=True):
            for x, y in zip(a[3:], b[3:], strict=True):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            partner = np.asarray(a[5])  # 3 subjects a chunk, padded to 8
            assert partner.min() >= 0 and partner.max() < 3 < a[0].shape[0]
            n += 1
    assert n > 4
    assert mine.dataset.rng.integers(1 << 30) == theirs.dataset.rng.integers(1 << 30)
