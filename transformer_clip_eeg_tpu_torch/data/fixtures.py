"""Synthetic SparrKULee-format fixture generator.

The torch package's own copy of ``make_fixture`` from
``transformer_clip_eeg_tpu/data/fixtures.py``: the same tree, drawn from the
same numpy stream, so a seed gives byte-identical files in both packages::

    root/
      fold_split.json
      derivatives/preprocessed_eeg/<sub>/<sub>_..._-audio-<story>_eeg.npy  [64, T]
      derivatives/preprocessed_stimuli/<story>_-_wav2vec_19.npy            [T, D]
      derivatives/preprocessed_stimuli/<story>_-_env.npy                   [1, T, 1]
      derivatives/preprocessed_stimuli/<story>_-_mel.npy                   [1, T, 28]

The EEG is a noisy linear mix of the stimulus feature, so a trained model
has real signal to find.  The ICASSP challenge folders (``icassp/``) that the
JAX fixture also writes are for the evaluation suite, which is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

FS = 64


def _smooth_env(rng: np.random.Generator, t: int) -> np.ndarray:
    """A slowly-varying positive 'speech envelope': rectified moving-average
    noise (cutoff ~2 Hz at 64 Hz fs) — smooth enough that windowing /
    nearest-neighbor stride compensation preserve its correlation."""
    z = rng.standard_normal(t + 64).astype(np.float32)
    kernel = np.hanning(65).astype(np.float32)
    e = np.convolve(z, kernel / kernel.sum(), mode="valid")[:t]
    return (np.abs(e) + 0.05).astype(np.float32)


def _standardize(x: np.ndarray) -> np.ndarray:
    return ((x - x.mean()) / (x.std() + 1e-8)).astype(np.float32)


def make_fixture(
    root: str,
    n_stories: int = 4,
    n_subjects: int = 3,
    story_seconds: int = 120,
    speech_dim: int = 32,
    seed: int = 0,
    correlated: bool = True,
    n_test_subjects: int = 1,
    stories_per_subject: Optional[int] = None,
    env_decodable: bool = False,
    env_gain: float = 1.0,
) -> Dict:
    """Create the fixture tree under ``root``; returns metadata.

    ``speech_dim`` defaults small (32) to keep tests fast, but files are
    named ``wav2vec_19`` so the default stimulus flag works unchanged.

    ``stories_per_subject``: each subject records only a random subset of
    stories (the real SparrKULee shape — subjects hear ~8-10 of the
    stimuli, so chunks have ragged subject counts); ``None`` = every
    subject hears every story (the small-test default).

    ``env_decodable``: positive control for the envelope-regression suite
    (VERDICT r4 #1b).  By default the saved env is ``|speech[:, 0]|`` — a
    *nonlinear* function of what the EEG linearly encodes, so every probe
    ever trained on the default fixture sat at Pearson ≈ 0.  With
    ``env_decodable=True`` the env becomes a smooth positive signal whose
    standardized form (a) replaces speech channel 0 (so contrastive
    training has incentive to keep it in the EEG embedding) and (b) is
    injected directly into the EEG mix with per-channel strength
    ``env_gain`` (so the envelope is linearly present in the raw EEG) —
    a correct regression suite MUST now reach materially-positive Pearson.
    """
    rng = np.random.default_rng(seed)
    eeg_dir = os.path.join(root, "derivatives", "preprocessed_eeg")
    stim_dir = os.path.join(root, "derivatives", "preprocessed_stimuli")
    os.makedirs(eeg_dir, exist_ok=True)
    os.makedirs(stim_dir, exist_ok=True)

    stories = [f"audiobook_{i + 1}" for i in range(n_stories)]
    all_subjects = [f"sub-{i + 1:03d}" for i in range(n_subjects + n_test_subjects)]
    train_subjects = all_subjects[:n_subjects]
    test_subjects = all_subjects[n_subjects:]

    # fold split: stories round-robin over folds 0..min(8, n)-1, last story as
    # the 2023 test set
    folds: Dict[str, List[str]] = {str(i): [] for i in range(9)}
    for i, story in enumerate(stories[:-1]):
        folds[str(i % 9)].append(story)
    split = dict(folds)
    split["test_set_2023_1"] = [stories[-1]]
    split["train_subs"] = train_subjects
    split["test_subs"] = test_subjects
    with open(os.path.join(root, "fold_split.json"), "w") as f:
        json.dump(split, f)

    # which subjects recorded which story (every subject must keep >=1 story;
    # every story must keep >=1 subject or its chunk would be empty)
    story_subjects: Dict[str, List[str]] = {s: [] for s in stories}
    if stories_per_subject is None or stories_per_subject >= n_stories:
        for s in stories:
            story_subjects[s] = list(all_subjects)
    else:
        for i, sub in enumerate(all_subjects):
            # rotate a contiguous window so coverage is balanced
            picks = [
                stories[(i + j) % n_stories]
                for j in range(stories_per_subject)
            ]
            for s in picks:
                story_subjects[s].append(sub)

    t = story_seconds * FS
    mix = rng.standard_normal((speech_dim, 64)).astype(np.float32) / np.sqrt(
        speech_dim
    )
    # fixed EEG direction carrying the envelope in env_decodable mode (drawn
    # whether or not the mode is on, to keep the rng stream position stable
    # across the flag for everything drawn after it)
    env_direction = rng.standard_normal(64).astype(np.float32)
    story_speech = {}
    story_env_std = {}
    for story in stories:
        speech = rng.standard_normal((t, speech_dim)).astype(np.float32)
        if env_decodable:
            env = _smooth_env(rng, t)[:, None]
            speech[:, 0] = _standardize(env[:, 0])
        else:
            env = np.abs(speech[:, :1])
        story_speech[story] = speech
        story_env_std[story] = _standardize(env[:, 0])
        np.save(os.path.join(stim_dir, f"{story}_-_wav2vec_19.npy"), speech)
        np.save(os.path.join(stim_dir, f"{story}_-_env.npy"), env[None, :, :])
        mel = np.abs(speech[:, : min(28, speech_dim)])
        if mel.shape[1] < 28:
            mel = np.tile(mel, (1, int(np.ceil(28 / mel.shape[1]))))[:, :28]
        np.save(os.path.join(stim_dir, f"{story}_-_mel.npy"), mel[None, :, :])

        for sub in story_subjects[story]:
            sub_dir = os.path.join(eeg_dir, sub)
            os.makedirs(sub_dir, exist_ok=True)
            noise = rng.standard_normal((t, 64)).astype(np.float32)
            if correlated:
                eeg = story_speech[story] @ mix + 0.5 * noise
                if env_decodable:
                    eeg = eeg + env_gain * np.outer(
                        story_env_std[story], env_direction / 8.0
                    )
            else:
                eeg = noise
            name = f"{sub}_task-listening_-audio-{story}_eeg.npy"
            np.save(os.path.join(sub_dir, name), eeg.T)  # on-disk layout [64, T]

    return {
        "stories": stories,
        "train_subjects": train_subjects,
        "test_subjects": test_subjects,
        "speech_dim": speech_dim,
        "t": t,
        "root": root,
    }
