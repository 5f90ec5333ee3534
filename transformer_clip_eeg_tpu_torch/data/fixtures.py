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
    icassp/TEST_task1_matchmismatch/
      labels/*.json, sub-*.json, wav2vec_segments_wholefile_64hz/*.pkl
    icassp/TEST_task2_regression/
      labels/*.json, sub-*.json

The EEG is a noisy linear mix of the stimulus feature, so a trained model
has real signal to find.  The ``icassp/`` tree (the ICASSP-2023 challenge
folders the evaluation suite reads) is drawn from the same stream after the
training data, so it too equals the JAX package's file for file.
"""

from __future__ import annotations

import json
import os
import pickle
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
    window_length: int = 192,
    seed: int = 0,
    correlated: bool = True,
    n_test_subjects: int = 1,
    stories_per_subject: Optional[int] = None,
    mm_subjects: int = 2,
    mm_noise: float = 0.5,
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

    meta = {
        "stories": stories,
        "train_subjects": train_subjects,
        "test_subjects": test_subjects,
        "speech_dim": speech_dim,
        "t": t,
        "root": root,
    }
    _make_icassp_testset(
        root, rng, mix, speech_dim, window_length, n_subjects=mm_subjects,
        meta=meta, noise=mm_noise, env_decodable=env_decodable,
        env_gain=env_gain, env_direction=env_direction,
    )
    return meta

def regen_icassp_testset(
    root: str,
    speech_dim: int,
    window_length: int = 192,
    n_subjects: int = 14,
    noise: float = 0.5,
    seed: int = 0,
    trials: int = 8,
    env_decodable: bool = False,
    env_gain: float = 1.0,
) -> Dict:
    """Regenerate ONLY the ``icassp/`` held-out eval tree of an existing
    fixture — e.g. with more subjects or a lower SNR (``noise`` is the EEG
    noise std against a unit-variance projected-speech signal) so the MM
    eval measures *discrimination* rather than saturating at 100%
    (VERDICT r3 #4).  The speech→EEG mixing matrix is reproduced from
    ``seed`` exactly as :func:`make_fixture` drew it (its first rng draw),
    so a model trained on the corpus transfers; candidate segments and
    trials are freshly drawn.
    """
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((speech_dim, 64)).astype(np.float32) / np.sqrt(
        speech_dim
    )
    # reproduce the fixture's env_direction (its second rng draw — see
    # make_fixture) so env_decodable corpora regen with matching EEG physics
    env_direction = rng.standard_normal(64).astype(np.float32)
    meta: Dict = {"root": root}
    _make_icassp_testset(
        root, np.random.default_rng(seed + 1000), mix, speech_dim,
        window_length, n_subjects=n_subjects, meta=meta, noise=noise,
        trials=trials, env_decodable=env_decodable, env_gain=env_gain,
        env_direction=env_direction,
    )
    return meta


def _make_icassp_testset(
    root: str,
    rng: np.random.Generator,
    mix: np.ndarray,
    speech_dim: int,
    window_length: int,
    n_subjects: int,
    meta: Dict,
    noise: float = 0.5,
    trials: int = 8,
    env_decodable: bool = False,
    env_gain: float = 1.0,
    env_direction: Optional[np.ndarray] = None,
):
    """ICASSP-2023 challenge test folders (match-mismatch + regression)."""
    mm_dir = os.path.join(root, "icassp", "TEST_task1_matchmismatch")
    seg_dir = os.path.join(mm_dir, "wav2vec_segments_wholefile_64hz")
    lab_dir = os.path.join(mm_dir, "labels")
    os.makedirs(seg_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)

    # candidate stimulus segments: one pkl of {key: [wl, speech_dim]}
    n_segments = 12
    seg_keys = [f"teststory_-_seg{i}" for i in range(n_segments)]
    segments = {
        k: rng.standard_normal((window_length, speech_dim)).astype(np.float32)
        for k in seg_keys
    }
    if env_decodable:
        # keep the eval segments distributionally consistent with the
        # training stories: channel 0 is a standardized smooth envelope
        for k in seg_keys:
            segments[k][:, 0] = _standardize(_smooth_env(rng, window_length))
    with open(os.path.join(seg_dir, "teststory_-_wav2vec_19.pkl"), "wb") as f:
        pickle.dump(segments, f)
    # mel/env candidate sets for the same segments (the MM eval globs
    # ``*{stimulus_feature}*.pkl`` — ref helper:58,92 — so runs trained on
    # mel/env need their own candidate files), derived with the same
    # transformations the main fixture applies to story features above
    def _mel_of(x):
        m = np.abs(x[:, : min(28, speech_dim)])
        if m.shape[1] < 28:
            m = np.tile(m, (1, int(np.ceil(28 / m.shape[1]))))[:, :28]
        return m.astype(np.float32)

    with open(os.path.join(seg_dir, "teststory_-_mel.pkl"), "wb") as f:
        pickle.dump({k: _mel_of(v) for k, v in segments.items()}, f)
    with open(os.path.join(seg_dir, "teststory_-_env.pkl"), "wb") as f:
        pickle.dump(
            {k: np.abs(v[:, :1]).astype(np.float32)
             for k, v in segments.items()},
            f,
        )

    for si in range(n_subjects):
        sub = f"sub-9{si:02d}"
        mapping = {}
        labels = {}
        for trial in range(trials):
            key = f"{sub}_trial{trial}"
            match_idx, mismatch_idx = rng.choice(n_segments, 2, replace=False)
            label = int(rng.integers(0, 2))
            cand = (
                [seg_keys[match_idx], seg_keys[mismatch_idx]]
                if label == 0
                else [seg_keys[mismatch_idx], seg_keys[match_idx]]
            )
            eeg = segments[seg_keys[match_idx]] @ mix
            if env_decodable:
                eeg = eeg + env_gain * np.outer(
                    segments[seg_keys[match_idx]][:, 0], env_direction / 8.0
                )
            eeg = (
                eeg + noise * rng.standard_normal((window_length, 64))
            ).astype(np.float32)
            mapping[key] = [eeg.tolist(), cand[0] + ".npy", cand[1] + ".npy"]
            labels[key] = label
        with open(os.path.join(mm_dir, f"{sub}.json"), "w") as f:
            json.dump(mapping, f)
        with open(os.path.join(lab_dir, f"{sub}_labels.json"), "w") as f:
            json.dump(labels, f)

    # task 2: regression — per-subject trials of raw EEG + envelope labels
    reg_dir = os.path.join(root, "icassp", "TEST_task2_regression")
    reg_lab_dir = os.path.join(reg_dir, "labels")
    os.makedirs(reg_lab_dir, exist_ok=True)
    t_trial = window_length * 4  # several overlap-add windows
    for si in range(n_subjects):
        sub = f"sub-9{si:02d}"
        mapping = {}
        labels = {}
        for trial in range(3):
            key = f"{sub}_reg_trial{trial}"
            speech = rng.standard_normal((t_trial, speech_dim)).astype(np.float32)
            if env_decodable:
                env_trial = _smooth_env(rng, t_trial)
                env_std = _standardize(env_trial)
                speech[:, 0] = env_std
                eeg = (
                    speech @ mix
                    + env_gain * np.outer(env_std, env_direction / 8.0)
                    + noise * rng.standard_normal((t_trial, 64))
                ).astype(np.float32)
                labels[key] = [env_trial.tolist()]
            else:
                eeg = (
                    speech @ mix + noise * rng.standard_normal((t_trial, 64))
                ).astype(np.float32)
                labels[key] = [np.abs(speech[:, 0]).tolist()]
            mapping[key] = eeg.tolist()
        with open(os.path.join(reg_dir, f"{sub}.json"), "w") as f:
            json.dump(mapping, f)
        with open(os.path.join(reg_lab_dir, f"{sub}_labels.json"), "w") as f:
            json.dump(labels, f)

    meta["icassp_mm_dir"] = mm_dir
    meta["icassp_reg_dir"] = reg_dir
