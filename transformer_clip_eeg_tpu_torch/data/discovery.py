"""SparrKULee file discovery and cross-validation splits.

The torch package's own copy of ``transformer_clip_eeg_tpu/data/discovery.py``
(standard library only).

Exact behavioral parity with ref ``train_clip_helper_functions.py:383-440``:
story-level CV from ``fold_split.json`` (test = ``test_set_2023_1``, val =
fold ``str(run)``, train = folds 0–8 minus val), subject-level split into the
first ``number_of_training_subjects`` of ``train_subs`` vs held-out
``test_subs``, and the same filename-parsing contracts:

* story of an EEG file   = ``basename.split("-audio-")[-1].split("_eeg")[0]``
* subject of an EEG file = ``basename.split("_")[0]``
* story of an audio file = ``basename.split("_-_")[0]``
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Tuple


def story_of_eeg_file(path: str) -> str:
    return os.path.basename(path).split("-audio-")[-1].split("_eeg")[0]


def subject_of_eeg_file(path: str) -> str:
    return os.path.basename(path).split("_")[0]


def story_of_audio_file(path: str) -> str:
    return os.path.basename(path).split("_-_")[0]


def feature_of_audio_file(path: str) -> str:
    return os.path.basename(path).split("_-_")[1].split(".")[0]


def get_train_val_test_files_final(
    data_folder: str,
    run: int,
    stimulus_feature: str,
    dataset_split_stories: str,
    number_of_training_subjects: int,
    debug: bool = False,
) -> Tuple[List[str], ...]:
    """Ref train_clip_helper_functions.py:383-440 — returns 8 lists:
    (train, val, test, test_heldout) EEG files and the matching audio lists.
    """
    with open(dataset_split_stories) as json_file:
        data_split = json.load(json_file)

    all_eeg_files = glob.glob(
        os.path.join(data_folder, "derivatives", "preprocessed_eeg", "**/*_eeg.npy"),
        recursive=True,
    )
    all_audio_files = glob.glob(
        os.path.join(
            data_folder,
            "derivatives",
            "preprocessed_stimuli",
            f"**/*{stimulus_feature}.npy",
        ),
        recursive=True,
    )

    test_split = "test_set_2023_1"
    val_split = f"{run}"
    test_stories = data_split[test_split]
    val_stories = data_split[val_split]
    train_stories = [
        s
        for x in range(0, 9)
        if f"{x}" != test_split and f"{x}" != val_split
        for s in data_split[f"{x}"]
    ]

    if debug:
        test_stories = test_stories[0:1]
        val_stories = val_stories[0:1]
        train_stories = train_stories[0:2]

    train_subjects = data_split["train_subs"][0:number_of_training_subjects]
    test_subjects = data_split["test_subs"]

    test_files_heldout = [
        x for x in all_eeg_files if subject_of_eeg_file(x) in test_subjects
    ]
    files_seen_subs = [
        x for x in all_eeg_files if subject_of_eeg_file(x) in train_subjects
    ]

    test_files = [x for x in files_seen_subs if story_of_eeg_file(x) in test_stories]
    val_files = [x for x in files_seen_subs if story_of_eeg_file(x) in val_stories]
    train_files = [x for x in files_seen_subs if story_of_eeg_file(x) in train_stories]

    # distinct stories actually present per split drive the audio lists
    test_stories_heldout = list({story_of_eeg_file(x) for x in test_files_heldout})
    test_stories = list({story_of_eeg_file(x) for x in test_files})
    val_stories = list({story_of_eeg_file(x) for x in val_files})
    train_stories = list({story_of_eeg_file(x) for x in train_files})

    test_audio_heldout = [
        x for x in all_audio_files if story_of_audio_file(x) in test_stories_heldout
    ]
    test_audio = [x for x in all_audio_files if story_of_audio_file(x) in test_stories]
    val_audio = [x for x in all_audio_files if story_of_audio_file(x) in val_stories]
    train_audio = [x for x in all_audio_files if story_of_audio_file(x) in train_stories]

    if debug:
        train_files = train_files[0:5]
        val_files = val_files[0:5]
        test_files = test_files[0:5]
        test_files_heldout = test_files_heldout[0:5]

    return (
        train_files,
        val_files,
        test_files,
        test_files_heldout,
        train_audio,
        val_audio,
        test_audio,
        test_audio_heldout,
    )
