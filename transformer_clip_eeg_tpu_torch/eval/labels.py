"""ICASSP-2023 challenge ground-truth label loading.

Counterpart of ``transformer_clip_eeg_tpu/eval/labels.py`` (ref
``train_clip_helper_functions.py:25-49``): merge every per-subject
``labels/*.json`` into one flat ``{trial_key: label}`` dict.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional


def load_labels_match_mismatch_2023(path_true_labels: str) -> Dict:
    """Ref train_clip_helper_functions.py:25-34."""
    labels_all: Dict = {}
    for file in glob.glob(os.path.join(path_true_labels, "*.json")):
        with open(file) as f:
            labels_all.update(json.load(f))
    return labels_all


def load_labels_regression_2023(path_true_labels: str, subject: Optional[str] = None) -> Dict:
    """Ref train_clip_helper_functions.py:36-49; ``subject`` keeps the files
    whose name contains it."""
    labels_all: Dict = {}
    all_files = glob.glob(os.path.join(path_true_labels, "*.json"))
    if subject is not None:
        all_files = [x for x in all_files if subject in x]
    for file in all_files:
        with open(file) as f:
            labels_all.update(json.load(f))
    return labels_all
