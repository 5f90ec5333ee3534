"""SparrKULee windowing dataset, on the host in numpy.

The torch package's own copy of ``EEGWindowDataset`` from
``transformer_clip_eeg_tpu/data/dataset.py`` (behavioural parity with the
reference ``EEGDatasetSimdata``, ``dataset_loader.py:68-477``): host ingest
with the exact chunking math (``number_batches = len // (hop*(bs-1) +
window)``, equal ``len_per_batch`` chunks, non-overlapping windows with the
drop-last quirk, EEG zero-pad/crop, globally unique segment identifiers,
<64-channel recordings skipped) and the reference's per-chunk batch sampling
(``create_eeg_indices``).  ``split_into_windows_np`` is copied from
``transformer_clip_eeg_tpu/ops/windowing.py``, which imports JAX.

The trainer gathers batches itself (``train/loop.batch_iterator``), so the
reference-compatible ``__iter__`` and its host mixup, the device path's
``sample_epoch_indices`` and the CV driver's file cache are not copied.  The
braindecode augmentations run in JAX in the other package and are not
ported yet: asking for them raises ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from transformer_clip_eeg_tpu_torch.data.discovery import (
    feature_of_audio_file,
    story_of_audio_file,
    story_of_eeg_file,
    subject_of_eeg_file,
)


def split_into_windows_np(x: np.ndarray, window_length: int) -> np.ndarray:
    """Non-overlapping windows over axis 0, ``[T, F] -> [n, window_length,
    F]``, with the reference's quirk: ``np.split(...)[:-1]`` drops the ragged
    tail and, when the length divides evenly, the last full window too."""
    t = x.shape[0]
    n = t // window_length
    if t % window_length == 0:
        n -= 1
    return x[: n * window_length].reshape((n, window_length) + x.shape[1:])


class EEGWindowDataset:
    """Story-chunked, windowed EEG + speech-feature dataset."""

    def __init__(
        self,
        files: Sequence[str],
        audio_files: Sequence[str],
        window_length: int,
        hop_length: int,
        number_mismatch: Optional[int] = None,
        data_augmentation: Sequence[str] = (),
        data_augmentation_probability: float = 0.5,
        addEEG: bool = False,
        exclusion_list: Sequence[str] = (),
        batch_size: int = 64,
        shuffle: bool = False,
        shuffle_percentage: float = 0.5,
        seed: Optional[int] = None,
        io_workers: Optional[int] = None,
    ):
        self.exclusion_list = list(exclusion_list)
        files = self.exclude_subjects(list(files), self.exclusion_list)
        self.eeg_files, self.audio_files = self.group_recordings(files, audio_files)

        self.batch_size = batch_size
        self.window_length = window_length
        self.hop_length = hop_length
        self.number_mismatch = number_mismatch
        self.shuffle_subs = shuffle
        self.shuffle_percentage = shuffle_percentage
        self.addEEG = addEEG
        self.data_augmentation = list(data_augmentation)
        self.data_augmentation_probability = data_augmentation_probability
        self.rng = np.random.default_rng(seed)
        if self.data_augmentation:
            raise NotImplementedError(
                f"data augmentation {self.data_augmentation} is not ported to the "
                "torch package yet (ops/augment.py; see ROADMAP.md)"
            )

        self.features_to_load = self.filter_features(self.audio_files)
        if io_workers is None:
            io_workers = min(8, os.cpu_count() or 1)
        self.io_workers = max(1, int(io_workers))
        self.chunks: Dict[str, Dict] = self.load_files(
            self.eeg_files, self.audio_files
        )
        self.batches_keys: List[str] = list(self.chunks.keys())

    # -- discovery ----------------------------------------------------------

    @staticmethod
    def exclude_subjects(files: List[str], exclusion_list: Sequence[str]) -> List[str]:
        return [f for f in files if not any(x in f for x in exclusion_list)]

    @staticmethod
    def group_recordings(files, audio_files):
        """Pair EEG files to stimuli by story name (ref dataset_loader.py:291-331)."""
        eeg_dict: Dict[str, List[str]] = {}
        for file in files:
            eeg_dict.setdefault(story_of_eeg_file(file), []).append(file)
        audio_dict: Dict[str, Dict[str, str]] = {}
        for file in audio_files:
            story = story_of_audio_file(file)
            if story not in eeg_dict:
                continue  # audio without EEG is dropped
            audio_dict.setdefault(story, {})[feature_of_audio_file(file)] = file
        return eeg_dict, audio_dict

    @staticmethod
    def filter_features(audio_dict) -> List[str]:
        features: List[str] = []
        for story_files in audio_dict.values():
            for feature in story_files:
                if feature not in features:
                    features.append(feature)
        return features

    # -- ingest -------------------------------------------------------------

    def load_files(self, eeg_dict, audio_dict) -> Dict[str, Dict]:
        """Core ingestion (ref dataset_loader.py:197-281), semantics preserved
        exactly (chunk counts, padding, identifier numbering, channel guard).

        I/O is overlapped: ``np.load`` reads are submitted to a thread pool
        (``io_workers``; numpy releases the GIL during file reads) with a
        bounded read-ahead of ``2 × io_workers`` files — so peak host memory
        stays near the serial path's — and the sequential bookkeeping loop
        consumes them in the original order, keeping chunk layout and
        identifier numbering byte-identical to the serial path.
        """
        wl, hop, bs = self.window_length, self.hop_length, self.batch_size
        chunks: Dict[str, Dict] = {}
        id_max = 0

        pool = None
        if self.io_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            all_paths = [
                p
                for story, eeg_files in eeg_dict.items()
                for p in (
                    list(audio_dict.get(story, {}).values()) + list(eeg_files)
                )
            ]
            pool = ThreadPoolExecutor(max_workers=self.io_workers)
            loaded: Dict[str, object] = {}
            ahead = self.io_workers * 2  # bounded read-ahead: no host OOM
            next_submit = 0

            def _fill():
                nonlocal next_submit
                while next_submit < len(all_paths) and len(loaded) < ahead:
                    p = all_paths[next_submit]
                    next_submit += 1
                    loaded[p] = pool.submit(np.load, p)

            _fill()

            def read(path):
                fut = loaded.pop(path, None)
                out = fut.result() if fut is not None else np.load(path)
                _fill()
                return out
        else:
            def read(path):
                return np.load(path)

        for story, eeg_files in eeg_dict.items():
            audio_files = audio_dict.get(story, {})
            number_batches = 0
            len_per_batch = 0
            total_len = 0
            first = True
            for feature_name, path in audio_files.items():
                data = read(path)
                if "wav2vec" not in feature_name:
                    data = np.concatenate(data, axis=0)
                if first:
                    total_len = data.shape[0]
                    number_batches = int(total_len / (hop * (bs - 1) + wl))
                    if number_batches == 0:
                        print(f"story {story} is too short, skipping this one")
                        break
                    len_per_batch = int(total_len / number_batches)
                    for i in range(number_batches):
                        chunks[f"{story}_batch_{i}"] = {}
                    first = False
                data_split = np.split(
                    data, range(len_per_batch, total_len, len_per_batch), axis=0
                )[:number_batches]
                for i in range(number_batches):
                    chunks[f"{story}_batch_{i}"][feature_name] = (
                        split_into_windows_np(data_split[i], wl)
                    )

            if number_batches == 0:
                continue

            for eeg_file in eeg_files:
                data = read(eeg_file)
                data = np.transpose(data)
                if data.shape[1] < 64:
                    print(f"eeg too short: {eeg_file} , {data.shape}")
                    with open("eeg_too_short.txt", "a") as f:
                        f.write(eeg_file + "\n")
                    continue
                sub = subject_of_eeg_file(eeg_file)
                data_split = np.split(
                    data, range(len_per_batch, total_len, len_per_batch), axis=0
                )[:number_batches]
                for i in range(number_batches):
                    piece = data_split[i]
                    if piece.shape[0] < len_per_batch:
                        piece = np.concatenate(
                            [piece, np.zeros((len_per_batch - piece.shape[0], 64))],
                            axis=0,
                        )
                    elif piece.shape[0] > len_per_batch:
                        piece = piece[:len_per_batch, :]
                    windows = split_into_windows_np(piece, wl)
                    chunk = chunks[f"{story}_batch_{i}"]
                    # accumulate per-subject window stacks and materialize
                    # once below: appending via np.concatenate is O(n_subs²)
                    # memcpy (ref dataset_loader.py:262-267 does exactly
                    # that — ~newGB-scale copying per chunk at 85 subjects)
                    chunk.setdefault("_eeg_parts", []).append(windows)
                    if "identifiers" not in chunk:
                        chunk["identifiers"] = [
                            j + id_max + 1 for j in range(windows.shape[0])
                        ]
                        id_max = chunk["identifiers"][-1]
                    if "sub" not in chunk:
                        chunk["sub"] = [sub]
                    else:
                        chunk["sub"].append(sub)

        if pool is not None:
            pool.shutdown(wait=True)  # ≤ `ahead` leftovers from skipped stories
        for chunk in chunks.values():
            parts = chunk.pop("_eeg_parts", None)
            if parts is not None:
                # one stack == the incremental concatenate's result (same
                # order, same dtype promotion), without the O(n²) growth
                chunk["eeg"] = np.stack(parts, axis=0)
        return chunks

    # -- sizing -------------------------------------------------------------

    def get_number_of_stimuli_segments(self) -> int:
        """Total unique speech segments — sizes the memory bank
        (ref dataset_loader.py:167-172)."""
        return sum(c["eeg"].shape[1] for c in self.chunks.values() if "eeg" in c)

    def __len__(self) -> int:
        return len(self.batches_keys)

    # -- batch index sampling (exact reference semantics) -------------------

    def create_eeg_indices(self, eeg: np.ndarray):
        """Per-chunk sampling (ref dataset_loader.py:436-464): per subject,
        ``bs`` window indices without replacement; optional cross-subject
        permutation of the first ``bs * shuffle_percentage`` columns."""
        rng = self.rng
        n_subs, len_batch = eeg.shape[0], eeg.shape[1]
        bs = self.batch_size
        if len_batch < bs:
            # same failure mode as the reference (np.random.choice raises),
            # but with an actionable message; hit when story length is an
            # exact multiple of the chunk size (the [:-1] windowing quirk,
            # ref dataset_loader.py:476, drops one window per chunk)
            raise ValueError(
                f"chunk has only {len_batch} windows but batch_size={bs}; "
                "reduce --batch_size or use recordings whose length is not "
                "an exact multiple of hop*(batch_size-1)+window"
            )
        speech_idx = np.stack(
            [rng.choice(len_batch, bs, replace=False) for _ in range(n_subs)]
        )
        subs_per_batch = np.repeat(range(n_subs), bs).reshape(n_subs, bs)
        if self.shuffle_subs:
            half_len = int(bs * self.shuffle_percentage)
            subs_per_batch = np.concatenate(
                [
                    rng.permuted(subs_per_batch[:, :half_len], axis=0),
                    subs_per_batch[:, half_len:],
                ],
                axis=1,
            )
        return speech_idx, subs_per_batch
