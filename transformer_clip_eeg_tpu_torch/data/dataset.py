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

The trainer gathers batches itself (``train/loop.batch_iterator``, or the
device-resident store of ``train/device_data.py``) and mixes and augments
them in the train step; ``__iter__`` is the reference's own host iterator
(ref ``dataset_loader.py:392-434``), with its chunk mixup (``_mixup``, numpy
draws from ``self.rng`` in the JAX package's order) and the augmentations
of ``ops/augment.py`` per batch.  ``sample_epoch_indices`` is not copied;
``iter_subject_windows`` feeds the regression evals.

The ingest file cache (``set_ingest_file_cache``, ``_cached_load``) is the
JAX package's: the cross-validation driver installs it around the per-fold
evaluation suites, which ingest overlapping splits, so that each ``.npy``
file is read once, as a read-only memmap.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.data.discovery import (
    feature_of_audio_file,
    story_of_audio_file,
    story_of_eeg_file,
    subject_of_eeg_file,
)


# The opt-in, process-wide read cache of ingest: path -> a READ-ONLY MEMMAP
# of the .npy file (pickled files, which cannot be mapped, as heap arrays).
# Memmap pages are file-backed: they sit in the kernel's page cache, are
# evicted under memory pressure and add nothing to the process heap, where
# cached arrays would interleave with the evaluation suites' churn and fragment
# it.  Downstream ingest takes views and copies of them as of heap arrays, and
# an in-place write raises instead of corrupting the cache.  None = off.
_FILE_CACHE: Optional[dict] = None


def set_ingest_file_cache(cache: Optional[dict]) -> None:
    """Install (or clear, with ``None``) the dict that memoizes raw-file
    reads during ingest.  The caller owns the dict and its lifetime."""
    global _FILE_CACHE
    _FILE_CACHE = cache


def _cached_load(path: str):
    """``np.load(path)``; with a cache installed, the cached read-only
    memmap of ``path`` (read and cached on first use)."""
    cache = _FILE_CACHE
    if cache is None:
        return np.load(path)
    arr = cache.get(path)
    if arr is None:
        try:
            arr = np.load(path, mmap_mode="r")
        except ValueError:  # a pickled .npy cannot be mapped: a heap array
            arr = np.load(path)
        cache[path] = arr
    return arr


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
        self._aug_fn = None

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
                    loaded[p] = pool.submit(_cached_load, p)

            _fill()

            def read(path):
                fut = loaded.pop(path, None)
                out = fut.result() if fut is not None else _cached_load(path)
                _fill()
                return out
        else:
            def read(path):
                return _cached_load(path)

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

    def create_eeg_indices(self, eeg: np.ndarray, rng: Optional[np.random.Generator] = None):
        """Per-chunk sampling (ref dataset_loader.py:436-464): per subject,
        ``bs`` window indices without replacement; optional cross-subject
        permutation of the first ``bs * shuffle_percentage`` columns.

        ``rng``: another numpy Generator to draw from (the fold-parallel
        trainer keeps one sampling stream per fold); the dataset's own by
        default."""
        rng = rng if rng is not None else self.rng
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

    def iter_subject_windows(self) -> Iterator[Tuple]:
        """Per-(subject, chunk) windows for the regression evaluation suite:
        yields ``(sub, story_key, eeg [n, wl, 64], features dict)``.  (The
        reference's regression evals expect 5-tuples its loader never
        yields; this is the working equivalent the JAX package uses.)"""
        for key in self.batches_keys:
            chunk = self.chunks[key]
            if "eeg" not in chunk:
                continue
            feats = {f: chunk[f] for f in self.features_to_load if f in chunk}
            for si, sub in enumerate(chunk["sub"]):
                yield sub, key, chunk["eeg"][si], feats

    # -- host-side iteration (reference-compatible) -------------------------

    def _augment(self, eeg_batch: np.ndarray) -> np.ndarray:
        """The augmentations on one host batch, keyed by a draw from
        ``self.rng`` (the JAX package draws its PRNG key there too, so the
        two streams stay aligned)."""
        if not self.data_augmentation:
            return eeg_batch
        if self._aug_fn is None:
            from transformer_clip_eeg_tpu_torch.ops.augment import make_augmentation_fn

            self._aug_fn = make_augmentation_fn(
                self.data_augmentation, self.data_augmentation_probability
            )
        key = int(self.rng.integers(0, 2**31 - 1))
        x = torch.from_numpy(np.asarray(eeg_batch, np.float32))
        return self._aug_fn(key, x).numpy()

    def _mixup(self, eeg: np.ndarray) -> np.ndarray:
        """Cross-subject mixup of a chunk ``[n_subs, n_win, wl, 64]`` (ref
        dataset_loader.py:333-356): per (subject, window), with probability
        ``data_augmentation_probability``, the convex combination with the
        same window of a random subject, weight ~ U(0, 1)."""
        if not self.addEEG:
            return eeg
        n_subs, n_win = eeg.shape[0], eeg.shape[1]
        probabilities = self.rng.random((n_subs, n_win))
        alphas = self.rng.random((n_subs, n_win))
        do_aug = probabilities < self.data_augmentation_probability
        m = 1 - alphas * do_aug
        partner = self.rng.integers(0, n_subs, (n_subs, n_win))
        partner_eeg = eeg[partner, np.arange(n_win)[None, :]]
        return m[..., None, None] * eeg + (1 - m[..., None, None]) * partner_eeg

    def __iter__(self) -> Iterator[Tuple]:
        """Reference-compatible epoch iterator yielding ``(eeg_batch [bs, wl,
        64], [speech features...], ids [bs], subs [bs])`` (ref
        dataset_loader.py:392-422); the chunk order is shuffled for the next
        epoch when the last chunk starts, as the reference does."""
        for pos, key in enumerate(list(self.batches_keys)):
            chunk = self.chunks[key]
            if "eeg" not in chunk or not self.features_to_load:
                continue
            speech = [chunk[f] for f in self.features_to_load if f in chunk]
            eeg = self._mixup(chunk["eeg"])
            ids = np.array(chunk["identifiers"])
            subs = np.array(chunk["sub"])
            if pos == len(self.batches_keys) - 1:
                self.on_epoch_end()
            idx_per_batch, subs_per_batch = self.create_eeg_indices(eeg)
            for i in range(eeg.shape[0]):
                idx = idx_per_batch[i, :]
                eeg_batch = np.squeeze(eeg[subs_per_batch[i], idx, :, :])
                eeg_batch = self._augment(eeg_batch)
                speech_batch = [feature[idx, :, :] for feature in speech]
                yield eeg_batch, speech_batch, ids[idx], subs[subs_per_batch[i]]

    def on_epoch_end(self):
        self.rng.shuffle(self.batches_keys)


# the reference's name for the class
EEGDatasetSimdata = EEGWindowDataset
