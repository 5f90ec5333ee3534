"""Device-resident chunk store: batches gathered on the device, not the host.

Counterpart of ``transformer_clip_eeg_tpu/train/device_data.py``.  The host
batch path (``train/loop.batch_iterator``) gathers each batch on the host and
copies it to the card, so a story chunk shared by ``n_subs`` subjects sends
its speech features ``n_subs`` times an epoch.  Here each story chunk (EEG
``[n_subs, n_win, wl, 64]``, speech ``[n_win, wl, F]``, ids) is padded to a
bucket shape, copied to the card once, and every batch is a row gather on
the card from two index vectors (:func:`gather_batch`).

Padding is invisible to sampling: chunks are padded to buckets of
``SUBS_BUCKET`` subjects × ``WIN_BUCKET`` windows, indices are drawn on the
host over the real window and subject counts only, so padded rows are never
read; padded ids map to memory-bank row 0 (the reference's bank has
``bank_size + 1`` rows and row 0 belongs to no segment).  With ``addEEG``
the mixup partners' subjects are drawn on the host too, per chunk, from the
real subjects only, and gathered on the card.

The next chunk's upload runs on a background thread while the current chunk
trains.  On the card it is staged in one pinned host buffer per store
(reused, grown when a larger chunk comes) and copied on a side CUDA stream;
:meth:`DeviceChunkStore.get` makes the consumer's stream wait for the
upload's event and records the chunk's tensors on that stream, so the
allocator cannot hand their memory out while queued work still reads them.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.models.registry import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ALIGN = 64  # bytes between the staged arrays of one chunk
SUBS_BUCKET = 8  # a chunk's subject axis is padded to a multiple of this
WIN_BUCKET = 64  # and its window axis to a multiple of this


def _bucket(n: int, step: int) -> int:
    return ((n + step - 1) // step) * step


class DeviceChunkStore:
    """Pads, uploads and iterates story chunks resident on ``device``.

    With ``prefetch=True`` (the default) the next chunk's pad and upload run
    on one background thread while the current chunk trains.  Index sampling
    stays on the calling thread, so the draws from the dataset's ``rng`` (and
    so the batches) are the same with prefetch on or off.

    Residency: with ``max_resident=None`` chunks stay resident up to a byte
    budget of ``budget_frac`` of the card's free memory at construction
    (``torch.cuda.mem_get_info``), counted together with every other budgeted
    store on the same card (the train and validation stores share it); when
    ``ranks_on_device`` data-parallel ranks share the card, each holding the
    whole store (replicated, as JAX's chunks are on a mesh), each takes that
    share of the budget.  On
    the CPU there is no budget and a count cap of 2 applies, as in the JAX
    package on CPU test meshes; ``max_resident=N`` forces a count cap.  When
    a chunk does not fit, the resident chunk whose next use in the epoch walk
    is farthest away is evicted (Belady order, fed by the epoch iterators
    through :meth:`_set_upcoming`), never the chunk in use.
    ``store_dtype="bfloat16"`` rounds the padded chunk to bf16 on the host
    (round to nearest even), which halves the upload bytes and the residency;
    :func:`gather_batch` casts the gathered batch back to f32.

    ``stats`` counts uploads, bytes and seconds (the finished transfers) and
    ``wait_s``, the time the consumer spent in :meth:`get`.
    """

    # Residency ledger per device: several stores on one card cap their
    # combined residency.  Entry: {"resident": bytes, "cap": bytes, "stores":
    # live budgeted stores}.  Each store's share is held in a cell that a
    # ``weakref.finalize`` releases if the store is dropped without
    # ``release()``; an entry whose last store dies is removed.
    _ledger_lock = threading.Lock()
    _ledger: Dict[tuple, Dict[str, int]] = {}

    def __init__(
        self,
        dataset: EEGWindowDataset,
        device="cuda",
        max_resident: Optional[int] = None,
        prefetch: bool = True,
        budget_frac: float = 0.75,
        store_dtype: str = "float32",
        ranks_on_device: int = 1,
    ):
        self.dataset = dataset
        if not dataset.features_to_load:
            raise ValueError(
                "dataset has no stimulus features — no audio files matched "
                "the requested stimulus feature (check --stimulus_features "
                "against the *_-_<feature>.npy files in "
                "derivatives/preprocessed_stimuli)"
            )
        if store_dtype not in _DTYPES:
            raise ValueError(f"store_dtype must be float32 or bfloat16, got {store_dtype}")
        self.device = resolve_device(device)
        self.feature = dataset.features_to_load[0]
        self.prefetch = prefetch
        self.store_dtype = _DTYPES[store_dtype]
        self.stats = {"uploads": 0, "upload_bytes": 0, "upload_s": 0.0, "wait_s": 0.0}
        self._device_key = (self.device.type, self.device.index or 0)
        self.budget_bytes: Optional[int] = None
        if max_resident is None:
            self.budget_bytes = self._auto_budget(budget_frac / ranks_on_device)
            if self.budget_bytes is None:
                max_resident = 2
        if max_resident is not None and prefetch:
            # one slot for the chunk in use, one for the incoming chunk
            max_resident = max(max_resident, 2)
        self.max_resident = max_resident
        self._resident: Dict[str, Tuple] = {}
        self._events: Dict[str, torch.cuda.Event] = {}
        self._ledger_cell = {"bytes": 0}
        if self.budget_bytes is not None:
            key = self._device_key
            with DeviceChunkStore._ledger_lock:
                entry = DeviceChunkStore._ledger.setdefault(
                    key, {"resident": 0, "cap": 0, "stores": 0})
                entry["cap"] = max(entry["cap"], self.budget_bytes)
                entry["stores"] += 1
            weakref.finalize(self, DeviceChunkStore._ledger_drop_store, key,
                             self._ledger_cell)
        self._sizes: Dict[str, int] = {}
        self._resident_bytes = 0
        self._futures: Dict[str, Future] = {}
        self._lock = threading.Lock()
        # one upload at a time: the staging buffer and the copy stream are shared
        self._upload_lock = threading.Lock()
        self._staging: Optional[torch.Tensor] = None
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._in_use: Optional[str] = None
        # epoch-walk lookahead for Belady eviction: key -> steps until next use
        self._upcoming: Dict[str, int] = {}

    def snapshot_stats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.stats)

    # -- the per-device ledger ----------------------------------------------

    def _ledger_add(self, nbytes: int) -> None:
        with DeviceChunkStore._ledger_lock:
            entry = DeviceChunkStore._ledger.get(self._device_key)
            if entry is not None:
                entry["resident"] += nbytes
                self._ledger_cell["bytes"] += nbytes

    def _ledger_sub(self, nbytes: int) -> None:
        with DeviceChunkStore._ledger_lock:
            entry = DeviceChunkStore._ledger.get(self._device_key)
            if entry is not None:
                entry["resident"] = max(0, entry["resident"] - nbytes)
                self._ledger_cell["bytes"] = max(0, self._ledger_cell["bytes"] - nbytes)

    @classmethod
    def _ledger_drop_store(cls, key: tuple, cell: Dict[str, int]) -> None:
        """weakref.finalize target: reclaim a dead store's resident bytes and
        retire its count; the entry goes with the last budgeted store."""
        with cls._ledger_lock:
            entry = cls._ledger.get(key)
            if entry is None:
                return
            entry["resident"] = max(0, entry["resident"] - cell["bytes"])
            cell["bytes"] = 0
            entry["stores"] -= 1
            if entry["stores"] <= 0:
                del cls._ledger[key]

    def _auto_budget(self, frac: float) -> Optional[int]:
        """``frac`` of the card's free memory now; None on the CPU."""
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free * frac) if free > 0 else None

    # -- residency ----------------------------------------------------------

    def release(self) -> None:
        """Drop every resident chunk, its ledger share, the staging buffer and
        the prefetch thread, so the memory is free for the eval suite."""
        for fut in list(self._futures.values()):
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - an upload that failed holds nothing
                pass
        with self._lock:
            self._futures.clear()
            self._ledger_sub(self._resident_bytes)
            self._resident.clear()
            self._events.clear()
            self._sizes.clear()
            self._resident_bytes = 0
            self._in_use = None
            self._staging = None
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _set_upcoming(self, keys_ahead) -> None:
        with self._lock:
            self._upcoming = {k: i for i, k in enumerate(keys_ahead)}

    def _host_buffers(self, shapes, dtypes):
        """Host tensors for one chunk: views of the reused pinned staging
        buffer on the card, new tensors on the CPU (they are the store)."""
        if self.device.type != "cuda":
            return [torch.empty(s, dtype=d) for s, d in zip(shapes, dtypes)]
        sizes = [int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                 for s, d in zip(shapes, dtypes)]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += _bucket(n, _ALIGN)
        if self._staging is None or self._staging.numel() < total:
            self._staging = None  # free the old buffer before pinning a larger one
            self._staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        return [self._staging[o:o + n].view(d).view(s)
                for o, n, s, d in zip(offsets, sizes, shapes, dtypes)]

    def _pad_chunk(self, key: str):
        """The chunk padded to its bucket shape in host tensors: EEG and
        speech in the store's dtype (zeros outside the real rows), ids int64
        (padded ids → bank row 0)."""
        chunk = self.dataset.chunks[key]
        eeg = chunk["eeg"]  # [n_subs, n_win, wl, 64]
        speech = chunk[self.feature]  # [n_win, wl, F]
        ids = np.asarray(chunk["identifiers"], np.int64)
        n_subs, n_win = eeg.shape[0], eeg.shape[1]
        ps = _bucket(n_subs, SUBS_BUCKET)
        pw = _bucket(n_win, WIN_BUCKET)
        dt = self.store_dtype
        eeg_p, speech_p, ids_p = self._host_buffers(
            [(ps, pw) + eeg.shape[2:], (pw,) + speech.shape[1:], (pw,)], [dt, dt, torch.int64])
        # copy_ rounds f32 to bf16 to nearest even, as ml_dtypes does
        eeg_p[:n_subs, :n_win].copy_(torch.from_numpy(np.asarray(eeg, np.float32)))
        eeg_p[:n_subs, n_win:].zero_()
        eeg_p[n_subs:].zero_()
        speech_p[:n_win].copy_(torch.from_numpy(np.asarray(speech, np.float32)))
        speech_p[n_win:].zero_()
        ids_p[:n_win].copy_(torch.from_numpy(ids))
        ids_p[n_win:].zero_()
        return eeg_p, speech_p, ids_p, n_subs, n_win

    def _upload(self, key: str):
        """Pad ``key`` and copy it to the device; returns the entry, its
        event (None on the CPU) and the bytes moved."""
        with self._upload_lock:
            eeg, speech, ids, n_subs, n_win = self._pad_chunk(key)
            host = (eeg, speech, ids)
            nbytes = sum(t.numel() * t.element_size() for t in host)
            if self._stream is None:
                return (eeg, speech, ids, n_subs, n_win), None, nbytes
            with torch.cuda.stream(self._stream):
                dev = tuple(t.to(self.device, non_blocking=True) for t in host)
                event = torch.cuda.Event()
                event.record(self._stream)
            # the staging buffer is reused by the next upload, and upload_s
            # measures the finished transfer
            event.synchronize()
        return dev + (n_subs, n_win), event, nbytes

    def _insert(self, key: str) -> None:
        """Pad, upload and make ``key`` resident (any thread)."""
        t0 = time.perf_counter()
        entry, event, nbytes = self._upload(key)
        with self._lock:
            self.stats["uploads"] += 1
            self.stats["upload_bytes"] += nbytes
            self.stats["upload_s"] += time.perf_counter() - t0
            if key in self._resident:  # re-insert: replace, don't double-count
                self._drop(key)

            def over_cap() -> bool:
                if self.max_resident is not None and len(self._resident) >= self.max_resident:
                    return True
                if self.budget_bytes is None:
                    return False
                if self._resident_bytes + nbytes > self.budget_bytes:
                    return True
                # combined residency of every store on this card, enforced
                # softly: a store evicts only its own chunks, so the total
                # can overshoot the cap by one store's working set
                with DeviceChunkStore._ledger_lock:
                    led = DeviceChunkStore._ledger.get(self._device_key)
                    return led is not None and led["resident"] + nbytes > led["cap"]

            if over_cap() and self.budget_bytes is not None and \
                    not getattr(self, "_evict_warned", False):
                self._evict_warned = True
                print(
                    "DeviceChunkStore: working set exceeds the "
                    f"{self.budget_bytes / 2**30:.1f} GB device budget — epochs will "
                    "re-upload evicted chunks (Belady order bounds the thrash to the "
                    "overflow). If inputs tolerate bf16, --chunk_store_dtype bfloat16 "
                    "halves residency and upload bytes.",
                    flush=True,
                )
            while self._resident and over_cap():
                # the chunk needed farthest in the future (unknown = farthest),
                # never the one the loop is consuming
                evictable = [k for k in self._resident if k != self._in_use]
                if not evictable:
                    break
                self._drop(max(evictable, key=lambda k: self._upcoming.get(k, 1 << 30)))
            self._resident[key] = entry
            if event is not None:
                self._events[key] = event
            self._sizes[key] = nbytes
            self._ledger_add(nbytes)
            self._resident_bytes += nbytes

    def _drop(self, key: str) -> None:
        """Forget a resident chunk (caller holds ``_lock``)."""
        self._ledger_sub(self._sizes[key])
        self._resident_bytes -= self._sizes.pop(key)
        del self._resident[key]
        self._events.pop(key, None)

    def get(self, key: str):
        """The resident ``(eeg, speech, ids, n_subs, n_win)`` of a chunk,
        ready for work queued on the caller's current stream."""
        t0 = time.perf_counter()
        fut = self._futures.pop(key, None)
        if fut is not None:
            fut.result()  # re-raises a background upload's error here
        with self._lock:
            entry = self._resident.get(key)
            self._in_use = key
        if entry is None:
            self._insert(key)
        with self._lock:
            entry = self._resident[key]
            event = self._events.get(key)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in entry[:3]:
                t.record_stream(stream)
        with self._lock:
            self.stats["wait_s"] += time.perf_counter() - t0
        return entry

    def prefetch_key(self, key: str) -> None:
        """Start uploading ``key`` on the background thread (idempotent)."""
        with self._lock:
            if key in self._resident or key in self._futures:
                return
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="chunk-prefetch")
            self._futures[key] = self._pool.submit(self._insert, key)

    # -- epoch iteration -----------------------------------------------------

    def _epoch_keys(self, rng: np.random.Generator, shuffle: bool) -> list:
        # filtered before the shuffle, as the JAX store does
        keys = [k for k in self.dataset.batches_keys
                if "eeg" in self.dataset.chunks[k] and self.feature in self.dataset.chunks[k]]
        if shuffle:
            rng.shuffle(keys)
        return keys

    def _walk(self, rng, shuffle: bool):
        """``(key, idx [n, bs], subs [n, bs], entry)`` per chunk of the epoch,
        with the next chunk's upload started once this one is resident."""
        keys = self._epoch_keys(rng, shuffle)
        for j, key in enumerate(keys):
            self._set_upcoming(keys[j:])
            idx_m, subs_m = self.dataset.create_eeg_indices(self.dataset.chunks[key]["eeg"])
            entry = self.get(key)
            if self.prefetch and j + 1 < len(keys):
                self.prefetch_key(keys[j + 1])
            yield key, idx_m, subs_m, entry

    def _partners(self, rng, subs_m: np.ndarray, n_subs: int, add_eeg: bool) -> np.ndarray:
        """The mixup partners' subjects ``[n, bs]``, drawn from ``rng`` over
        the chunk's real subjects, never its padding (``subs_m`` again
        without mixup), where the JAX store draws them."""
        if add_eeg:
            return rng.integers(0, n_subs, subs_m.shape)
        return subs_m

    def epoch_batches(self, rng: Optional[np.random.Generator] = None,
                      shuffle: bool = True, add_eeg: bool = False) -> Iterator[Tuple]:
        """``(eeg_chunk, speech_chunk, ids_chunk, idx, subs, partner)`` per
        batch: chunk tensors resident on the device, index vectors int64
        numpy arrays."""
        rng = rng or self.dataset.rng
        for _key, idx_m, subs_m, (eeg_d, speech_d, ids_d, n_subs, _) in self._walk(rng, shuffle):
            partner_m = self._partners(rng, subs_m, n_subs, add_eeg)
            for i in range(n_subs):
                yield (eeg_d, speech_d, ids_d, idx_m[i].astype(np.int64),
                       subs_m[i].astype(np.int64), partner_m[i].astype(np.int64))

    def epoch_chunk_batches(self, rng: Optional[np.random.Generator] = None,
                            shuffle: bool = True, add_eeg: bool = False) -> Iterator[Tuple]:
        """Per chunk ``(eeg_chunk, speech_chunk, ids_chunk, idx_mat [n, bs],
        subs_mat [n, bs], partner_mat [n, bs], n)``: the chunk's whole batch
        list, which the trainer splits into the bucket-aligned prefix and the
        tail."""
        rng = rng or self.dataset.rng
        for _key, idx_m, subs_m, (eeg_d, speech_d, ids_d, n_subs, _) in self._walk(rng, shuffle):
            partner_m = self._partners(rng, subs_m, n_subs, add_eeg)
            yield (eeg_d, speech_d, ids_d, np.asarray(idx_m, np.int64),
                   np.asarray(subs_m, np.int64), np.asarray(partner_m, np.int64),
                   idx_m.shape[0])


def gather_batch(
    eeg_chunk: torch.Tensor,
    speech_chunk: torch.Tensor,
    ids_chunk: torch.Tensor,
    idx: torch.Tensor,
    subs: torch.Tensor,
    add_eeg: bool = False,
    partner: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One batch by row gathers on the chunk's device; with ``add_eeg`` also
    ``partner_eeg``, the same windows of the subjects ``partner``.  bf16
    chunks are cast back to f32 after the gather, so the cast costs one
    batch, not one chunk, and everything downstream keeps f32."""
    def f32(x):
        return x if x.dtype == torch.float32 else x.float()

    batch = {
        "eeg": f32(eeg_chunk[subs, idx]),
        "speech": f32(speech_chunk[idx]),
        "ids": ids_chunk[idx],
    }
    if add_eeg:
        batch["partner_eeg"] = f32(eeg_chunk[partner, idx])
    return batch
