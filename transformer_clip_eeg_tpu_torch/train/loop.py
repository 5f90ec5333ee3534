"""The training driver: epoch loop, early stopping, checkpointing, logging.

Counterpart of ``transformer_clip_eeg_tpu/train/loop.py`` (ref
``train_clip_final.py:443-540``): auto-resume from ``checkpoints/``, warmup
epochs backprop ``loss_ce`` only, a per-epoch scheduler step, validation in
eval mode (the memory bank still updating), best-on-val-CE checkpointing
with the in-memory best restored at the end, and the same ``loss.txt``
lines.

Two batch paths, chosen by ``data_mode``: ``"device"`` keeps the story
chunks resident on the device and gathers each batch there from index
vectors (``train/device_data.py``); ``"host"`` gathers each batch on the
host in numpy and copies it to the card from a ring of pinned buffers, two
batches ahead.  ``"auto"`` is the device store on a CUDA device and the host
path on the CPU.  Both draw the dataset's ``rng`` in the same order (the
``addEEG`` mixup partners included), so they train on the same batches; the
train step mixes and augments them on the device (``train/steps.py``).
With ``profile_dir`` the first epoch runs under ``torch.profiler`` and its
Chrome trace is written there.

``compute_dtype="bfloat16"`` trains in bf16 as the JAX trainer does: the
train steps cast their batch (``train/steps.py``), the validation steps and
everything after training run float32.

``fit`` resumes from the port's checkpoint, else from the reference's
``checkpoints/model.ckpt`` (its weights, bank and batch-norm statistics; the
optimizer and scheduler start fresh, as in JAX).

Data parallelism (``n_data_shards``, JAX's trainer under a ``'data'``
mesh): the trainer of each rank takes the rank's :class:`~transformer_clip_
eeg_tpu_torch.parallel.mesh.Mesh`.  Every rank builds the same datasets and
draws the same batches; the steps take the rank's rows (``train/steps.py``).
Each rank holds the whole chunk store (its budget shared with the ranks on
its card) and a replica of the model and optimizer, made rank 0's at init
and checked equal by checksum at the end of ``fit``.  The validation losses
are averaged over the ranks, so every rank keeps the same best state.  Rank
0 alone names the results directory (broadcast to the others), writes
``args.txt``, ``loss.txt`` and the checkpoints, and profiles.

Not ported, raising ``NotImplementedError`` (ROADMAP.md): a ``prng_impl``
other than the default.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.models.registry import (
    build_model_from_config,
    resolve_device,
)
from transformer_clip_eeg_tpu_torch.parallel.collectives import (
    all_reduce_mean_,
    broadcast_object,
)
from transformer_clip_eeg_tpu_torch.parallel.mesh import attach, shard_batch
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.schedulers import make_scheduler
from transformer_clip_eeg_tpu_torch.train.state import (
    check_replicas,
    count_params,
    make_optimizer,
    replicate_state,
    set_learning_rate,
)
from transformer_clip_eeg_tpu_torch.train import device_data
from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore
from transformer_clip_eeg_tpu_torch.train.steps import (
    COMPUTE_DTYPES,
    chunk_eval_step,
    chunk_train_step,
    eval_step,
    train_step,
)
from transformer_clip_eeg_tpu_torch.utils import tracing


PROFILE_TRACE = "epoch0_trace.json"  # the trace's name in profile_dir


def printf(statement: str, file: str) -> None:
    """print + append to file (ref train_clip_final.py:31-34)."""
    print(statement)
    with open(file, "a") as f:
        f.write(statement + "\n")


def batch_iterator(
    dataset: EEGWindowDataset,
    add_eeg: bool = False,
    rng: Optional[np.random.Generator] = None,
    shuffle_chunks: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of fixed-shape numpy batches from the chunked dataset: per
    chunk, the reference's index sampling (per-subject without replacement
    and a cross-subject column shuffle, ref dataset_loader.py:436-464), then
    a host gather to ``[bs, wl, C]``.  With ``add_eeg`` a partner batch (the
    same windows from uniformly random subjects) is gathered too."""
    rng = rng or dataset.rng
    keys = list(dataset.batches_keys)
    if shuffle_chunks:
        rng.shuffle(keys)
    if not dataset.features_to_load:
        raise ValueError(
            "dataset has no stimulus features — no audio files matched the "
            "requested stimulus feature (check --stimulus_features against "
            "the *_-_<feature>.npy files in derivatives/preprocessed_stimuli)"
        )
    if not dataset.batches_keys:
        raise ValueError(
            "dataset produced zero story chunks — every story was shorter "
            "than hop*(batch_size-1)+window samples; reduce --batch_size or "
            "provide longer recordings"
        )
    feature = dataset.features_to_load[0]
    for key in keys:
        chunk = dataset.chunks[key]
        if "eeg" not in chunk or feature not in chunk:
            continue
        eeg = chunk["eeg"]  # [n_subs, n_win, wl, 64]
        speech = chunk[feature]  # [n_win, wl, F]
        ids = np.asarray(chunk["identifiers"])
        idx_per_batch, subs_per_batch = dataset.create_eeg_indices(eeg)
        n_subs = eeg.shape[0]
        for i in range(n_subs):
            idx = idx_per_batch[i]
            batch = {
                "eeg": eeg[subs_per_batch[i], idx].astype(np.float32),
                "speech": speech[idx].astype(np.float32),
                "ids": ids[idx].astype(np.int64),
            }
            if add_eeg:
                partner = rng.integers(0, n_subs, idx.shape[0])
                batch["partner_eeg"] = eeg[partner, idx].astype(np.float32)
            yield batch


def prefetch_to_device(
    iterator: Iterator[Dict[str, np.ndarray]], device: torch.device, size: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches on ``device``, ``size`` ahead.  On the card each array is
    staged in pinned host memory and copied with ``non_blocking=True``, so
    the copy overlaps the step before it; the pinned buffers form a ring
    ``size + 1`` deep, and a slot is refilled only after the event recorded
    behind its last copy has completed."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        return
    ring: List[Dict[str, torch.Tensor]] = [{} for _ in range(size + 1)]
    events: List[Optional[torch.cuda.Event]] = [None] * (size + 1)
    queue: collections.deque = collections.deque()

    def put(batch, slot: int):
        if events[slot] is not None:
            events[slot].synchronize()  # the copy that read this slot is done
        bufs, out = ring[slot], {}
        for k, v in batch.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            buf = bufs.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = bufs[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            out[k] = buf.to(device, non_blocking=True)
        events[slot] = torch.cuda.Event()
        events[slot].record()
        return out

    for i, batch in enumerate(iterator):
        queue.append(put(batch, i % (size + 1)))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def device_indices(device: torch.device, *mats: np.ndarray) -> List[torch.Tensor]:
    """Index matrices as int64 on ``device`` (from pinned memory on the
    card, without blocking)."""
    out = [torch.from_numpy(np.ascontiguousarray(m, np.int64)) for m in mats]
    if device.type == "cuda":
        out = [t.pin_memory().to(device, non_blocking=True) for t in out]
    return out


def step_seconds(spans) -> List[float]:
    """The step times of an epoch's spans: the intervals between the
    ``train.step`` starts, the last one closed by the end of the drain
    (``train.block``)."""
    starts = sorted(s.t0_ns for s in spans if s.name == tracing.STEP)
    if not starts:
        return []
    end = max(s.t1_ns for s in spans if s.name == tracing.BLOCK)
    return list(np.diff(starts + [end]) * 1e-9)


def snapshot(model, optimizer) -> Dict[str, Any]:
    """A deep copy of the model (parameters and bank) and the optimizer."""
    def clone(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v
    return {
        "model": {k: clone(v) for k, v in model.state_dict().items()},
        "optimizer": {k: clone(v) for k, v in optimizer.state_dict().items()},
    }


def restore(model, optimizer, snap: Dict[str, Any]) -> None:
    """Load a :func:`snapshot` back into ``model`` and ``optimizer``."""
    model.load_state_dict(snap["model"])
    optimizer.load_state_dict(snap["optimizer"])


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (see ROADMAP.md for "
        "the modules still to port)"
    )


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for the options the port does not run yet,
    and ``ValueError`` for a compute dtype the JAX CLI does not offer or a
    batch that does not divide over ``n_data_shards`` ranks."""
    if cfg.n_data_shards < 0 or (cfg.n_data_shards
                                 and cfg.batch_size % cfg.n_data_shards):
        raise ValueError(f"batch_size {cfg.batch_size} must divide over n_data_shards="
                         f"{cfg.n_data_shards} ranks (a non-negative count)")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.prng_impl != "rbg":
        raise _not_ported(f"prng_impl={cfg.prng_impl!r} (the port's dropout masks come "
                          "from ops/dropout.py's counter hash)")


class Trainer:
    """End-to-end trainer assembled from a :class:`TrainConfig`, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        config: TrainConfig,
        train_dataset: EEGWindowDataset,
        val_dataset: Optional[EEGWindowDataset] = None,
        results_dir: Optional[str] = None,
        device="cuda",
        mesh=None,
        profile_dir: Optional[str] = None,
    ):
        check_supported(config)
        if config.n_data_shards != (mesh.n_data if mesh is not None else 0):
            raise ValueError(
                f"n_data_shards={config.n_data_shards} needs a mesh of as many ranks (got "
                f"{mesh}): cli.main starts them, or torchrun with parallel.make_mesh")
        self.cfg = cfg = config
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.is_writer  # rank 0 writes every file
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.profile_dir = profile_dir  # a torch.profiler trace of epoch 0
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        if results_dir is None:
            results_dir = os.path.join(
                cfg.results_folder, cfg.results_dir_name(time.strftime("%Y_%m_%d_%H_%M_%S")))
            if mesh is not None:  # named by rank 0's clock
                results_dir = broadcast_object(results_dir, mesh)
        self.results_dir = results_dir
        self.checkpoint_dir = os.path.join(self.results_dir, "checkpoints")
        if self.is_writer:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.loss_file = os.path.join(self.results_dir, "loss.txt")

        # memory-bank sizing (ref train_clip_final.py:367-372); the val set
        # restarts ids at 1 and shares the bank, so size by the larger
        bank_size = train_dataset.get_number_of_stimuli_segments()
        if val_dataset is not None:
            bank_size = max(bank_size, val_dataset.get_number_of_stimuli_segments())
        cfg.bank_size = bank_size  # persisted so serving rebuilds the head
        if self.is_writer:
            cfg.save(os.path.join(self.results_dir, "args.txt"))

        # the device-resident chunk path (train/device_data.py): on a CUDA
        # device by default, as the JAX package uses it on a TPU.  There is
        # no fallback: a store that cannot upload fails the run
        if cfg.data_mode not in ("auto", "host", "device"):
            raise ValueError(f"data_mode must be auto, host or device, got {cfg.data_mode!r}")
        self.device_data = (cfg.data_mode == "device"
                            or (cfg.data_mode == "auto" and self.device.type == "cuda"))
        if self.device_data:
            store_kw = dict(device=self.device, store_dtype=cfg.chunk_store_dtype,
                            budget_frac=cfg.chunk_budget_frac,
                            ranks_on_device=mesh.ranks_on_device if mesh is not None else 1)
            self.chunk_store = DeviceChunkStore(train_dataset, **store_kw)
            if val_dataset is not None:
                self.val_chunk_store = DeviceChunkStore(val_dataset, **store_kw)

        # the JAX trainer draws one example batch to initialise its state; the
        # same draw here checks that the dataset yields batches and leaves its
        # sampling stream where the JAX trainer leaves it
        next(batch_iterator(train_dataset, cfg.addEEG_b))
        self.model = build_model_from_config(cfg, bank_size, self.device, seed=cfg.seed)
        attach(self.model, mesh)
        self.optimizer = make_optimizer(
            self.model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
            cfg.beta2, cfg.weight_decay, cfg.amsgrad_b,
        )
        self.scheduler = make_scheduler(cfg.lr_scheduler, cfg.learning_rate,
                                        cfg.step_size_scheduler)
        if mesh is not None:
            replicate_state(mesh, self.model, self.optimizer)
            self.log(mesh.describe())
        self.log(f"number of parameters {count_params(self.model)}")

    # -- helpers ------------------------------------------------------------

    def log(self, statement: str) -> None:
        """A ``loss.txt`` line, printed and written by rank 0 alone."""
        if self.is_writer:
            printf(statement, self.loss_file)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batches(self, dataset, add_eeg: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
        """The host path's batches on the device; under a mesh this rank's
        rows of each (cut on the host, before the copy)."""
        batches = batch_iterator(dataset, add_eeg)
        if self.mesh is not None:
            batches = (shard_batch(self.mesh, b) for b in batches)
        return prefetch_to_device(batches, self.device)

    def _train_batches(self, warmup: bool):
        """One training epoch: yields ``(losses, pairs)`` per item.  In
        device mode an item is a chunk's bucket-aligned prefix (its mean
        losses, ``n_scan * bs`` pairs) or one batch of its tail, as the JAX
        trainer's scan and per-batch steps."""
        cfg, seed = self.cfg, self._train_seed
        step_kw = dict(model_arch=cfg.model_arch, augmentations=cfg.augmentations,
                       augmentation_probability=cfg.data_augmentation_percentage,
                       add_eeg=cfg.addEEG_b, compute_dtype=cfg.compute_dtype)
        if self.device_data:
            for eeg_c, sp_c, ids_c, idx_m, subs_m, partner_m, n in \
                    self.chunk_store.epoch_chunk_batches(add_eeg=cfg.addEEG_b):
                bs = idx_m.shape[1]
                n_scan = (n // device_data.SUBS_BUCKET) * device_data.SUBS_BUCKET
                idx_d, subs_d, partner_d = device_indices(self.device, idx_m, subs_m, partner_m)

                def step(i):
                    return chunk_train_step(self.model, self.optimizer, eeg_c, sp_c, ids_c,
                                            idx_d[i], subs_d[i], seed, warmup,
                                            partner=partner_d[i], **step_kw)

                if n_scan:
                    scanned = [step(i) for i in range(n_scan)]
                    yield ({k: torch.stack([s[k] for s in scanned]).mean() for k in scanned[0]},
                           n_scan * bs)
                for i in range(n_scan, n):
                    yield step(i), bs
        else:
            for batch in self._batches(self.train_dataset, cfg.addEEG_b):
                yield (train_step(self.model, self.optimizer, batch, seed, warmup, **step_kw),
                       cfg.batch_size)

    def release_device_data(self) -> None:
        """Drop the chunk stores' resident chunks, so the device memory they
        held is free for the eval suite's embedding extraction."""
        for store in (getattr(self, "chunk_store", None),
                      getattr(self, "val_chunk_store", None)):
            if store is not None:
                store.release()

    def release_host_data(self) -> None:
        """Also free the ingested datasets' host arrays (the eval suite
        ingests its own splits)."""
        self.release_device_data()
        for ds in (self.train_dataset, self.val_dataset):
            if ds is not None and hasattr(ds, "chunks"):
                ds.chunks.clear()
        self.train_dataset = None
        self.val_dataset = None

    def _start_profile(self):
        """A running ``torch.profiler`` over the host and, on the card, the
        device."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop ``prof`` and write its Chrome trace to
        ``<profile_dir>/epoch0_trace.json``."""
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir, PROFILE_TRACE))

    def _format_loss_line(self, epoch: int, n_batches: int, losses) -> str:
        """The reference's per-100-batch loss line (ref :494-500); the KLD
        heads report their prior and KL terms."""
        if self.cfg.is_kld:
            return (
                f"train epoch {epoch} batch {n_batches} loss_ce "
                f"{float(losses['loss_ce'])} loss pmu2 "
                f"{float(losses['log_pmu2'])}, log z2: "
                f"{float(losses['kld_z2'])}"
            )
        return (
            f"train epoch {epoch} batch {n_batches} loss_ce "
            f"{float(losses['loss_ce'])} loss average eeg "
            f"{float(losses['loss_avg'])}"
        )

    # -- training -------------------------------------------------------------

    def fit(self) -> Dict[str, Any]:
        cfg = self.cfg
        # auto-resume (ref train_clip_final.py:443-449): the port's own
        # checkpoint, else the reference's model.ckpt (weights alone)
        restored = ckpt_lib.restore_checkpoint(self.checkpoint_dir, self.model,
                                               self.optimizer, self.scheduler)
        if restored is None:
            restored = ckpt_lib.restore_torch_checkpoint(self.checkpoint_dir, self.model)
        if self.mesh is not None:  # every rank read the same files; rank 0's wins
            replicate_state(self.mesh, self.model, self.optimizer)
        if restored is not None:
            self.log(f"loaded model from {self.checkpoint_dir}")
        else:
            self.log(f"no model found at {self.checkpoint_dir}, training from scratch")

        self._train_seed = cfg.seed + 1  # the JAX trainer's PRNGKey(seed + 1)
        # a resumed run starts from the recorded best val CE, so its first
        # (possibly worse) epoch cannot overwrite the saved best
        best_loss = float("inf")
        if restored is not None:
            meta = ckpt_lib.load_best_meta(self.checkpoint_dir)
            if meta is not None:
                best_loss = meta
        best_epoch = 0
        best_state = snapshot(self.model, self.optimizer)
        history: List[Dict[str, Any]] = []
        self.history = history  # per epoch, filled as the epochs run
        # without a validation set there is no best to track: keep the final
        # state (val losses are NaN and 'nan < inf' never updates the best)
        track_best = self.val_dataset is not None

        for epoch in range(cfg.epochs):
            # early stopping (ref :463-468)
            if track_best and epoch > best_epoch + cfg.patience and epoch > cfg.warmup_epochs:
                restore(self.model, self.optimizer, best_state)
                self.log(f"early stopping at epoch {epoch}")
                break

            warmup = epoch < cfg.warmup_epochs
            profiler = (self._start_profile()
                        if self.profile_dir and epoch == 0 and self.is_writer else None)
            t0 = time.time()
            n_batches = n_pairs = next_log = 0
            store_before = self.chunk_store.snapshot_stats() if self.device_data else None
            # the epoch's spans give the phases line and the step times
            tracing.clear()
            tracing.start(ranges=profiler is not None)
            stream_logs = cfg.loss_log_stream == "batch"
            pending_logs: List[Tuple[int, Dict]] = []
            try:
                for losses, pairs in self._train_batches(warmup):
                    # an item may cover several batches (a chunk's prefix);
                    # log at every crossing of the 100-batch mark
                    if n_batches >= next_log:
                        next_log = n_batches - (n_batches % 100) + 100
                        if stream_logs:
                            with tracing.span(tracing.FETCH):
                                msg = self._format_loss_line(epoch, n_batches, losses)
                            self.log(msg)
                        else:
                            pending_logs.append((n_batches, losses))
                    n_batches += max(pairs // cfg.batch_size, 1)
                    n_pairs += pairs
            except BaseException:
                tracing.stop()
                if profiler is not None:
                    profiler.stop()
                # a crash mid-epoch must not eat the deferred loss lines
                for nb, losses in pending_logs:
                    try:
                        self.log(self._format_loss_line(epoch, nb, losses))
                    except Exception:
                        break
                raise
            try:
                with tracing.span(tracing.BLOCK):
                    self._sync()
                with tracing.span(tracing.FETCH):
                    for nb, losses in pending_logs:
                        self.log(self._format_loss_line(epoch, nb, losses))
            finally:
                tracing.stop()
            spans = tracing.records()
            epoch_time = time.time() - t0
            self.log(f"epoch {epoch} done in {epoch_time:.1f}s "
                      f"({n_pairs / max(epoch_time, 1e-9):.0f} pairs/s)")
            # dispatch = host time in the steps, fetch = host time turning the
            # deferred loss scalars into log lines, block = the end-of-epoch
            # wait for the card's queue to drain; in device mode the store's
            # uploads and the time waited for them
            phase_rec = {k: round(sum(tracing.durations_s(spans, name)), 1)
                         for k, name in (("dispatch_s", tracing.STEP),
                                         ("fetch_s", tracing.FETCH),
                                         ("block_s", tracing.BLOCK))}
            if store_before is not None:
                after = self.chunk_store.snapshot_stats()
                phase_rec.update(
                    uploads=after["uploads"] - store_before["uploads"],
                    upload_gb=round((after["upload_bytes"] - store_before["upload_bytes"])
                                    / 2**30, 2),
                    upload_s=round(after["upload_s"] - store_before["upload_s"], 1),
                    upload_wait_s=round(after["wait_s"] - store_before["wait_s"], 1),
                )
            self.log(f"epoch {epoch} phases {json.dumps(phase_rec)}")
            if profiler is not None:
                self._stop_profile(profiler)
                self.log(f"profiler trace written to {self.profile_dir}")

            # scheduler (ref :502-504); plateau consumes the last val loss
            if cfg.lr_scheduler != "no":
                last_val = history[-1]["val_loss_ce"] if history else None
                set_learning_rate(self.optimizer, self.scheduler.step(last_val))

            # validation (ref :506-529)
            val_metrics = self.evaluate()
            self.log(
                f"validation epoch {epoch}: mean loss ce : "
                f"{val_metrics['loss_ce']}, mean loss average: "
                f"{val_metrics.get('loss_avg', val_metrics.get('log_pmu2', 0.0))},"
                f" mean loss total: {val_metrics['loss_total']}"
            )
            history.append({
                "epoch": epoch,
                "val_loss_ce": val_metrics["loss_ce"],
                "val_loss_total": val_metrics["loss_total"],
                "epoch_time_s": epoch_time,
                "train_pairs_per_s": n_pairs / max(epoch_time, 1e-9),
                "step_s": step_seconds(spans),
                "pairs_per_step": cfg.batch_size,
            })

            # best-on-val-CE checkpoint (ref :531-540); meta first
            if val_metrics["loss_ce"] < best_loss:
                best_loss = val_metrics["loss_ce"]
                if self.is_writer:
                    ckpt_lib.save_best_meta(self.checkpoint_dir, best_loss)
                    ckpt_lib.save_checkpoint(self.checkpoint_dir, self.model, self.optimizer,
                                             self.scheduler)
                best_epoch = epoch
                best_state = snapshot(self.model, self.optimizer)
        else:
            if track_best:
                restore(self.model, self.optimizer, best_state)
            elif self.is_writer:
                ckpt_lib.save_checkpoint(self.checkpoint_dir, self.model, self.optimizer,
                                         self.scheduler)
        if self.mesh is not None:
            digest = check_replicas(self.mesh, self.model, self.optimizer)
            self.log(f"replicas identical on {self.mesh.n_data} ranks (checksum {digest:#x})")

        return {
            "best_loss": best_loss,
            "best_epoch": best_epoch,
            "history": history,
            "results_dir": self.results_dir,
        }

    def evaluate(self) -> Dict[str, float]:
        """Mean validation losses over the val set (ref :506-529); the memory
        bank still EMA-updates."""
        if self.val_dataset is None:
            return {"loss_ce": float("nan"), "loss_total": float("nan")}
        sums: Dict[str, torch.Tensor] = {}
        count = 0

        def add(losses):
            for k, v in losses.items():
                sums[k] = sums[k] + v if k in sums else v

        arch = self.cfg.model_arch
        if self.device_data:
            # every batch of a chunk in turn (the JAX trainer scans a chunk's
            # bucket-aligned prefix; the sum is the same), summed in the host
            # path's order
            for eeg_c, sp_c, ids_c, idx_m, subs_m, _partner, n in \
                    self.val_chunk_store.epoch_chunk_batches():
                idx_d, subs_d = device_indices(self.device, idx_m, subs_m)
                for i in range(n):
                    add(chunk_eval_step(self.model, eeg_c, sp_c, ids_c, idx_d[i], subs_d[i],
                                        arch))
                    count += 1
        else:
            for batch in self._batches(self.val_dataset):
                add(eval_step(self.model, batch, arch))
                count += 1
        if self.mesh is not None and sums:
            # each rank's sums are the global batches' already; the mean makes
            # the best-checkpoint choice the same on every rank whatever
            # rounding the ranks' cards did
            names = sorted(sums)
            mean = all_reduce_mean_(torch.stack([sums[k].float() for k in names]), self.mesh)
            sums = dict(zip(names, mean))
        return {k: float(v) / max(count, 1) for k, v in sums.items()}
