"""The training driver: epoch loop, early stopping, checkpointing, logging.

Counterpart of ``transformer_clip_eeg_tpu/train/loop.py`` on its host data
path (ref ``train_clip_final.py:443-540``): auto-resume from
``checkpoints/``, warmup epochs backprop ``loss_ce`` only, a per-epoch
scheduler step, validation in eval mode (the memory bank still updating),
best-on-val-CE checkpointing with the in-memory best restored at the end,
and the same ``loss.txt`` lines.  Batches are gathered on the host in numpy
and copied to the card from pinned buffers, two batches ahead.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md): the
device-resident chunk store (``data_mode="device"``), a data-parallel mesh
(``n_data_shards``), the bf16 compute mode, augmentations and ``addEEG``
mixup, ``profile_dir`` tracing, and a ``prng_impl`` other than the default.
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
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.schedulers import make_scheduler
from transformer_clip_eeg_tpu_torch.train.state import (
    count_params,
    make_optimizer,
    set_learning_rate,
)
from transformer_clip_eeg_tpu_torch.train.steps import eval_step, train_step


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
    """Batches on ``device``, ``size`` ahead: on the card each array is
    staged in pinned host memory and copied with ``non_blocking=True``, so
    the copy overlaps the step before it."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (see ROADMAP.md for "
        "the modules still to port)"
    )


def check_supported(cfg: TrainConfig, mesh=None, profile_dir: Optional[str] = None) -> None:
    """Raise ``NotImplementedError`` for the options the port does not run yet."""
    if cfg.data_mode == "device":
        raise _not_ported("data_mode='device' (the device-resident chunk store)")
    if cfg.n_data_shards or mesh is not None:
        raise _not_ported("data-parallel training over several devices (n_data_shards)")
    if cfg.compute_dtype != "float32":
        raise _not_ported(f"compute_dtype={cfg.compute_dtype!r} (the kernels are float32)")
    if cfg.augmentations or cfg.addEEG_b:
        raise _not_ported("data augmentation and addEEG mixup (ops/augment.py)")
    if profile_dir or cfg.profile_dir:
        raise _not_ported("profile_dir tracing")
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
        check_supported(config, mesh, profile_dir)
        self.cfg = cfg = config
        self.device = resolve_device(device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.results_dir = results_dir or os.path.join(
            cfg.results_folder, cfg.results_dir_name(time.strftime("%Y_%m_%d_%H_%M_%S"))
        )
        self.checkpoint_dir = os.path.join(self.results_dir, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.loss_file = os.path.join(self.results_dir, "loss.txt")

        # memory-bank sizing (ref train_clip_final.py:367-372); the val set
        # restarts ids at 1 and shares the bank, so size by the larger
        bank_size = train_dataset.get_number_of_stimuli_segments()
        if val_dataset is not None:
            bank_size = max(bank_size, val_dataset.get_number_of_stimuli_segments())
        cfg.bank_size = bank_size  # persisted so serving rebuilds the head
        cfg.save(os.path.join(self.results_dir, "args.txt"))

        # the JAX trainer draws one example batch to initialise its state; the
        # same draw here checks that the dataset yields batches and leaves its
        # sampling stream where the JAX trainer leaves it
        next(batch_iterator(train_dataset, cfg.addEEG_b))
        self.model = build_model_from_config(cfg, bank_size, self.device, seed=cfg.seed)
        self.optimizer = make_optimizer(
            self.model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
            cfg.beta2, cfg.weight_decay, cfg.amsgrad_b,
        )
        self.scheduler = make_scheduler(cfg.lr_scheduler, cfg.learning_rate,
                                        cfg.step_size_scheduler)
        printf(f"number of parameters {count_params(self.model)}", self.loss_file)

    # -- helpers ------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batches(self, dataset) -> Iterator[Dict[str, torch.Tensor]]:
        return prefetch_to_device(batch_iterator(dataset, add_eeg=False), self.device)

    def _snapshot(self) -> Dict[str, Any]:
        """A deep copy of the model (parameters and bank) and the optimizer."""
        def clone(v):
            return v.detach().clone() if isinstance(v, torch.Tensor) else v
        return {
            "model": {k: clone(v) for k, v in self.model.state_dict().items()},
            "optimizer": {k: clone(v) for k, v in self.optimizer.state_dict().items()},
        }

    def _restore(self, snap: Dict[str, Any]) -> None:
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(snap["optimizer"])

    def _format_loss_line(self, epoch: int, n_batches: int, losses) -> str:
        """The reference's per-100-batch loss line (ref :494-500)."""
        return (
            f"train epoch {epoch} batch {n_batches} loss_ce "
            f"{float(losses['loss_ce'])} loss average eeg "
            f"{float(losses['loss_avg'])}"
        )

    # -- training -------------------------------------------------------------

    def fit(self) -> Dict[str, Any]:
        cfg = self.cfg
        # auto-resume (ref train_clip_final.py:443-449)
        restored = ckpt_lib.restore_checkpoint(self.checkpoint_dir, self.model,
                                               self.optimizer, self.scheduler)
        if restored is not None:
            printf(f"loaded model from {self.checkpoint_dir}", self.loss_file)
        else:
            printf(f"no model found at {self.checkpoint_dir}, training from scratch",
                   self.loss_file)

        train_seed = cfg.seed + 1  # the JAX trainer's PRNGKey(seed + 1)
        # a resumed run starts from the recorded best val CE, so its first
        # (possibly worse) epoch cannot overwrite the saved best
        best_loss = float("inf")
        if restored is not None:
            meta = ckpt_lib.load_best_meta(self.checkpoint_dir)
            if meta is not None:
                best_loss = meta
        best_epoch = 0
        best_state = self._snapshot()
        history: List[Dict[str, Any]] = []
        self.history = history  # per epoch, filled as the epochs run
        # without a validation set there is no best to track: keep the final
        # state (val losses are NaN and 'nan < inf' never updates the best)
        track_best = self.val_dataset is not None

        for epoch in range(cfg.epochs):
            # early stopping (ref :463-468)
            if track_best and epoch > best_epoch + cfg.patience and epoch > cfg.warmup_epochs:
                self._restore(best_state)
                printf(f"early stopping at epoch {epoch}", self.loss_file)
                break

            warmup = epoch < cfg.warmup_epochs
            t0 = time.time()
            n_batches = n_pairs = next_log = 0
            # dispatch = host time in step calls, fetch = host time turning
            # the deferred loss scalars into log lines, block = the
            # end-of-epoch wait for the card's queue to drain
            phase = {"dispatch_s": 0.0, "fetch_s": 0.0}
            # host clock at each step's start; the intervals between them
            # (the last one closed after the drain) are the step times
            step_starts: List[float] = []
            stream_logs = cfg.loss_log_stream == "batch"
            pending_logs: List[Tuple[int, Dict]] = []
            try:
                for batch in self._batches(self.train_dataset):
                    t_step = time.perf_counter()
                    step_starts.append(t_step)
                    losses = train_step(self.model, self.optimizer, batch, train_seed,
                                        warmup, cfg.model_arch)
                    phase["dispatch_s"] += time.perf_counter() - t_step
                    pairs = batch["eeg"].shape[0]
                    if n_batches >= next_log:
                        next_log = n_batches - (n_batches % 100) + 100
                        if stream_logs:
                            tf = time.perf_counter()
                            msg = self._format_loss_line(epoch, n_batches, losses)
                            phase["fetch_s"] += time.perf_counter() - tf
                            printf(msg, self.loss_file)
                        else:
                            pending_logs.append((n_batches, losses))
                    n_batches += max(pairs // cfg.batch_size, 1)
                    n_pairs += pairs
            except BaseException:
                # a crash mid-epoch must not eat the deferred loss lines
                for nb, losses in pending_logs:
                    try:
                        printf(self._format_loss_line(epoch, nb, losses), self.loss_file)
                    except Exception:
                        break
                raise
            tb = time.perf_counter()
            self._sync()
            t_end = time.perf_counter()
            block_s = t_end - tb
            tf = time.perf_counter()
            for nb, losses in pending_logs:
                printf(self._format_loss_line(epoch, nb, losses), self.loss_file)
            phase["fetch_s"] += time.perf_counter() - tf
            epoch_time = time.time() - t0
            printf(
                f"epoch {epoch} done in {epoch_time:.1f}s "
                f"({n_pairs / max(epoch_time, 1e-9):.0f} pairs/s)",
                self.loss_file,
            )
            phase_rec = {k: round(v, 1) for k, v in phase.items()}
            phase_rec["block_s"] = round(block_s, 1)
            printf(f"epoch {epoch} phases {json.dumps(phase_rec)}", self.loss_file)

            # scheduler (ref :502-504); plateau consumes the last val loss
            if cfg.lr_scheduler != "no":
                last_val = history[-1]["val_loss_ce"] if history else None
                set_learning_rate(self.optimizer, self.scheduler.step(last_val))

            # validation (ref :506-529)
            val_metrics = self.evaluate()
            printf(
                f"validation epoch {epoch}: mean loss ce : "
                f"{val_metrics['loss_ce']}, mean loss average: "
                f"{val_metrics.get('loss_avg', 0.0)},"
                f" mean loss total: {val_metrics['loss_total']}",
                self.loss_file,
            )
            history.append({
                "epoch": epoch,
                "val_loss_ce": val_metrics["loss_ce"],
                "val_loss_total": val_metrics["loss_total"],
                "epoch_time_s": epoch_time,
                "train_pairs_per_s": n_pairs / max(epoch_time, 1e-9),
                "step_s": list(np.diff(step_starts + [t_end])) if step_starts else [],
                "pairs_per_step": cfg.batch_size,
            })

            # best-on-val-CE checkpoint (ref :531-540); meta first
            if val_metrics["loss_ce"] < best_loss:
                best_loss = val_metrics["loss_ce"]
                ckpt_lib.save_best_meta(self.checkpoint_dir, best_loss)
                ckpt_lib.save_checkpoint(self.checkpoint_dir, self.model, self.optimizer,
                                         self.scheduler)
                best_epoch = epoch
                best_state = self._snapshot()
        else:
            if track_best:
                self._restore(best_state)
            else:
                ckpt_lib.save_checkpoint(self.checkpoint_dir, self.model, self.optimizer,
                                         self.scheduler)

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
        for batch in self._batches(self.val_dataset):
            for k, v in eval_step(self.model, batch, self.cfg.model_arch).items():
                sums[k] = sums[k] + v if k in sums else v
            count += 1
        return {k: float(v) / max(count, 1) for k, v in sums.items()}
