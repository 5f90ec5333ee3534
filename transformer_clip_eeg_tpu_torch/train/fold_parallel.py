"""Fold-parallel cross-validation training: several CV folds in one run.

Counterpart of ``transformer_clip_eeg_tpu/train/fold_parallel.py``.  The
reference trains one CV fold per invocation (``--run`` selects the
validation story fold); the flagship model is far too small to fill the
card alone, so this trainer runs several folds over one shared data path:

* ONE union dataset holds every story of CV folds 0-8 (each fold's train
  set is the union minus its val stories, ref
  ``train_clip_helper_functions.py:392-398``), chunked and windowed once,
  and ONE :class:`~transformer_clip_eeg_tpu_torch.train.device_data.
  DeviceChunkStore` uploads each chunk once an epoch, whatever the number
  of folds.
* The epoch walks a SHARED shuffled chunk order.  For each chunk, each fold
  draws its own batch indices with its own sampling rng (the reference's
  sampling, ``dataset.create_eeg_indices``) iff the chunk's story is in
  that fold's train split, in the JAX trainer's draw order exactly
  (:meth:`FoldParallelTrainer._chunk_rows`, ``_epoch``).
* Each fold has its own model, optimizer and scheduler, all from the same
  init.  For each chunk, for each row, each participating fold takes one
  ``chunk_train_step``; a fold that sits the row out is skipped, which
  leaves the state the JAX trainer's masked select keeps.  Dropout draws
  from ``fold_seed(seed + 1, step)`` with the fold's own step count, as in
  the solo ``Trainer``, so a fold's numbers do not depend on the folds
  beside it (what the JAX trainer gets from threefry's exact batching).
* Validation runs the same way over each fold's val chunks (the memory bank
  still EMA-updates, as the reference's eval forward does).
* Per-fold early stopping freezes a finished fold while the others train
  on; each fold's best-on-val-CE state is written to
  ``results_root/fold_{f}/checkpoints/`` (with ``args.txt``) as soon as the
  fold improves, and a new trainer on the same root resumes each fold from
  it.

``fold_group_size`` walks the folds in contiguous groups of G per chunk
(the JAX trainer's HBM fallback); the draws are made before the walk, so
any G gives the same per-fold numbers.  ``'auto'`` is all folds: the folds
of a row run one after another, so the peak memory does not grow with G.

Semantics note vs the sequential ``Trainer`` (as in the JAX package):
segment identifiers are numbered over the union dataset, so validation's
memory-bank updates land on the val stories' own rows.  The sequential
path numbers train and val datasets independently (ids restart at 1, ref
``dataset_loader.py:270-272``), so its val updates collide with train rows,
a reference quirk this trainer does not reproduce.

A fold-sharded mesh (``mesh``; ``cv --parallel yes --n_data_shards N``)
puts the fold axis on the ranks, as JAX's ``shard_map`` does: rank ``r``
trains folds ``[r F/N, (r+1) F/N)`` over its own replica of the union store
(its share of the card's budget), with no collective in the step, since the
folds are independent.  Every rank draws every fold's index matrices, so the
shared streams (the chunk order, the mixup partners) stay those of the
unsharded run and each fold trains bit for bit as it does there.  One object
gather per epoch gives every rank every fold's losses (each rank's early
stopping and schedulers read them); rank 0 writes the root ``loss.txt``, each
rank its own folds' directories and checkpoints.

A fold axis inside the kernels, one launch for F folds, is queued in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.models.registry import (
    build_model_from_config,
    resolve_device,
)
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore
from transformer_clip_eeg_tpu_torch.parallel.collectives import gather_objects
from transformer_clip_eeg_tpu_torch.parallel.mesh import DATA_AXIS, data_axis_only
from transformer_clip_eeg_tpu_torch.train.loop import (
    check_supported,
    device_indices,
    printf,
    restore,
    snapshot,
)
from transformer_clip_eeg_tpu_torch.train.schedulers import make_scheduler
from transformer_clip_eeg_tpu_torch.train.state import (
    count_params,
    make_optimizer,
    set_learning_rate,
)
from transformer_clip_eeg_tpu_torch.train.steps import chunk_eval_step, chunk_train_step


def _story_of_chunk_key(key: str) -> str:
    return key.rsplit("_batch_", 1)[0]


def local_folds(n_folds: int, mesh) -> List[int]:
    """The indices of the folds a rank of ``mesh`` trains: rank ``r`` of N
    the ``r``-th contiguous ``n_folds / N`` (all of them without a mesh)."""
    if mesh is None:
        return list(range(n_folds))
    per_rank = n_folds // mesh.n_data
    return list(range(mesh.rank * per_rank, (mesh.rank + 1) * per_rank))


class FoldParallelTrainer:
    """Train the CV folds ``folds`` (their validation fold ids, e.g. ``[0,
    1, 2, 3, 4]``) over one union dataset on ``device`` (the card unless the
    caller passes ``device="cpu"``), or this rank's share of them under a
    fold-sharded ``mesh``.  ``cfg.run`` is ignored;
    ``union_files``/``union_audio`` must cover every story of CV folds 0-8
    (train and val of any one fold)."""

    def __init__(
        self,
        cfg: TrainConfig,
        folds: Sequence[int],
        union_files: Sequence[str],
        union_audio: Sequence[str],
        results_root: str,
        row_bucket: int = 8,
        mesh=None,
        fold_group_size=None,
        device="cuda",
    ):
        self.folds = list(folds)
        F = len(self.folds)
        data_axis_only(mesh, "the fold-parallel trainer")
        if mesh is None and cfg.n_data_shards:
            raise ValueError(f"n_data_shards={cfg.n_data_shards} needs a mesh of as many ranks: "
                             "cv.main starts them, or torchrun with parallel.make_mesh")
        if mesh is not None and F % mesh.n_data:
            raise ValueError(f"{F} folds do not shard evenly over the mesh's {mesh.n_data}-device "
                             f"'{DATA_AXIS}' axis")
        self.mesh = mesh
        self.fold_group_size = self._resolve_fold_group_size(fold_group_size)
        # the mesh shards the folds, not the batch
        check_supported(dataclasses.replace(cfg, n_data_shards=0))
        self.cfg = cfg
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_writer = mesh is None or mesh.is_writer  # rank 0 writes the root files
        self.local = local_folds(F, mesh)  # the folds (indices) trained here
        self.results_root = results_root
        self.row_bucket = row_bucket
        os.makedirs(results_root, exist_ok=True)

        with open(cfg.fold_split_path) as f:
            split = json.load(f)
        self.val_stories: List[set] = [set(split[str(f_)]) for f_ in self.folds]
        all_stories = [s for x in range(9) for s in split[str(x)]]
        self.train_stories: List[set] = [set(all_stories) - vs for vs in self.val_stories]

        self.dataset = EEGWindowDataset(
            union_files, union_audio, cfg.window_length, cfg.hop_length,
            batch_size=cfg.batch_size, shuffle=cfg.shuffle_b,
            shuffle_percentage=cfg.shuffle_percentage, addEEG=cfg.addEEG_b,
            data_augmentation=cfg.augmentations,
            data_augmentation_probability=cfg.data_augmentation_percentage, seed=cfg.seed,
        )
        # under a mesh every rank holds the whole union (replicated, as JAX's
        # chunks), within its share of the card's budget
        self.store = DeviceChunkStore(self.dataset, device=self.device,
                                      store_dtype=cfg.chunk_store_dtype,
                                      budget_frac=cfg.chunk_budget_frac,
                                      ranks_on_device=1 if mesh is None else mesh.ranks_on_device)
        # one sampling stream per fold, as each sequential run's dataset rng;
        # and a shared one for the chunk order and the mixup partners.  Every
        # rank draws for every fold, so the shared stream is the unsharded one
        self.fold_rngs = [np.random.default_rng(cfg.seed) for _ in self.folds]
        self.shared_rng = np.random.default_rng(cfg.seed)

        bank_size = self.dataset.get_number_of_stimuli_segments()
        self.fold_dirs = [os.path.join(results_root, f"fold_{f_}") for f_ in self.folds]
        for j in self.local:
            d = self.fold_dirs[j]
            os.makedirs(os.path.join(d, "checkpoints"), exist_ok=True)
            fold_cfg = TrainConfig(**{**cfg.to_dict(), "run": self.folds[j]})
            fold_cfg.bank_size = bank_size
            fold_cfg.save(os.path.join(d, "args.txt"))
        self.loss_file = os.path.join(results_root, "loss.txt")

        # all folds share the init (the reference reuses one seed per fold);
        # the folds of other ranks are None here
        self.models: List = [None] * F
        self.optimizers: List = [None] * F
        self.schedulers: List = [None] * F
        for j in self.local:
            self.models[j] = build_model_from_config(cfg, bank_size, self.device, seed=cfg.seed)
            self.optimizers[j] = make_optimizer(
                self.models[j].parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
                cfg.beta2, cfg.weight_decay, cfg.amsgrad_b)
            self.schedulers[j] = make_scheduler(cfg.lr_scheduler, cfg.learning_rate,
                                                cfg.step_size_scheduler)

        # auto-resume: each fold restores its own checkpoint (model, bank,
        # optimizer; the scheduler starts afresh, as in the JAX trainer) and
        # the val CE it was saved at, so that fit() does not overwrite the
        # saved best with a worse first epoch
        self.resumed = np.zeros(F, bool)
        self.resume_best_loss = np.full(F, np.inf)
        for j in self.local:
            ckpt_dir = os.path.join(self.fold_dirs[j], "checkpoints")
            if ckpt_lib.restore_checkpoint(ckpt_dir, self.models[j],
                                           self.optimizers[j]) is not None:
                self.resumed[j] = True
                meta = ckpt_lib.load_best_meta(ckpt_dir)
                if meta is not None:
                    self.resume_best_loss[j] = meta
        if mesh is not None:  # every fold's resume state on every rank
            for resumed, best in gather_objects((self.resumed, self.resume_best_loss), mesh):
                self.resumed |= resumed
                self.resume_best_loss = np.minimum(self.resume_best_loss, best)
        if self.resumed.any():
            self._log(f"auto-resumed folds {[self.folds[j] for j in np.where(self.resumed)[0]]} "
                      "from their checkpoints")

        if self.fold_group_size != F:
            self._log(f"fold-group chunking: {F} folds in groups of {self.fold_group_size} "
                      "per dispatch")
        self._log(f"fold-parallel over folds {self.folds}: "
                  f"{count_params(self.models[self.local[0]])} params x {F} folds")
        if mesh is not None:
            budget = self.store.budget_bytes
            print(f"{mesh.describe()}: rank {mesh.rank} trains folds "
                  f"{[self.folds[j] for j in self.local]} over its replica of the union store"
                  + ("" if budget is None else f" (budget {budget / 2**30:.2f} GiB)"),
                  flush=True)

    def _log(self, statement: str) -> None:
        """A line of the root ``loss.txt`` (and stdout), written by rank 0."""
        if self.is_writer:
            printf(statement, self.loss_file)

    # -- fold-group sizing -----------------------------------------------------

    def _resolve_fold_group_size(self, requested) -> int:
        """``None``/0: all folds at once; ``'auto'``: all folds too (a row's
        folds run one after another, so its peak memory does not grow with
        G); an integer: that size, which must divide F."""
        F = len(self.folds)
        if requested in (None, 0):
            return F
        if self.mesh is not None:
            raise ValueError("fold_group_size cannot combine with a fold-sharded mesh — the "
                             "mesh already divides the fold stack across chips")
        if requested == "auto":
            print(f"auto fold grouping: G={F} (the folds of a row run one after another, "
                  "so the peak memory does not grow with G)")
            return F
        g = int(requested)
        if g < 1 or F % g != 0:
            raise ValueError(f"fold_group_size {g} must be a positive divisor of the fold "
                             f"count ({F})")
        return g

    # -- schedule assembly -----------------------------------------------------

    def _chunk_rows(self, key: str, participate: np.ndarray, add_eeg: bool):
        """Index matrices for one chunk: ``(idx [n_pad, F, bs], subs, partner,
        valid [n_pad, F])``, each participating fold sampling with its own
        rng (the mixup partners from the shared one); ``n_pad`` rounds the
        subject count up to ``row_bucket``."""
        eeg = self.dataset.chunks[key]["eeg"]
        n, F = eeg.shape[0], len(self.folds)
        bs = self.cfg.batch_size
        n_pad = -(-n // self.row_bucket) * self.row_bucket
        idx = np.zeros((n_pad, F, bs), np.int32)
        subs = np.zeros((n_pad, F, bs), np.int32)
        partner = np.zeros((n_pad, F, bs), np.int32)
        valid = np.zeros((n_pad, F), bool)
        for j, active in enumerate(participate):
            if not active:
                continue
            i_m, s_m = self.dataset.create_eeg_indices(eeg, rng=self.fold_rngs[j])
            idx[:n, j] = i_m
            subs[:n, j] = s_m
            partner[:n, j] = self.shared_rng.integers(0, n, (n, bs)) if add_eeg else s_m
            valid[:n, j] = True
        return idx, subs, partner, valid

    def _epoch(self, member: List[set], active: np.ndarray, train: bool,
               warmup: bool = False):
        """One pass over the shuffled union chunks; returns per-fold ``(loss
        sums {k: [F]}, batch counts [F])``."""
        cfg, F, G = self.cfg, len(self.folds), self.fold_group_size
        keys = [k for k in self.dataset.batches_keys
                if "eeg" in self.dataset.chunks[k] and self.store.feature in self.dataset.chunks[k]]
        self.shared_rng.shuffle(keys)
        walk = []
        for key in keys:
            story = _story_of_chunk_key(key)
            participate = np.array([active[j] and story in member[j] for j in range(F)], bool)
            if participate.any():
                walk.append((key, participate))
        step_kw = dict(model_arch=cfg.model_arch, augmentations=cfg.augmentations,
                       augmentation_probability=cfg.data_augmentation_percentage,
                       add_eeg=cfg.addEEG_b, compute_dtype=cfg.compute_dtype)
        losses: List[List[Dict[str, torch.Tensor]]] = [[] for _ in range(F)]
        for pos, (key, participate) in enumerate(walk):
            idx, subs, partner, valid = self._chunk_rows(key, participate,
                                                         cfg.addEEG_b and train)
            self.store._set_upcoming([k for k, _ in walk[pos:]])
            eeg_d, speech_d, ids_d, n, _ = self.store.get(key)
            if self.store.prefetch and pos + 1 < len(walk):
                self.store.prefetch_key(walk[pos + 1][0])
            idx_d, subs_d, partner_d = device_indices(self.device, idx, subs, partner)
            # fold-group chunking: contiguous groups of G folds, each over
            # every row of the chunk while it is resident
            for lo in range(0, F, G):
                for i in range(n):
                    for j in range(lo, lo + G):
                        if not valid[i, j] or self.models[j] is None:  # another rank's
                            continue
                        if train:
                            out = chunk_train_step(
                                self.models[j], self.optimizers[j], eeg_d, speech_d, ids_d,
                                idx_d[i, j], subs_d[i, j], cfg.seed + 1, warmup,
                                partner=partner_d[i, j], **step_kw)
                        else:
                            out = chunk_eval_step(self.models[j], eeg_d, speech_d, ids_d,
                                                  idx_d[i, j], subs_d[i, j], cfg.model_arch)
                        losses[j].append(out)
        # one transfer of every loss at the end of the epoch
        sums: Dict[str, np.ndarray] = {}
        counts = np.array([len(ls) for ls in losses], np.int64)
        for j, ls in enumerate(losses):
            for k in (ls[0] if ls else {}):
                vals = torch.stack([out[k] for out in ls]).double().cpu().numpy()
                sums.setdefault(k, np.zeros(F, np.float64))[j] = vals.sum()
        return sums, counts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- driver ----------------------------------------------------------------

    def _merge(self, tr_sums, tr_counts, va_sums, va_counts, epoch_time, uploads):
        """Every rank's epoch in one object gather: the folds' loss sums and
        counts (each fold's from the rank that trains it; the others hold
        zeros there), the slowest rank's train time, each rank's uploads."""
        every = gather_objects((tr_sums, tr_counts, va_sums, va_counts, epoch_time, uploads),
                               self.mesh)
        merged = []
        for i in (0, 2):
            sums: Dict[str, np.ndarray] = {}
            for part in every:
                for k, v in part[i].items():
                    sums[k] = sums.get(k, 0.0) + v
            merged += [sums, sum(part[i + 1] for part in every)]
        return (*merged, max(part[4] for part in every), [part[5] for part in every])

    def fit(self) -> Dict[str, object]:
        cfg = self.cfg
        F = len(self.folds)
        # resumed folds start from their recorded best val CE; best_epoch
        # stays 0 so patience counts from the resume point
        best_loss = self.resume_best_loss.copy()
        best_epoch = np.zeros(F, np.int64)
        active = np.ones(F, bool)
        best_states = {j: snapshot(self.models[j], self.optimizers[j]) for j in self.local}
        history: List[Dict[str, object]] = []
        self.history = history

        for epoch in range(cfg.epochs):
            if epoch > cfg.warmup_epochs:
                newly_done = active & (epoch > best_epoch + cfg.patience)
                for j in np.where(newly_done)[0]:
                    self._log(f"fold {self.folds[j]}: early stopping at epoch {epoch}")
                active &= ~newly_done
            if not active.any():
                break
            warmup = epoch < cfg.warmup_epochs
            t0 = time.time()
            store_before = self.store.snapshot_stats()
            tr_sums, tr_counts = self._epoch(self.train_stories, active, train=True,
                                             warmup=warmup)
            self._sync()
            epoch_time = time.time() - t0
            store_after = self.store.snapshot_stats()

            # per-fold scheduler (ref :502-504); plateau reads the last val CE
            if cfg.lr_scheduler != "no":
                last_val = history[-1]["val_loss_ce"] if history else [None] * F
                for j in self.local:
                    set_learning_rate(self.optimizers[j], self.schedulers[j].step(last_val[j]))

            va_sums, va_counts = self._epoch(self.val_stories, active, train=False)
            uploads = store_after["uploads"] - store_before["uploads"]
            if self.mesh is not None:
                tr_sums, tr_counts, va_sums, va_counts, epoch_time, uploads_by_rank = \
                    self._merge(tr_sums, tr_counts, va_sums, va_counts, epoch_time, uploads)
            val_ce = np.where(va_counts > 0, va_sums.get("loss_ce", np.zeros(F))
                              / np.maximum(va_counts, 1), np.inf)
            tr_ce = tr_sums.get("loss_ce", np.zeros(F)) / np.maximum(tr_counts, 1)
            pairs = int(tr_counts.sum()) * cfg.batch_size
            self._log(f"epoch {epoch}: train loss_ce {np.array2string(tr_ce, precision=4)} val "
                      f"loss_ce {np.array2string(val_ce, precision=4)} "
                      f"({pairs / max(epoch_time, 1e-9):.0f} pairs/s aggregate)")
            self._log("epoch %d phases %s" % (epoch, json.dumps({
                "uploads": uploads,
                "upload_gb": round((store_after["upload_bytes"]
                                    - store_before["upload_bytes"]) / 2**30, 2),
                "upload_s": round(store_after["upload_s"] - store_before["upload_s"], 1),
                "upload_wait_s": round(store_after["wait_s"] - store_before["wait_s"], 1),
            })))
            history.append({
                "epoch": epoch,
                "val_loss_ce": val_ce.tolist(),
                "train_loss_ce": tr_ce.tolist(),
                "epoch_time_s": epoch_time,
                "train_pairs_per_s": pairs / max(epoch_time, 1e-9),
                **({} if self.mesh is None else {"uploads_by_rank": uploads_by_rank}),
            })

            improved = active & (val_ce < best_loss)
            for j in np.where(improved)[0]:
                best_loss[j], best_epoch[j] = val_ce[j], epoch
                if j not in best_states:  # another rank's fold
                    continue
                best_states[j] = snapshot(self.models[j], self.optimizers[j])
                # save each improved fold now (ref :531-540), so a killed sweep
                # resumes every fold from its best so far; meta first
                ckpt_dir = os.path.join(self.fold_dirs[j], "checkpoints")
                ckpt_lib.save_best_meta(ckpt_dir, best_loss[j])
                ckpt_lib.save_checkpoint(ckpt_dir, self.models[j], self.optimizers[j],
                                         self.schedulers[j])

        # each fold's model holds its best state from here on; a fold that
        # never improved (epochs == 0) still gets its state on disk, so the
        # evaluation suite and serving can load its directory
        for j in self.local:
            restore(self.models[j], self.optimizers[j], best_states[j])
            ckpt_dir = os.path.join(self.fold_dirs[j], "checkpoints")
            if not os.path.exists(ckpt_lib.checkpoint_path(ckpt_dir)):
                ckpt_lib.save_checkpoint(ckpt_dir, self.models[j], self.optimizers[j],
                                         self.schedulers[j])
        return {
            "folds": self.folds,
            "best_loss": best_loss.tolist(),
            "best_epoch": best_epoch.tolist(),
            "history": history,
            "fold_dirs": self.fold_dirs,
        }

    def fold_state(self, fold: int):
        """The model of ``fold``, holding its best state after :meth:`fit`
        (a fold of this rank's, under a mesh)."""
        model = self.models[self.folds.index(fold)]
        if model is None:
            raise ValueError(f"fold {fold} is trained by another rank of the mesh")
        return model

    def release_host_data(self) -> None:
        """Free the union dataset's host arrays and the chunk store's device
        memory once training is over: each fold's evaluation suite ingests
        its own splits.  The folds' models stay."""
        if self.store is not None:
            self.store.release()
            self.store = None
        if self.dataset is not None:
            self.dataset.chunks.clear()
            self.dataset = None
