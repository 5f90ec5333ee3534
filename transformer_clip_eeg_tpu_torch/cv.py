"""The cross-validation driver: train and evaluate several CV folds, then
``cv_summary.json``.

Counterpart of ``transformer_clip_eeg_tpu/cv.py``.  The reference trains one
fold per invocation (``--run`` selects the validation fold, ref
``train_clip_final.py:168``); this driver runs the whole train+eval
workflow for each requested fold and aggregates the per-fold evaluation
JSONs into ``<results_folder>/cv_summary.json``, on the card unless the
caller passes ``device="cpu"`` to :func:`main`.

``--parallel no`` (the default) runs ``cli.main`` once per fold.
``--parallel yes`` trains all requested folds in one run over one union
dataset and one chunk store (``train/fold_parallel.py``), then runs each
fold's evaluation suite, with the ingest file cache installed around the
suites (they ingest overlapping splits) and the heap trimmed after them.

``--parallel yes --n_data_shards N`` shards the folds over N ranks (the
JAX driver's fold-sharded mesh; spawned here, or the group this process or
``torchrun`` has joined): each rank trains its folds and runs their suites,
and rank 0 writes ``cv_summary.json`` after a barrier.  ``--parallel no``
passes ``--n_data_shards`` to each fold's ``cli.main`` (data parallel).

Run: ``python -m transformer_clip_eeg_tpu_torch.cv --data_dir <sparrkulee>
--folds 0 1 2 3 4 [--parallel yes] [any cli flags]``
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Dict, List

from transformer_clip_eeg_tpu_torch.utils.platform import (
    host_mem_total_gb,
    host_rss_gb,
    trim_host_heap,
)


def _parallel_config(results_folder: str, passthrough):
    """The cli flags of a fold-parallel run as a ``TrainConfig``."""
    from transformer_clip_eeg_tpu_torch import cli
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

    targs = cli.build_arg_parser().parse_args(list(passthrough))
    if targs.compile_cache_dir is None:
        targs.compile_cache_dir = "auto"  # the TrainConfig default
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    cfg = TrainConfig(**{k: v for k, v in vars(targs).items() if k in known})
    cfg.results_folder = results_folder
    return cfg, targs.skip_eval == "yes"


def _run_parallel(folds: List[int], results_folder: str, passthrough,
                  fold_group_size=None, device="cuda", mesh=None) -> Dict[int, str]:
    """Train all folds in one run (this rank's share of them under a
    fold-sharded ``mesh``), then each of those folds' evaluation suite;
    returns ``{fold: run_dir}`` for every fold."""
    from transformer_clip_eeg_tpu_torch import cli
    from transformer_clip_eeg_tpu_torch.data.dataset import set_ingest_file_cache
    from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
    from transformer_clip_eeg_tpu_torch.train.fold_parallel import (
        FoldParallelTrainer,
        local_folds,
    )

    cfg, skip_eval = _parallel_config(results_folder, passthrough)

    def split(fold):
        return get_train_val_test_files_final(
            cfg.data_dir, fold, cfg.stimulus_features, cfg.fold_split_path,
            cfg.number_of_training_subjects, debug=cfg.is_debug)

    # the union (train and val of any one fold), sorted: the JAX driver
    # takes folds[0]'s split in the file system's listing order, which moves
    # with the folds requested, and with it the chunk order, the batches and
    # the bank rows.  Sorted, a fold trained alone sees what it sees among
    # the others
    files0 = split(folds[0])
    trainer = FoldParallelTrainer(cfg, folds, sorted(files0[0] + files0[1]),
                                  sorted(files0[4] + files0[5]), results_folder,
                                  fold_group_size=fold_group_size, device=device, mesh=mesh)
    out = trainer.fit()
    print(f"fold-parallel training done: best val loss_ce {out['best_loss']}")
    fold_dirs = dict(zip(folds, out["fold_dirs"]))
    mine = [folds[j] for j in local_folds(len(folds), mesh)]

    # the chunk store's device memory and the union's host arrays go before
    # the suites, which ingest their own splits
    trainer.release_host_data()
    # the suites ingest overlapping train/val/test splits: each file is
    # read once, as a read-only memmap
    ingest_cache: Dict[str, object] = {}
    set_ingest_file_cache(ingest_cache)
    # a raising suite must not leave the cache installed or skip the trim
    try:
        for fold in [] if skip_eval else mine:
            files = split(fold)
            fold_cfg = TrainConfig(**{**cfg.to_dict(), "run": fold})
            cli.run_eval_suite(trainer.fold_state(fold).eval(), fold_cfg, fold_dirs[fold],
                               files[0], files[1], files[2], files[4], files[5], files[6])
            # bound what the suites leave on the heap: past half the host,
            # trim (the port keeps no cached programs to release)
            rss, total = host_rss_gb(), host_mem_total_gb()
            if total and rss > 0.5 * total:
                print(f"cv eval loop: host RSS {rss:.1f} GB > 50% of {total:.1f} GB — "
                      "trimming the heap", flush=True)
                trim_host_heap()
                print(f"cv eval loop: RSS after the trim {host_rss_gb():.1f} GB", flush=True)
    finally:
        set_ingest_file_cache(None)
        ingest_cache.clear()
        trim_host_heap()
    return fold_dirs


def _parallel_rank(folds, results_folder, passthrough, fold_group_size, device, mesh) -> int:
    """One rank of a fold-sharded run: its folds, their suites, and, after
    every rank's, rank 0's ``cv_summary.json``."""
    import torch.distributed as dist

    fold_dirs = _run_parallel(folds, results_folder, passthrough, fold_group_size, device,
                              mesh)
    dist.barrier()  # every fold's suite is on disk
    if mesh.is_writer:
        _write_summary(results_folder, fold_dirs)
    return 0


def _write_summary(results_folder: str, fold_dirs: Dict[int, str]) -> None:
    out_path = os.path.join(results_folder, "cv_summary.json")
    os.makedirs(results_folder, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summarize(fold_dirs), f, indent=2)
    print(f"wrote {out_path}")


def _mean(path: str):
    """The mean of a JSON file's values; None when the file is missing or
    empty."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        obj = json.load(f)
    return sum(obj.values()) / len(obj) if obj else None


def summarize(fold_dirs: Dict[int, str]) -> Dict[str, object]:
    """``cv_summary.json``'s content, aggregated as the JAX driver does: per
    fold its results dir, the mean match-mismatch accuracy over the
    challenge subjects and the mean general-model regression loss; then the
    mean accuracy over the folds that have one."""
    summary: Dict[str, Dict] = {}
    for fold, rd in fold_dirs.items():
        fold_summary: Dict[str, object] = {"results_dir": rd}
        acc = _mean(os.path.join(rd, "evaluation_challenge_set_2023_mm.json"))
        if acc is not None:
            fold_summary["mm_accuracy_mean"] = acc
        reg = _mean(os.path.join(rd, "evaluation_regression_general_model_env.json"))
        if reg is not None:
            fold_summary["regression_loss_mean"] = reg
        summary[str(fold)] = fold_summary
    accs = [s["mm_accuracy_mean"] for s in summary.values() if "mm_accuracy_mean" in s]
    return {"folds": summary,
            "mm_accuracy_mean_over_folds": sum(accs) / len(accs) if accs else None}


def main(argv=None, device="cuda") -> int:
    from transformer_clip_eeg_tpu_torch import cli
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device

    device = resolve_device(device)  # no card: raise before any data is read

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--results_folder", type=str, default="results")
    parser.add_argument("--parallel", type=str, default="no", choices=["yes", "no"])
    parser.add_argument(
        "--fold_group_size", type=str, default="",
        help="with --parallel yes: folds a chunk's rows walk at once, an integer "
             "divisor of the fold count, 'auto' (all folds: a row's folds run one "
             "after another, so memory does not grow with it), or empty for all folds",
    )
    args, passthrough = parser.parse_known_args(argv)
    fold_group_size = None
    if args.fold_group_size:
        fold_group_size = ("auto" if args.fold_group_size == "auto"
                           else int(args.fold_group_size))

    fold_dirs: Dict[int, str] = {}
    if args.parallel == "yes":
        n = _parallel_config(args.results_folder, passthrough)[0].n_data_shards
        if n:
            if len(args.folds) % n:  # JAX's check, before any rank starts
                raise ValueError(f"{len(args.folds)} folds do not shard evenly over the "
                                 f"mesh's {n}-device 'data' axis")
            from transformer_clip_eeg_tpu_torch.parallel import run_on_ranks

            return run_on_ranks(n, _parallel_rank, (args.folds, args.results_folder,
                                                    passthrough, fold_group_size, device),
                                device)
        fold_dirs = _run_parallel(args.folds, args.results_folder, passthrough,
                                  fold_group_size=fold_group_size, device=device)
    else:
        for fold in args.folds:
            print(f"=== fold {fold} ===")
            before = set(glob.glob(os.path.join(args.results_folder, "results_*")))
            rc = cli.main(["--run", str(fold), "--results_folder", args.results_folder]
                          + list(passthrough), device=device)
            if rc != 0:
                print(f"fold {fold} failed with code {rc}")
                return rc
            new = sorted(set(glob.glob(os.path.join(args.results_folder, "results_*")))
                         - before)
            if new:
                fold_dirs[fold] = new[-1]
    _write_summary(args.results_folder, fold_dirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
