"""The command line — the reference ``train_clip_final.py`` workflow end to end.

Counterpart of ``transformer_clip_eeg_tpu/cli.py``: the same flags and
defaults, the same outputs (a timestamped results directory with
``args.txt``, ``loss.txt``, ``checkpoints/`` and the post-training
evaluation JSONs, ref ``:558-601``), on the card unless the caller passes
``device="cpu"`` to :func:`main`.  The default run trains (on the
device-resident chunk store on the card), keeps the best checkpoint, then
runs the evaluation suite; ``--skip_eval yes`` stops after training.
``--only_evaluate yes`` reloads ``args.txt`` and the checkpoint from
``--results_folder`` (a run's results directory) and runs the suite again.

``--n_data_shards N`` trains and evaluates N-way data-parallel, one
``torch.distributed`` rank a process (``parallel/``): :func:`main` spawns
the N ranks itself, or, started by ``torchrun`` (or in a process that has
joined a group), joins that group.  The backend is NCCL when each rank has
a card of its own, gloo on the CUDA tensors when ranks share a card, gloo
on the CPU; ``loss.txt`` names it.  The eval suite runs on the same ranks,
each chunk of windows split over them.  ``N`` is saved in ``args.txt``, so
``--only_evaluate`` runs on as many ranks.  Rank 0 writes every file.

Run: ``python -m transformer_clip_eeg_tpu_torch.cli --data_dir <sparrkulee> ...``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Optional


def build_arg_parser() -> argparse.ArgumentParser:
    """Ref train_clip_final.py:158-218 — flags, defaults, choices verbatim
    (plus the JAX package's extensions at the end), as the JAX CLI has them."""
    p = argparse.ArgumentParser(description="Train CLIP model.")
    p.add_argument("--debug", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--only_evaluate", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--results_folder", type=str, default="results")
    p.add_argument("--run", type=int, default=4)
    p.add_argument("--lstm_units", type=int, default=128)
    p.add_argument("--lambda_sim_loss", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--momentum_membank", type=float, default=0.90)
    p.add_argument("--eeg_norm", type=str, default="mvn", choices=["mvn"])
    p.add_argument("--stimulus_features", type=str, default="wav2vec_19")
    p.add_argument(
        "--model_arch",
        type=str,
        default="clip_sim_no_latent_proj",
        choices=[
            "no_contrastive_learning",
            "clip_kld",
            "clip_kld_latent_proj",
            "clip_mp",
            "clip_sim",
            "clip_sim_no_latent_proj",
        ],
    )
    p.add_argument(
        "--speech_encoder",
        type=str,
        default="convLSTM",
        choices=[
            "conformer", "smallConv", "lstm", "convLSTM", "no",
            "double_lstm", "Wav2vecSmallModel",
        ],
    )
    p.add_argument(
        "--eeg_encoder",
        type=str,
        default="EEGConformerInterleaved",
        choices=[
            "EEGConformerInterleaved", "conformer", "convLSTMnew", "convLSTM",
            "vlaai", "lstm", "double_lstm",
        ],
    )
    p.add_argument("--attention_depth", type=int, default=10)
    p.add_argument("--load_pretrain", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--shuffle", type=str, default="yes", choices=["yes", "no"])
    p.add_argument("--shuffle_percentage", type=float, default=1.0)
    p.add_argument("--addEEG", type=str, default="no", choices=["yes", "no"])
    p.add_argument(
        "--data_augmentation",
        type=str,
        default="no",
        choices=[
            "no", "SignFlip", "FTSurrogate", "FrequencyShift",
            "BandstopFilter", "GaussianNoise", "SmoothTimeMask",
            "ChannelsDropout", "ChannelsShuffle",
        ],
    )
    p.add_argument("--data_augmentation_percentage", type=float, default=0.5)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--beta1", type=float, default=0.90)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--use_amsgrad", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adam", "adamw"])
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument(
        "--lr_scheduler",
        type=str,
        default="step",
        choices=["no", "plateau", "step", "cosine", "cosine_warmup"],
    )
    p.add_argument("--step_size_scheduler", type=int, default=10)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--number_conv_layers", type=int, default=1)
    p.add_argument("--fun_act", type=str, default="relu")
    p.add_argument("--temperature", type=float, default=0.075)
    p.add_argument(
        "--subject_split",
        type=str,
        default="icassp_testset",
        choices=["within", "heldout", "icassp_testset"],
    )
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--number_of_training_subjects", type=int, default=1000)
    p.add_argument("--lambda_clip_loss", type=float, default=1.0)
    p.add_argument("--latent_dim", type=int, default=8)
    # extensions of the JAX package
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset_split_stories", type=str, default="")
    p.add_argument("--n_data_shards", type=int, default=0,
                   help="0 = one process; N = N data-parallel ranks (spawned here, "
                        "or the torchrun group this process is in)")
    p.add_argument("--speech_dim_override", type=int, default=None)
    p.add_argument("--skip_eval", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch "
                        "(host and device) into this directory")
    p.add_argument("--data_mode", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="batch assembly: device-resident chunk store vs "
                        "host per-batch gathers (auto = the store on a CUDA "
                        "device, host on the CPU)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="encoder compute dtype of the train steps (params, "
                        "loss and validation stay float32)")
    p.add_argument("--chunk_store_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="device chunk-store storage dtype; bfloat16 halves "
                        "device residency and upload bytes (inputs rounded, "
                        "compute stays float32)")
    p.add_argument("--chunk_budget_frac", type=float, default=0.75,
                   help="fraction of free device memory the chunk stores "
                        "may keep resident (auto budget)")
    p.add_argument("--prng_impl", type=str, default="rbg",
                   choices=["rbg", "threefry2x32", "unsafe_rbg"],
                   help="PRNG of the JAX package's dropout streams; the "
                        "port draws its masks from its own counter hash "
                        "(ops/dropout.py), so only the default is accepted")
    p.add_argument("--loss_log_stream", type=str, default="epoch",
                   choices=["epoch", "batch"],
                   help="per-100-batch loss lines: 'epoch' defers the "
                        "device fetch to end of epoch (no mid-epoch sync; "
                        "default), 'batch' streams live")
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="the JAX package's persistent compilation cache; "
                        "the port compiles no programs per run (its kernels "
                        "are built once by _build.py), so it saves the value "
                        "to args.txt and otherwise ignores it")
    return p


def find_icassp_folder(data_dir: str, task: str) -> Optional[str]:
    """The challenge set's ``task`` folder: ``<data_dir>/icassp/<task>`` (the
    fixture's) first, else the reference's sibling
    ``ICASSP-2023-eeg-decoding-challenge-dataset/<task>`` (ref :561-562)."""
    candidates = [
        os.path.join(data_dir, "icassp", task),
        os.path.join(os.path.dirname(data_dir), "ICASSP-2023-eeg-decoding-challenge-dataset",
                     task),
    ]
    for c in candidates:
        if os.path.isdir(c):
            return c
    return None


def _split(cfg):
    """The run's file lists (8 lists, as ``get_train_val_test_files_final``)."""
    from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final

    files = get_train_val_test_files_final(
        cfg.data_dir, cfg.run, cfg.stimulus_features, cfg.fold_split_path,
        cfg.number_of_training_subjects, debug=cfg.is_debug,
    )
    print(f"train files: {len(files[0])}, val: {len(files[1])}, "
          f"test: {len(files[2])}, heldout: {len(files[3])}")
    return files


def _config(args):
    """The run's ``TrainConfig`` from the parsed flags, checked."""
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
    from transformer_clip_eeg_tpu_torch.train.loop import check_supported

    if args.compile_cache_dir is None:
        args.compile_cache_dir = "auto"  # the TrainConfig default
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    cfg = TrainConfig(**{k: v for k, v in vars(args).items() if k in known})
    check_supported(cfg)
    return cfg


def _train(args, device, mesh=None):
    """Build the datasets from ``args`` and train (on ``mesh``'s ranks, if
    given); returns the trainer and the file lists."""
    from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
    from transformer_clip_eeg_tpu_torch.parallel.collectives import broadcast_object
    from transformer_clip_eeg_tpu_torch.train.loop import Trainer

    cfg = _config(args)
    results_dir = os.path.join(
        cfg.results_folder, cfg.results_dir_name(time.strftime("%Y_%m_%d_%H_%M_%S"))
    )
    if mesh is not None:  # named by rank 0's clock
        results_dir = broadcast_object(results_dir, mesh)
    files = _split(cfg)
    train_files, val_files, _, _, train_audio, val_audio, _, _ = files
    if not val_files:
        raise SystemExit(
            f"validation split is empty: CV fold {cfg.run} matched no stories "
            f"under {cfg.data_dir} (check --run against {cfg.fold_split_path})"
        )
    if not train_files:
        raise SystemExit(
            f"train split is empty: every story under {cfg.data_dir} fell into "
            f"CV fold {cfg.run} or the test set (check --run against "
            f"{cfg.fold_split_path})"
        )
    train_ds = EEGWindowDataset(
        train_files, train_audio, cfg.window_length, cfg.hop_length,
        batch_size=cfg.batch_size, shuffle=cfg.shuffle_b,
        shuffle_percentage=cfg.shuffle_percentage, addEEG=cfg.addEEG_b,
        data_augmentation=cfg.augmentations,
        data_augmentation_probability=cfg.data_augmentation_percentage, seed=cfg.seed,
    )
    val_ds = EEGWindowDataset(
        val_files, val_audio, cfg.window_length, cfg.hop_length,
        batch_size=cfg.batch_size, seed=cfg.seed,
    )
    trainer = Trainer(cfg, train_ds, val_ds, results_dir=results_dir, device=device,
                      mesh=mesh, profile_dir=cfg.profile_dir or None)
    out = trainer.fit()
    trainer.log(f"training done: best val loss_ce {out['best_loss']} at epoch "
                 f"{out['best_epoch']}")
    return trainer, files


def train(argv=None, device="cuda", mesh=None):
    """Parse ``argv``, build the datasets and train, without the evaluation
    suite; returns the :class:`~transformer_clip_eeg_tpu_torch.train.loop.
    Trainer` after ``fit`` (its model holds the best state, as the
    checkpoint does).  ``--n_data_shards N`` needs this rank's ``mesh`` of
    N ranks."""
    return _train(build_arg_parser().parse_args(argv), device, mesh)[0]


def _restore_run(results_dir: str, device, mesh=None):
    """The config and the best model of a finished run (the port's
    checkpoint, else the reference's ``model.ckpt``, as JAX ``cli.py:297-313``),
    or ``(cfg, None)`` when neither is there.  Under ``mesh`` the model is on
    the rank's device with rank 0's weights."""
    from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
    from transformer_clip_eeg_tpu_torch.parallel.mesh import attach, replicate
    from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
    ckpt_dir = os.path.join(results_dir, "checkpoints")
    if mesh is not None:
        device = mesh.device
    model = build_model_from_config(cfg, cfg.bank_size, device=device, seed=cfg.seed)
    if (ckpt_lib.restore_checkpoint(ckpt_dir, model) is None
            and ckpt_lib.restore_torch_checkpoint(ckpt_dir, model) is None):
        return cfg, None
    if mesh is not None:
        attach(model, mesh)
        replicate(mesh, model.state_dict().values())
    return cfg, model.eval()


def _data_shards(args) -> int:
    """The run's data-parallel ranks: ``--n_data_shards``, or under
    ``--only_evaluate`` the saved run's (JAX rebuilds its mesh from the
    persisted config too)."""
    if args.only_evaluate != "yes":
        return args.n_data_shards
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

    saved = os.path.join(args.results_folder, "args.txt")
    return TrainConfig.load(saved).n_data_shards if os.path.exists(saved) else 0


def main(argv=None, device="cuda") -> int:
    """The command line; with ``--n_data_shards N`` on N ranks (spawned
    here unless this process is one of a group already, or ``torchrun``'s
    environment names one), returning rank 0's exit code."""
    from transformer_clip_eeg_tpu_torch.parallel import run_on_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    n = _data_shards(args)
    if not n:
        return _main(args, device)
    if args.only_evaluate != "yes":
        _config(args)  # a batch that does not divide fails here, before any rank starts
    return run_on_ranks(n, _rank_main, (argv, device), device)


def _rank_main(argv, device, mesh) -> int:
    """One spawned rank of :func:`main`."""
    return _main(build_arg_parser().parse_args(argv), device, mesh)


def _main(args, device, mesh=None) -> int:
    if args.only_evaluate == "yes":
        # the saved config and checkpoint of --results_folder (ref :274-285,541-556)
        results_dir = args.results_folder
        cfg, model = _restore_run(results_dir, device, mesh)
        if model is None:
            print(f"no checkpoint found in {os.path.join(results_dir, 'checkpoints')}")
            return 1
        print(f"loaded model from {os.path.join(results_dir, 'checkpoints')}")
        if args.skip_eval == "yes":
            return 0
        files = _split(cfg)
    else:
        trainer, files = _train(args, device, mesh)
        if args.skip_eval == "yes":
            return 0
        # free the chunk stores' device memory and the training datasets'
        # host arrays: the suite ingests its own splits
        trainer.release_host_data()
        cfg, model, results_dir = trainer.cfg, trainer.model, trainer.results_dir
    train_files, val_files, test_files, _, train_audio, val_audio, test_audio, _ = files
    run_eval_suite(model, cfg, results_dir, train_files, val_files, test_files,
                   train_audio, val_audio, test_audio, mesh=mesh)
    return 0


def _dump(results_dir: str, name: str, obj) -> None:
    with open(os.path.join(results_dir, name), "w") as f:
        json.dump(obj, f)


def run_eval_suite(model, cfg, results_dir, train_files, val_files, test_files,
                   train_audio, val_audio, test_audio, mesh=None) -> None:
    """The four post-training evaluation blocks (ref :558-601), each writing
    the JSON files the reference writes.  Under ``mesh`` every rank runs the
    suite (its embeddings split over the ranks, ``model`` attached to the
    mesh); rank 0 writes into ``results_dir``, the others, silent, into a
    directory of their own that is deleted after."""
    if mesh is not None and not mesh.is_writer:
        with tempfile.TemporaryDirectory(prefix="tce_eval_rank") as scratch, \
                open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            return _eval_suite(model, cfg, scratch, train_files, val_files, test_files,
                               train_audio, val_audio, test_audio)
    return _eval_suite(model, cfg, results_dir, train_files, val_files, test_files,
                       train_audio, val_audio, test_audio)


def _eval_suite(model, cfg, results_dir, train_files, val_files, test_files,
                train_audio, val_audio, test_audio) -> None:
    from transformer_clip_eeg_tpu_torch.eval.match_mismatch import (
        evaluate_model_challenge_2023_mm,
    )
    from transformer_clip_eeg_tpu_torch.eval.regression import (
        evaluate_model_challenge_2023_regression,
        evaluate_model_do_regression_sub_independent,
        evaluate_model_do_regression_sub_specific,
    )

    mm_folder = find_icassp_folder(cfg.data_dir, "TEST_task1_matchmismatch")
    if mm_folder:
        results = evaluate_model_challenge_2023_mm(model, mm_folder,
                                                   speech_feature=cfg.stimulus_features)
        for name, obj in zip(("evaluation_challenge_set_2023_mm.json",
                              "evaluation_challenge_set_2023_mm_logits.json",
                              "evaluation_challenge_set_2023_mm_top_x.json",
                              "evaluation_challenge_set_2023_mm_top_x_logits.json"), results):
            _dump(results_dir, name, obj)
    else:
        print("no ICASSP task-1 folder found, skipping match-mismatch eval")

    # both regression blocks embed the same corpus: one shared extraction
    # (the regression dataset's batch is the configured one; the reference
    # hardcodes 128, ref :496)
    emb_cache: dict = {}
    for block in (evaluate_model_do_regression_sub_specific,
                  evaluate_model_do_regression_sub_independent):
        block(model, train_files, val_files, test_files, train_audio, val_audio, test_audio,
              results_dir, regress_to="env", window_length=cfg.window_length_s, fs=cfg.fs,
              batch_size=cfg.batch_size, embeddings_cache=emb_cache)
    emb_cache.clear()

    reg_folder = find_icassp_folder(cfg.data_dir, "TEST_task2_regression")
    if reg_folder:
        ev, ev_sub = evaluate_model_challenge_2023_regression(model, results_dir, reg_folder)
        _dump(results_dir, "evaluation_challenge_set_2023_regression.json", ev)
        _dump(results_dir, "evaluation_challenge_set_2023_regression_sub_specific.json", ev_sub)
    else:
        print("no ICASSP task-2 folder found, skipping challenge regression")


if __name__ == "__main__":
    sys.exit(main())
