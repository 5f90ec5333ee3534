"""CLI driver — the reference ``train_clip_final.py`` training workflow.

Counterpart of ``transformer_clip_eeg_tpu/cli.py``: the same flags and
defaults, the same outputs (a timestamped results directory with
``args.txt``, ``loss.txt`` and ``checkpoints/``), on the card unless the
caller passes ``device="cpu"`` to :func:`main`.  The post-training
evaluation suite is not ported yet: ``--only_evaluate yes`` and
``--skip_eval no`` raise ``NotImplementedError`` before any training
(ROADMAP.md), so a run passes ``--skip_eval yes``.

Run: ``python -m transformer_clip_eeg_tpu_torch.cli --data_dir <sparrkulee>
--skip_eval yes ...``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


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
                   help="0 = single device; N = N-way data-parallel mesh")
    p.add_argument("--speech_dim_override", type=int, default=None)
    p.add_argument("--skip_eval", type=str, default="no", choices=["yes", "no"])
    p.add_argument("--profile_dir", type=str, default="",
                   help="a profiler trace of the first epoch (not ported: a "
                        "non-empty value raises)")
    p.add_argument("--data_mode", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="batch assembly: device-resident chunk store vs "
                        "host per-batch gathers (the port has only host, "
                        "which auto means; device raises)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="encoder compute dtype (the port's kernels are "
                        "float32; bfloat16 raises)")
    p.add_argument("--chunk_store_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="device chunk-store storage dtype (used only by "
                        "--data_mode device, which the port does not have)")
    p.add_argument("--chunk_budget_frac", type=float, default=0.75,
                   help="fraction of free device memory the chunk store "
                        "may keep resident (used only by --data_mode device, "
                        "which the port does not have)")
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


def train(argv=None, device="cuda"):
    """Parse ``argv``, build the datasets and train; returns the
    :class:`~transformer_clip_eeg_tpu_torch.train.loop.Trainer` after
    ``fit`` (its model holds the best state, as the checkpoint does)."""
    from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
    from transformer_clip_eeg_tpu_torch.data.discovery import (
        get_train_val_test_files_final,
    )
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
    from transformer_clip_eeg_tpu_torch.train.loop import Trainer, check_supported, printf

    args = build_arg_parser().parse_args(argv)
    if args.only_evaluate == "yes" or args.skip_eval != "yes":
        raise NotImplementedError(
            "the evaluation suite (--only_evaluate yes, --skip_eval no) is not "
            "ported to the torch package yet (see ROADMAP.md); pass "
            "--skip_eval yes to train"
        )
    if args.compile_cache_dir is None:
        args.compile_cache_dir = "auto"  # the TrainConfig default
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    cfg = TrainConfig(**{k: v for k, v in vars(args).items() if k in known})
    check_supported(cfg)
    results_dir = os.path.join(
        cfg.results_folder, cfg.results_dir_name(time.strftime("%Y_%m_%d_%H_%M_%S"))
    )
    (train_files, val_files, test_files, test_files_heldout,
     train_audio, val_audio, _test_audio, _heldout_audio) = get_train_val_test_files_final(
        cfg.data_dir, cfg.run, cfg.stimulus_features, cfg.fold_split_path,
        cfg.number_of_training_subjects, debug=cfg.is_debug,
    )
    print(f"train files: {len(train_files)}, val: {len(val_files)}, "
          f"test: {len(test_files)}, heldout: {len(test_files_heldout)}")
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
    trainer = Trainer(cfg, train_ds, val_ds, results_dir=results_dir, device=device)
    out = trainer.fit()
    printf(f"training done: best val loss_ce {out['best_loss']} at epoch "
           f"{out['best_epoch']}", trainer.loss_file)
    return trainer


def main(argv=None, device="cuda") -> int:
    train(argv, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
