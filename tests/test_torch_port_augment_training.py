"""Torch port, training with the reference's augmentation flags on the CPU:
``cli.main`` with each ``--data_augmentation`` and with ``--addEEG yes``
trains (finite losses), the device store and the host path train on the
same mixed and augmented batches (equal losses and weights), the train step
mixes, then augments, then runs the plain step, and ``--profile_dir`` writes
a trace and its ``loss.txt`` line."""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.ops import augment as aug
from transformer_clip_eeg_tpu_torch.ops.dropout import fold_seed
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.loop import PROFILE_TRACE, Trainer, check_supported
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer
from transformer_clip_eeg_tpu_torch.train.steps import train_step

SP_D, WL, BS = 16, 64, 4
LOSS = re.compile(r"(?:loss_ce|loss average eeg|mean loss ce :|mean loss average:|"
                  r"mean loss total:) (-?[\d.e+-]+|nan)")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparrkulee_aug_train"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    return root


def _argv(root, out, *extra):
    return ["--data_dir", root, "--run", "0", "--epochs", "1", "--skip_eval", "yes",
            "--batch_size", str(BS), "--attention_depth", "1", "--latent_dim", "4",
            "--speech_dim_override", str(SP_D), "--number_of_training_subjects", "3",
            "--results_folder", str(out), *extra]


def _losses(loss_file):
    return [float(v) for v in LOSS.findall(open(loss_file).read())]


@pytest.mark.parametrize("flags", [["--data_augmentation", n] for n in aug.TRANSFORMS]
                         + [["--addEEG", "yes", "--data_augmentation_percentage", "0.9"]],
                         ids=list(aug.TRANSFORMS) + ["addEEG"])
def test_cli_trains_with_each_augmentation(root, tmp_path, flags):
    assert cli.main(_argv(root, tmp_path, *flags), device="cpu") == 0
    (run,) = os.listdir(tmp_path)
    args = json.load(open(os.path.join(tmp_path, run, "args.txt")))
    assert args["data_augmentation"] == (flags[1] if flags[0] == "--data_augmentation" else "no")
    losses = _losses(os.path.join(tmp_path, run, "loss.txt"))
    # an epoch's train and validation lines, then the CLI's best-val line
    assert len(losses) == 6 and np.isfinite(losses).all(), losses


def test_check_supported_refuses_only_mesh_bf16_and_prng(root):
    """The option the port still refuses: another prng_impl.  The bf16
    compute mode and a data-parallel mesh (``n_data_shards``), each refused
    until it was ported, now pass; a compute dtype the JAX CLI does not
    offer, or a batch that does not divide over the ranks, is a
    ValueError."""
    base = dict(data_dir=root, data_augmentation="ChannelsShuffle", addEEG="yes",
                profile_dir="trace")
    check_supported(TrainConfig(**base))
    check_supported(TrainConfig(**base, compute_dtype="bfloat16"))
    check_supported(TrainConfig(**base, n_data_shards=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(TrainConfig(**base, prng_impl="unsafe_rbg"))
    with pytest.raises(ValueError, match="compute_dtype"):
        check_supported(TrainConfig(**base, compute_dtype="float16"))
    with pytest.raises(ValueError, match="divide over n_data_shards=3"):
        check_supported(TrainConfig(**base, n_data_shards=3))


def _trainer(root, out, mode, **kw):
    cfg = TrainConfig(data_dir=root, run=0, batch_size=BS, epochs=2, patience=5,
                      attention_depth=1, latent_dim=4, window_length_s=1, fs=WL,
                      number_of_training_subjects=3, speech_dim_override=SP_D, shuffle="yes",
                      data_mode=mode, data_augmentation="FTSurrogate", addEEG="yes", **kw)
    files = get_train_val_test_files_final(root, 0, "wav2vec_19", cfg.fold_split_path, 3)
    mk = lambda split, **k: EEGWindowDataset(  # noqa: E731
        files[split], files[4 + split], WL, WL, batch_size=BS, seed=0, **k)
    train = mk(0, shuffle=True, shuffle_percentage=1.0, addEEG=True,
               data_augmentation=cfg.augmentations)
    return Trainer(cfg, train, mk(1), results_dir=str(out / mode), device="cpu")


def test_device_and_host_modes_mix_and_augment_the_same_batches(root, tmp_path):
    """FTSurrogate and mixup at p=0.5 on both data paths: the same partners
    (drawn from ``dataset.rng`` where JAX draws them) and the same step
    seeds give equal losses, validation losses and weights."""
    trainers = {mode: _trainer(root, tmp_path, mode) for mode in ("device", "host")}
    outs = {mode: t.fit() for mode, t in trainers.items()}
    assert trainers["device"].device_data and not trainers["host"].device_data
    losses = {m: _losses(t.loss_file) for m, t in trainers.items()}
    assert len(losses["device"]) == 10 and np.isfinite(losses["device"]).all()
    assert losses["device"] == losses["host"]
    assert [h["val_loss_ce"] for h in outs["device"]["history"]] == \
        [h["val_loss_ce"] for h in outs["host"]["history"]]
    for (name, a), (_, b) in zip(trainers["device"].model.state_dict().items(),
                                 trainers["host"].model.state_dict().items()):
        assert torch.equal(a, b), name


def test_step_mixes_then_augments_before_the_encoders(root):
    """``train_step`` with mixup and an augmentation is the plain step on
    the batch mixed from ``fold_seed(step_seed, MIXUP_STREAM)`` and then
    augmented from ``fold_seed(step_seed, AUGMENT_STREAM)``, with the same
    dropout seeds; without either the batch is untouched."""
    cfg = TrainConfig(attention_depth=1, latent_dim=4, window_length_s=1, fs=WL,
                      speech_dim_override=SP_D)
    rng = np.random.default_rng(0)
    batch = {"eeg": torch.from_numpy(rng.standard_normal((BS, WL, 64)).astype(np.float32)),
             "partner_eeg": torch.from_numpy(rng.standard_normal((BS, WL, 64))
                                             .astype(np.float32)),
             "speech": torch.from_numpy(rng.standard_normal((BS, WL, SP_D))
                                        .astype(np.float32)),
             "ids": torch.arange(1, BS + 1)}
    models = [build_model_from_config(cfg, 16, device="cpu", seed=0) for _ in range(2)]
    opts = [make_optimizer(m.parameters(), "adamw", 1e-3) for m in models]
    for _ in range(2):  # the second step draws from another step seed
        step_seed = fold_seed(3, opts[0].step)
        eeg = aug.apply_batch_mixup(batch["eeg"], batch["partner_eeg"], **aug.draw_batch_mixup(
            fold_seed(step_seed, aug.MIXUP_STREAM), BS, 0.5, "cpu"))
        eeg = aug.make_augmentation_fn(["ChannelsShuffle"], 0.5)(
            fold_seed(step_seed, aug.AUGMENT_STREAM), eeg)
        got = train_step(models[0], opts[0], batch, 3, False, augmentations=["ChannelsShuffle"],
                         augmentation_probability=0.5, add_eeg=True)
        want = train_step(models[1], opts[1], dict(batch, eeg=eeg), 3, False)
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    assert jax.default_backend() == "cpu"


def test_profile_dir_writes_a_trace_and_the_loss_line(root, tmp_path):
    trace_dir = tmp_path / "trace"
    assert cli.main(_argv(root, tmp_path / "run", "--profile_dir", str(trace_dir),
                          "--addEEG", "yes"), device="cpu") == 0
    (run,) = os.listdir(tmp_path / "run")
    lines = open(tmp_path / "run" / run / "loss.txt").read().splitlines()
    assert f"profiler trace written to {trace_dir}" in lines
    assert lines.index(f"profiler trace written to {trace_dir}") == \
        lines.index(next(l for l in lines if l.startswith("epoch 0 phases"))) + 1
    trace = json.load(open(trace_dir / PROFILE_TRACE))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "linear" in n for n in names)  # the epoch's ops
    # the port's spans of the epoch, as ranges
    assert {"train.step", "train.forward", "train.backward", "train.optimizer",
            "train.block"} <= names
