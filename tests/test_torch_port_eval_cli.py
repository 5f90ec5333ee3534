"""Torch port, the CLI's default run on the CPU: ``cli.main`` trains and
then runs the evaluation suite, writing every file the JAX package's
``run_eval_suite`` writes; ``--only_evaluate yes`` reruns it from the saved
config and checkpoint, the port's or the reference's ``model.ckpt``."""

import json
import os

import pytest
import torch

from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.checkpoint import load_checkpoint
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.torch_export import (
    reference_layout,
    save_torch_checkpoint,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers;
    torch's default of one thread a core makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# what JAX's run_eval_suite writes (transformer_clip_eeg_tpu/cli.py:362-411)
SUITE_FILES = [
    "evaluation_challenge_set_2023_mm.json",
    "evaluation_challenge_set_2023_mm_logits.json",
    "evaluation_challenge_set_2023_mm_top_x.json",
    "evaluation_challenge_set_2023_mm_top_x_logits.json",
    "evaluation_regression.json",
    "evaluation_regression_general_model_env.json",
    "evaluation_challenge_set_2023_regression.json",
    "evaluation_challenge_set_2023_regression_sub_specific.json",
]
MM_FILES = SUITE_FILES[:4]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``cli.main`` at a small size with ``--skip_eval`` at its default."""
    mp = pytest.MonkeyPatch()
    seq = reg.train_regression_probes_batched
    mp.setattr(reg, "train_regression_probes_batched",
               lambda *a, **k: seq(*a, **{**k, "epochs": 3}))
    root = str(tmp_path_factory.mktemp("cli_data"))
    results = str(tmp_path_factory.mktemp("cli_results"))
    make_fixture(root, n_stories=3, n_subjects=2, story_seconds=45, speech_dim=8)
    rc = cli.main(["--data_dir", root, "--results_folder", results, "--run", "0", "--epochs",
                   "1", "--batch_size", "4", "--attention_depth", "1", "--latent_dim", "4",
                   "--lstm_units", "8", "--speech_dim_override", "8",
                   "--number_of_training_subjects", "2"], device="cpu")
    (run,) = os.listdir(results)
    yield rc, os.path.join(results, run), mp
    mp.undo()


def test_cli_default_run_trains_and_writes_the_suite(cli_run):
    rc, rd, _ = cli_run
    assert rc == 0
    names = set(os.listdir(rd))
    assert {"args.txt", "loss.txt", "checkpoints", *SUITE_FILES} <= names
    assert "error_regression.txt" not in names
    with open(os.path.join(rd, "loss.txt")) as fh:
        log = fh.read()
    assert "training done" in log and '"uploads"' not in log  # the host path on the CPU
    for name in SUITE_FILES:
        with open(os.path.join(rd, name)) as fh:
            obj = json.load(fh)
        assert obj or name.endswith("_sub_specific.json"), name


def test_cli_only_evaluate_rewrites_the_match_mismatch_files(cli_run):
    rc, rd, _ = cli_run
    before = {}
    for name in MM_FILES:
        with open(os.path.join(rd, name)) as fh:
            before[name] = json.load(fh)
        os.remove(os.path.join(rd, name))
    assert cli.main(["--only_evaluate", "yes", "--results_folder", rd], device="cpu") == 0
    for name in MM_FILES:
        with open(os.path.join(rd, name)) as fh:
            assert json.load(fh) == before[name], name


def test_cli_only_evaluate_without_a_port_checkpoint(cli_run, tmp_path, capsys):
    """No checkpoint: "no checkpoint found" and exit code 1, as in JAX; only
    the reference's model.ckpt (the run's weights exported in the reference
    layout): it is evaluated, and the match-mismatch files equal the run's."""
    _, rd, _ = cli_run
    empty = tmp_path / "run"
    (empty / "checkpoints").mkdir(parents=True)
    with open(os.path.join(rd, "args.txt")) as src:
        (empty / "args.txt").write_text(src.read())
    assert cli.main(["--only_evaluate", "yes", "--results_folder", str(empty)], device="cpu") == 1
    assert "no checkpoint found" in capsys.readouterr().out
    weights = load_checkpoint(os.path.join(rd, "checkpoints"))["model"]
    model = build_model_from_config(TrainConfig.load(os.path.join(rd, "args.txt")),
                                    weights["eegMemoryBank.memory"].shape[0] - 1, device="cpu")
    model.load_state_dict(weights)
    assert save_torch_checkpoint(model, reference_layout(model),
                                 empty / "checkpoints" / "model.ckpt") == []
    assert cli.main(["--only_evaluate", "yes", "--results_folder", str(empty)], device="cpu") == 0
    assert "loaded model from" in capsys.readouterr().out
    for name in MM_FILES:
        with open(os.path.join(rd, name)) as a, open(empty / name) as b:
            assert json.load(b) == json.load(a), name
