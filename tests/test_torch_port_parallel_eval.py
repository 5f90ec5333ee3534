"""Torch port, the data-parallel command line on two gloo CPU ranks:
``cli.main --n_data_shards 2`` trains and runs the eval suite on both ranks
(each chunk of windows split over them), rank 0 alone writing; the suite's
eight JSON files against a one-process ``--only_evaluate`` on the same
checkpoint; ``cli.main`` spawning its ranks itself; the refusals."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_parallel_ranks as ranks
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.parallel import launch
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

PROBE_EPOCHS = 3  # the reference's 250 are minutes on the CPU
SUITE_FILES = [  # what run_eval_suite writes (JAX transformer_clip_eeg_tpu/cli.py:362-411)
    "evaluation_challenge_set_2023_mm.json",
    "evaluation_challenge_set_2023_mm_logits.json",
    "evaluation_challenge_set_2023_mm_top_x.json",
    "evaluation_challenge_set_2023_mm_top_x_logits.json",
    "evaluation_regression.json",
    "evaluation_regression_general_model_env.json",
    "evaluation_challenge_set_2023_regression.json",
    "evaluation_challenge_set_2023_regression_sub_specific.json",
]
# batch 16: each rank's 8 rows keep the global batch's dropout tile of 8
FLAGS = ["--run", "0", "--epochs", "1", "--batch_size", "16", "--attention_depth", "1",
         "--latent_dim", "4", "--lstm_units", "8", "--speech_dim_override", "8",
         "--number_of_training_subjects", "2"]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """This process steps on as few threads as each rank: the suite runs
    test files side by side, and a rank's default of one thread a core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_data"))
    make_fixture(root, n_stories=3, n_subjects=2, story_seconds=60, speech_dim=8)
    return root


def _run_dir(results: str) -> str:
    (run,) = os.listdir(results)
    return os.path.join(results, run)


@pytest.fixture(scope="module")
def ddp_run(data_root, tmp_path_factory):
    """``cli.main(... --n_data_shards 2)`` in each of two launched ranks,
    which join their group: training, then the eval suite."""
    results = str(tmp_path_factory.mktemp("ddp_results"))
    argv = ["--data_dir", data_root, "--results_folder", results, *FLAGS,
            "--n_data_shards", "2"]
    assert launch(2, ranks.cli_job, (argv, PROBE_EPOCHS), device="cpu") == 0
    return _run_dir(results)


def _numbers(obj) -> list:
    if isinstance(obj, dict):
        return [v for k in sorted(obj) for v in _numbers(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [v for x in obj for v in _numbers(x)]
    return [float(obj)] if isinstance(obj, (int, float)) else []


def _losses(run_dir: str) -> list:
    """The train and validation CE of a run's ``loss.txt``."""
    text = open(os.path.join(run_dir, "loss.txt")).read()
    return [float(v) for v in re.findall(r"(?:loss_ce|mean loss ce :) (\S+?),? ", text)]


def test_ranks_train_and_rank_zero_writes_once(ddp_run):
    """One results directory; ``args.txt`` keeps ``n_data_shards`` (so
    ``--only_evaluate`` rebuilds the mesh); ``loss.txt`` names the backend,
    holds each line once (rank 0 alone wrote it) and the replicas' check;
    the eval suite's files are there."""
    cfg = TrainConfig.load(os.path.join(ddp_run, "args.txt"))
    assert cfg.n_data_shards == 2
    lines = open(os.path.join(ddp_run, "loss.txt")).read().splitlines()
    assert lines[0].startswith("data parallel: 2 ranks over gloo"), lines[0]
    assert any(ln.startswith("replicas identical on 2 ranks") for ln in lines)
    assert sum(ln.startswith("number of parameters") for ln in lines) == 1
    assert sum(ln.startswith("training done") for ln in lines) == 1
    assert set(SUITE_FILES) <= set(os.listdir(ddp_run))
    assert "error_regression.txt" not in os.listdir(ddp_run)


def test_eval_suite_on_two_ranks_matches_one_process(ddp_run, tmp_path, monkeypatch):
    """The eight JSON files of the 2-rank suite within 1e-5 of a one-process
    ``--only_evaluate`` on the same checkpoint (a copy of the run with
    ``n_data_shards`` 0 and without the suite's probes)."""
    copy = tmp_path / "one_process"
    copy.mkdir()
    shutil.copytree(os.path.join(ddp_run, "checkpoints"), copy / "checkpoints")
    cfg = TrainConfig.load(os.path.join(ddp_run, "args.txt"))
    cfg.n_data_shards = 0
    cfg.save(str(copy / "args.txt"))
    batched = reg.train_regression_probes_batched
    monkeypatch.setattr(reg, "train_regression_probes_batched",
                        lambda *a, **k: batched(*a, **{**k, "epochs": PROBE_EPOCHS}))
    assert cli.main(["--only_evaluate", "yes", "--results_folder", str(copy)],
                    device="cpu") == 0
    for name in SUITE_FILES:
        with open(os.path.join(ddp_run, name)) as f:
            two = _numbers(json.load(f))
        with open(copy / name) as f:
            one = _numbers(json.load(f))
        assert len(two) == len(one) > 0 or name.endswith("_sub_specific.json"), name
        np.testing.assert_allclose(two, one, atol=1e-5, rtol=1e-5, err_msg=name)


def test_cli_spawns_its_ranks(data_root, ddp_run, tmp_path, monkeypatch):
    """``cli.main`` with ``--n_data_shards 2`` in a process of no group
    spawns the two ranks itself: the same losses as the launched ranks',
    ``args.txt`` and each ``loss.txt`` line written once."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(ranks.THREADS))  # read by each spawned rank
    results = str(tmp_path / "spawned")
    assert cli.main(["--data_dir", data_root, "--results_folder", results, *FLAGS,
                     "--n_data_shards", "2", "--skip_eval", "yes"], device="cpu") == 0
    run = _run_dir(results)
    assert TrainConfig.load(os.path.join(run, "args.txt")).n_data_shards == 2
    lines = open(os.path.join(run, "loss.txt")).read().splitlines()
    assert sum(ln.startswith("training done") for ln in lines) == 1
    spawned, launched = _losses(run), _losses(ddp_run)
    assert len(spawned) == len(launched) > 0
    np.testing.assert_allclose(spawned, launched, rtol=1e-5)


def test_only_evaluate_rebuilds_the_ranks(ddp_run, tmp_path):
    """``--only_evaluate`` on a 2-rank run: the ranks come from its
    ``args.txt``; on two ranks the suite of the checkpoint writes the files
    the training run's suite wrote, number for number."""
    copy = tmp_path / "again"
    copy.mkdir()
    shutil.copytree(os.path.join(ddp_run, "checkpoints"), copy / "checkpoints")
    shutil.copy(os.path.join(ddp_run, "args.txt"), copy / "args.txt")
    args = cli.build_arg_parser().parse_args(["--only_evaluate", "yes", "--results_folder",
                                              str(copy)])
    assert cli._data_shards(args) == 2
    assert launch(2, ranks.cli_job, (["--only_evaluate", "yes", "--results_folder", str(copy)],
                                     PROBE_EPOCHS), device="cpu") == 0
    for name in SUITE_FILES:
        with open(os.path.join(ddp_run, name)) as f, open(copy / name) as g:
            assert json.load(f) == json.load(g), name


def test_cli_joins_a_torchrun_group(data_root, tmp_path, monkeypatch):
    """Under torchrun's variables (a group of one here, on a free port)
    ``cli.main`` joins the group the environment names instead of spawning,
    names its backend in ``loss.txt`` and leaves the group at the end."""
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "0"), ("WORLD_SIZE", "1"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    results = str(tmp_path / "joined")
    assert cli.main(["--data_dir", data_root, "--results_folder", results, *FLAGS,
                     "--n_data_shards", "1", "--skip_eval", "yes"], device="cpu") == 0
    assert not dist.is_initialized()
    first = open(os.path.join(_run_dir(results), "loss.txt")).readline()
    assert first.startswith("data parallel: 1 ranks over gloo"), first


def test_cli_refuses_a_batch_that_does_not_divide(data_root, tmp_path):
    """Before any rank starts, as JAX's NamedSharding refuses an uneven batch."""
    with pytest.raises(ValueError, match="divide over n_data_shards=4"):
        cli.main(["--data_dir", data_root, "--results_folder", str(tmp_path), *FLAGS,
                  "--batch_size", "6", "--n_data_shards", "4"], device="cpu")
    assert not os.listdir(tmp_path)
