"""Torch port, the fold-sharded mesh (``FoldParallelTrainer(mesh=)``, ``cv
--parallel yes --n_data_shards N``) on two gloo CPU ranks, on the fold
fixture of ``tests/test_torch_port_fold_parallel.py`` (4 stories, 3
subjects, 60 s; folds 0-2 hold one story each) at its small width, and
``cv.main`` on the smaller fixture of ``tests/test_torch_port_cv.py``.

One launched pair of ranks (``fold_mesh_and_cv_job`` of
``tests/torch_port_parallel_ranks.py``) trains folds 0 and 1, one each, for
two epochs from weights carried from JAX with dropout off: every epoch's CE
and each fold's best weights equal the port's unsharded trainer's bit for
bit (at the ranks' thread count), and JAX's ``FoldParallelTrainer`` on
``make_mesh(2)`` within the limits of
``tests/test_torch_port_fold_parallel.py``.  The same ranks then run
``cv.main --parallel yes --n_data_shards 2``, joining their group (the
suites' probes cut to a few epochs), against the one-process run's tree.
The pair runs in a thread of this process while JAX's trainer and the
port's one-process runs train here.  Last, ``cv.main`` spawns its own
ranks.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_port_parallel_ranks as ranks
from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.parallel import make_mesh as j_make_mesh
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.fold_parallel import (
    FoldParallelTrainer as JFoldParallelTrainer,
)
from transformer_clip_eeg_tpu_torch import cv
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.parallel import Mesh, launch
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

N = 2
FOLDS = [0, 1]
SMALL = dict(batch_size=8, epochs=2, patience=5, attention_depth=1, latent_dim=4,
             lstm_units=8, number_of_training_subjects=3, speech_dim_override=16)
# tests/test_torch_port_fold_parallel.py's limits against JAX, on its fixture,
# where they were measured: per-fold CE 1e-4 of max(1, |l|);
# each best parameter within 1e-3 of its leaf's largest value, the leaves
# where a reassociated f32 sum moves Adam's update at their measured bound
# there, every leaf's mean error within 1e-3
LOSS_TOL = 1e-4
PARAM_TOL = 1e-3
LEAF_FLOOR = 1e-6
ADAM_BOUND_LEAVES = {"eegModel.conv_0.conv.weight": 6.6e-3}
PROBE_EPOCHS = 2  # the reference's 250 are minutes on the CPU
# tests/test_torch_port_cv.py's run
CV_FLAGS = ["--epochs", "1", "--batch_size", "4", "--attention_depth", "1", "--latent_dim",
            "4", "--lstm_units", "8", "--speech_dim_override", "8",
            "--number_of_training_subjects", "2"]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fold_mesh_data"))
    make_fixture(root, n_stories=4, n_subjects=3, story_seconds=60, speech_dim=16)
    return root


@pytest.fixture(scope="module")
def cv_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fold_mesh_cv_data"))
    make_fixture(root, n_stories=3, n_subjects=2, story_seconds=45, speech_dim=8)
    return root


class _NoDropout(jl.Dropout):
    """flax's Dropout as the identity: its masks cannot be drawn in torch."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _fold_variables(states, j):
    take = lambda tree: jax.tree.map(lambda x: np.array(x[j]), tree)  # noqa: E731
    return {"params": take(states.params), "membank": take(states.membank)}


@pytest.fixture(scope="module")
def jax_trainer(root, tmp_path_factory):
    """JAX's ``FoldParallelTrainer`` on ``make_mesh(2)`` (one fold a device,
    ``shard_map``), folds 0 and 1, built, with its initial weights; flax's
    Dropout the identity while the module's tests run."""
    cfg = TrainConfig(data_dir=root, **SMALL)
    files = get_train_val_test_files_final(root, 0, cfg.stimulus_features,
                                           cfg.fold_split_path, cfg.number_of_training_subjects)
    union = (files[0] + files[1], files[4] + files[5])
    with pytest.MonkeyPatch.context() as mp:
        for module in (je, ja, jh):
            mp.setattr(module, "Dropout", _NoDropout)
        jt = JFoldParallelTrainer(JConfig(data_dir=root, **SMALL), FOLDS, *union,
                                  str(tmp_path_factory.mktemp("jax_fold_mesh")), row_bucket=1,
                                  mesh=j_make_mesh(N))
        yield jt, union, _fold_variables(jt.states, 0)


def _template(jax_variables):
    """A port model shaped as JAX's (its bank the union's segments)."""
    bank_rows = jax.tree.leaves(jax_variables["membank"])[0].shape[0]
    return ranks.build_case_model({"model": "config", "bank_size": bank_rows - 1,
                                   "config": SMALL})


@pytest.fixture(scope="module")
def case(root, jax_trainer, tmp_path_factory):
    _, union, init = jax_trainer
    template = _template(init)
    c = {"config": dict(data_dir=root, **SMALL), "folds": FOLDS, "union": union,
         "state": state_dict_from_jax(init, template)}
    path = str(tmp_path_factory.mktemp("fold_mesh_case") / "case.pt")
    torch.save(c, path)
    return path, c


@pytest.fixture(scope="module")
def launched(case, cv_root, tmp_path_factory):
    """The pair of ranks, started in a thread: the fold mesh into ``out``,
    then ``cv.main ... --n_data_shards 2`` into ``cv``."""
    path, _ = case
    out = str(tmp_path_factory.mktemp("fold_mesh_out"))
    cv_results = str(tmp_path_factory.mktemp("cv_mesh") / "results")
    argv = ["--folds", "0", "1", "--parallel", "yes", "--data_dir", cv_root,
            "--results_folder", cv_results, *CV_FLAGS, "--n_data_shards", "2"]
    done = {}

    def run():
        try:
            done["rc"] = launch(N, ranks.fold_mesh_and_cv_job, (path, out, argv, PROBE_EPOCHS),
                                device="cpu")
        except BaseException as e:  # raised again in the test process by mesh_run
            done["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield {"thread": thread, "done": done, "out": out, "cv": cv_results}
    thread.join()


@pytest.fixture(scope="module")
def jax_mesh_run(jax_trainer, launched):
    """JAX's trainer fit, two epochs, while the ranks train."""
    jt, union, init = jax_trainer
    result = jt.fit()
    return {"init": init, "union": union, "result": result,
            "best": [_fold_variables(jt.best_states, j) for j in range(N)]}


@pytest.fixture(scope="module")
def one_process(case, launched, tmp_path_factory):
    """The port's unsharded trainer on the same folds and weights, at the
    ranks' thread count."""
    out = str(tmp_path_factory.mktemp("fold_one_process"))
    trainer = ranks.fold_trainer(case[1], out)
    return out, trainer, trainer.fit()


@pytest.fixture(scope="module")
def mesh_run(case, launched, jax_mesh_run, one_process, cv_one_process):
    """The two ranks, one fold each, joined after this process's runs: the
    root and what each saved."""
    path, _ = case
    launched["thread"].join()
    if "error" in launched["done"]:
        raise launched["done"]["error"]
    assert launched["done"]["rc"] == 0
    return launched["out"], [torch.load(os.path.join(os.path.dirname(path), f"fold_rank{r}.pt"),
                                        weights_only=False) for r in range(N)]


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _ce(result):
    return [(h["train_loss_ce"], h["val_loss_ce"]) for h in result["history"]]


def test_mesh_equals_the_unsharded_trainer_bit_for_bit(mesh_run, one_process):
    """Rank 0 trained fold 0, rank 1 fold 1, with no collective in the step:
    every epoch's train and val CE of both folds (on both ranks, after the
    epoch's one gather), the best losses and epochs, and each fold's best
    weights and bank equal the unsharded trainer's, bit for bit."""
    _, ranks_out = mesh_run
    _, trainer, want = one_process
    assert [r["local"] for r in ranks_out] == [[0], [1]]
    for r in ranks_out:
        assert _ce(r["result"]) == _ce(want) and len(want["history"]) == 2
        assert r["result"]["best_loss"] == want["best_loss"]
        assert r["result"]["best_epoch"] == want["best_epoch"]
        uploads = r["result"]["history"][0]["uploads_by_rank"]  # each its whole replica
        assert len(uploads) == N and uploads[0] == uploads[1] > 0
    for r in ranks_out:
        for fold, state in r["best"].items():
            want_sd = trainer.fold_state(fold).state_dict()
            assert state.keys() == want_sd.keys()
            for k, v in want_sd.items():
                assert torch.equal(state[k], v), (fold, k)


def test_mesh_matches_jax_fold_mesh(mesh_run, jax_mesh_run):
    """JAX's ``FoldParallelTrainer(mesh=make_mesh(2))``: per fold and epoch
    the CE within 1e-4 of max(1, |l|), the same best epochs, each fold's best
    parameters and bank within those limits."""
    _, ranks_out = mesh_run
    want = jax_mesh_run["result"]
    got = ranks_out[0]["result"]
    for g, w in zip(got["history"], want["history"], strict=True):
        for key in ("train_loss_ce", "val_loss_ce"):
            for a, b in zip(g[key], w[key]):
                assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b)), (g["epoch"], key, a, b)
    assert got["best_epoch"] == list(want["best_epoch"])
    template = _template(jax_mesh_run["init"])
    for j, r in enumerate(ranks_out):
        (fold, state), = r["best"].items()
        assert fold == FOLDS[j]
        want_sd = state_dict_from_jax(jax_mesh_run["best"][j], template)
        for name, value in state.items():
            w = want_sd[name]
            scale = max(float(w.abs().max()), LEAF_FLOOR)
            err = float((value - w).abs().max())
            assert err <= ADAM_BOUND_LEAVES.get(name, PARAM_TOL) * scale, (j, name, err / scale)
            assert float((value - w).abs().mean()) <= PARAM_TOL * scale, (j, name)


def test_rank_0_writes_the_root_and_each_rank_its_folds(mesh_run, one_process):
    """The root ``loss.txt`` is rank 0's alone, with the unsharded run's
    lines and columns (the losses of each epoch line equal); each fold
    directory holds its ``args.txt`` and best checkpoint, written by its
    rank; a rank asked for another rank's fold raises."""
    out, ranks_out = mesh_run
    got, want = (_lines(os.path.join(d, "loss.txt")) for d in (out, one_process[0]))
    assert len(got) == len(want) and sum(line.startswith("epoch 0:") for line in got) == 1
    for a, b in zip(got, want):
        assert a.split(" (", 1)[0].split(" phases ")[0] == b.split(" (", 1)[0].split(" phases ")[0]
    for f in FOLDS:
        d = os.path.join(out, f"fold_{f}")
        assert os.path.exists(os.path.join(d, "args.txt"))
        assert os.path.exists(os.path.join(d, "checkpoints", "model_ckpt.pt"))
    for r in ranks_out:
        assert "is trained by another rank of the mesh" in r["others"]


@pytest.mark.parametrize("folds,kw,match", [
    ((0, 1, 2), {}, "3 folds do not shard evenly over the mesh's 2-device 'data' axis"),
    ((0, 1), {"fold_group_size": "auto"}, "cannot combine with a fold-sharded mesh"),
], ids=["uneven_folds", "fold_group_size"])
def test_mesh_refusals(root, case, tmp_path, folds, kw, match):
    """JAX's checks and texts, before any data is read or collective run."""
    cfg = TrainConfig(data_dir=root, **SMALL)
    with pytest.raises(ValueError, match=match):
        from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer

        FoldParallelTrainer(cfg, list(folds), *case[1]["union"], str(tmp_path), device="cpu",
                            mesh=Mesh(N, 0, torch.device("cpu"), "gloo", N), **kw)


# -- cv.main ---------------------------------------------------------------------


def _tree(d):
    return sorted(os.path.relpath(os.path.join(p, f), d) for p, _, fs in os.walk(d)
                  for f in fs)


@pytest.fixture(scope="module")
def cv_one_process(cv_root, tmp_path_factory):
    """``cv.main --parallel yes --folds 0 1`` in this process."""
    results = str(tmp_path_factory.mktemp("cv_one"))
    with pytest.MonkeyPatch.context() as mp:
        probes = reg.train_regression_probes_batched
        mp.setattr(reg, "train_regression_probes_batched",
                   lambda *a, **k: probes(*a, **{**k, "epochs": PROBE_EPOCHS}))
        assert cv.main(["--folds", "0", "1", "--parallel", "yes", "--data_dir", cv_root,
                        "--results_folder", results, *CV_FLAGS], device="cpu") == 0
    return results


def _json_numbers(path):
    with open(path) as f:
        return json.load(f)


def test_cv_main_fold_mesh_writes_the_one_process_tree(launched, mesh_run, cv_one_process):
    """``cv.main ... --n_data_shards 2`` on the launched ranks (each joins
    the group, trains its fold and runs its suite; rank 0 writes
    ``cv_summary.json`` after a barrier): the same files as the one-process
    run, every evaluation file and the summary's numbers equal, each fold's
    best weights equal."""
    results = launched["cv"]
    assert _tree(results) == _tree(cv_one_process)
    for rel in _tree(results):
        a, b = os.path.join(results, rel), os.path.join(cv_one_process, rel)
        if rel.endswith(".json") and rel != "cv_summary.json":
            assert _json_numbers(a) == _json_numbers(b), rel
        elif rel.endswith("model_ckpt.pt"):
            ma = torch.load(a, weights_only=True)["model"]
            mb = torch.load(b, weights_only=True)["model"]
            assert all(torch.equal(ma[k], mb[k]) for k in mb), rel
    got, want = (_json_numbers(os.path.join(d, "cv_summary.json"))
                 for d in (results, cv_one_process))
    assert got["mm_accuracy_mean_over_folds"] == want["mm_accuracy_mean_over_folds"]
    for f in ("0", "1"):
        assert got["folds"][f]["results_dir"] == os.path.join(results, f"fold_{f}")
        assert {k: v for k, v in got["folds"][f].items() if k != "results_dir"} == \
            {k: v for k, v in want["folds"][f].items() if k != "results_dir"}
        assert set(got["folds"][f]) == {"results_dir", "mm_accuracy_mean",
                                        "regression_loss_mean"}


def test_cv_main_spawns_its_ranks(cv_root, cv_one_process, tmp_path, monkeypatch):
    """``cv.main`` itself starts the two ranks (``--skip_eval yes``): the
    folds' best weights equal the one-process run's, the summary names both
    folds."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(ranks.THREADS))
    results = str(tmp_path / "cv_spawned")
    assert cv.main(["--folds", "0", "1", "--parallel", "yes", "--data_dir", cv_root,
                    "--results_folder", results, *CV_FLAGS, "--n_data_shards", "2",
                    "--skip_eval", "yes"], device="cpu") == 0
    for f in FOLDS:
        rel = os.path.join(f"fold_{f}", "checkpoints", "model_ckpt.pt")
        ma = torch.load(os.path.join(results, rel), weights_only=True)["model"]
        mb = torch.load(os.path.join(cv_one_process, rel), weights_only=True)["model"]
        assert all(torch.equal(ma[k], mb[k]) for k in mb), rel
    with open(os.path.join(results, "cv_summary.json")) as f:
        assert set(json.load(f)["folds"]) == {"0", "1"}
