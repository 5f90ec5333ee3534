"""Torch port, the model zoo through the command line and serving:
``cli.main`` training each zoo configuration (Z1-Z6, PERF.md §4) on a small
fixture (CPU) with ``args.txt`` round-tripping through JAX's config, and
``from_results_dir`` serving a head without a memory bank, or refusing a
run it cannot size."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.state import count_params as j_count_params
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.serve import InferenceSession
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.state import count_params

SP_D = 12
# the zoo configurations held on the card by chip_smoke.py (PERF.md §4)
ZOO = {
    "Z1": dict(eeg_encoder="conformer", speech_encoder="convLSTM", model_arch="clip_sim"),
    "Z2": dict(eeg_encoder="convLSTM", speech_encoder="smallConv", model_arch="clip_mp"),
    "Z3": dict(eeg_encoder="convLSTMnew", speech_encoder="convLSTM", model_arch="clip_kld"),
    "Z4": dict(eeg_encoder="lstm", speech_encoder="lstm", stimulus_features="mel",
               model_arch="no_contrastive_learning"),
    "Z5": dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
               model_arch="clip_kld_latent_proj"),
    "Z6": dict(eeg_encoder="vlaai", speech_encoder="Wav2vecSmallModel", model_arch="clip_sim"),
}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparrkulee_zoo"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    return root


def _argv(root, out, z):
    argv = ["--data_dir", root, "--run", "0", "--epochs", "1", "--skip_eval", "yes",
            "--batch_size", "4", "--attention_depth", "1", "--lstm_units", "8",
            "--results_folder", str(out)]
    for k, v in ZOO[z].items():
        argv += [f"--{k}", v]
    if ZOO[z].get("stimulus_features") != "mel":
        argv += ["--speech_dim_override", str(SP_D)]
    return argv


def _run_dir(out) -> str:
    (run,) = os.listdir(out)
    return os.path.join(out, run)


@pytest.mark.parametrize("z", sorted(ZOO))
def test_cli_trains_each_zoo_configuration(z, fixture_root, tmp_path):
    """``cli.main(..., device="cpu")`` trains the configuration for an epoch:
    loss.txt in the JAX trainer's format for its head (the KLD heads report
    their prior terms), the parameter count of the JAX model, finite
    validation losses, and ``args.txt`` loads field for field in JAX's
    config and back."""
    assert cli.main(_argv(fixture_root, tmp_path, z), device="cpu") == 0
    results_dir = _run_dir(tmp_path)
    lines = open(os.path.join(results_dir, "loss.txt")).read().splitlines()
    train_fmt = (r"train epoch 0 batch 0 loss_ce \S+ loss pmu2 \S+, log z2: \S+"
                 if "kld" in ZOO[z]["model_arch"] else
                 r"train epoch 0 batch 0 loss_ce \S+ loss average eeg \S+")
    assert re.fullmatch(train_fmt, lines[2]), lines[2]
    val = re.fullmatch(r"validation epoch 0: mean loss ce : (\S+), mean loss average: (\S+), "
                       r"mean loss total: (\S+)", lines[5])
    assert val and all(np.isfinite(float(v)) for v in val.groups()), lines[5]

    args_path = os.path.join(results_dir, "args.txt")
    cfg = TrainConfig.load(args_path)
    jcfg = JConfig.load(args_path)
    assert jcfg.to_dict() == cfg.to_dict()
    assert {k: cfg.to_dict()[k] for k in ZOO[z]} == ZOO[z]
    jcfg.save(os.path.join(tmp_path, "jax_args.txt"))
    assert TrainConfig.load(os.path.join(tmp_path, "jax_args.txt")).to_dict() == cfg.to_dict()

    w = cfg.window_length
    jmodel = j_build(jcfg, bank_size=cfg.bank_size)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, w, 64)), jnp.zeros((1, w, cfg.speech_dimension)),
        jnp.ones((1,), jnp.int32)))
    n_params = j_count_params(shapes["params"])
    assert lines[0] == f"number of parameters {n_params}"
    model = build_model_from_config(cfg, cfg.bank_size, device="cpu")
    assert count_params(model) == n_params


def _set_bank_size(results_dir, value):
    path = os.path.join(results_dir, "args.txt")
    args = json.load(open(path))
    args["bank_size"] = value
    json.dump(args, open(path, "w"))


def test_a_head_without_a_bank_serves_from_its_results_dir(fixture_root, tmp_path):
    """A clip_kld run (no memory bank: the head is sized by args.txt's
    bank_size alone) serves the trainer's best model; without bank_size in
    args.txt there is nothing to size it by, and JAX's ValueError names
    args.txt."""
    trainer = cli.train(_argv(fixture_root, tmp_path, "Z3"), device="cpu")
    results_dir = trainer.results_dir
    assert not hasattr(trainer.model, "eegMemoryBank")
    assert trainer.model.mu_eeg_lookup.shape[0] == trainer.cfg.bank_size + 1
    rng = np.random.default_rng(1)
    w = trainer.cfg.window_length
    eeg = rng.standard_normal((5, w, 64)).astype(np.float32)
    speech = rng.standard_normal((5, w, SP_D)).astype(np.float32)
    served = InferenceSession.from_results_dir(results_dir, chunk=4, device="cpu")
    live = InferenceSession(trainer.model, chunk=4, device="cpu")
    np.testing.assert_allclose(served.embed_eeg(eeg), live.embed_eeg(eeg), atol=1e-6)
    np.testing.assert_allclose(served.embed_speech(speech), live.embed_speech(speech),
                               atol=1e-6)
    _set_bank_size(results_dir, 0)
    with pytest.raises(ValueError, match="args.txt"):
        InferenceSession.from_results_dir(results_dir, chunk=4, device="cpu")


def test_a_head_with_a_bank_is_sized_by_its_rows_without_args_bank_size(fixture_root,
                                                                        tmp_path):
    """Without bank_size in args.txt a head with a memory bank takes its size
    from the checkpoint's bank rows, as JAX's serving does."""
    # Z2's encoders under the clip_sim head (the last --model_arch counts)
    trainer = cli.train(_argv(fixture_root, tmp_path, "Z2") + ["--model_arch", "clip_sim"],
                        device="cpu")
    _set_bank_size(trainer.results_dir, 0)
    served = InferenceSession.from_results_dir(trainer.results_dir, chunk=4, device="cpu")
    assert served.model.eegMemoryBank.memory.shape == trainer.model.eegMemoryBank.memory.shape
    assert torch.equal(served.model.eegMemoryBank.memory, trainer.model.eegMemoryBank.memory)
