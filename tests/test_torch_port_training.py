"""Torch port, the training path: the loss head and memory bank, whole-model
gradients, the optimizer and the schedulers against the JAX package, and
the port's trainer, checkpoint format and CLI on a small fixture (CPU)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.schedulers import make_scheduler as j_make_scheduler
from transformer_clip_eeg_tpu.train.state import count_params as j_count_params
from transformer_clip_eeg_tpu.train.state import make_optimizer as j_make_optimizer
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.serve import InferenceSession
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.loop import Trainer
from transformer_clip_eeg_tpu_torch.train.schedulers import make_scheduler
from transformer_clip_eeg_tpu_torch.train.state import count_params, make_optimizer
from transformer_clip_eeg_tpu_torch.train.steps import train_step
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T, SP_D = 4, 32, 16
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4,
             speech_dim_override=SP_D)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)


def _both_models(lambda_sim):
    """The flagship model at a small size in both packages, same weights."""
    jmodel = j_build(JConfig(**SMALL, lambda_sim_loss=lambda_sim), bank_size=16)
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((B, T, 64)).astype(np.float32)
    speech = rng.standard_normal((B, T, SP_D)).astype(np.float32)
    ids = np.array([3, 1, 7, 12], np.int32)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), eeg, speech, ids)))
    tmodel = build_model_from_config(TrainConfig(**SMALL, lambda_sim_loss=lambda_sim), 16,
                                     device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    batch = (torch.from_numpy(eeg), torch.from_numpy(speech),
             torch.from_numpy(ids.astype(np.int64)))
    return jmodel, variables, tmodel, (eeg, speech, ids), batch


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("lambda_sim", [0.0, 1.0])
def test_loss_head_and_bank_update_match_jax(lambda_sim):
    jmodel, variables, tmodel, jbatch, batch = _both_models(lambda_sim)
    outs, mutated = jmodel.apply(_jnp(variables), *jbatch, deterministic=True,
                                 mutable=["membank"])
    with torch.no_grad():
        got = tmodel.eval()(*batch)
    for mine, theirs in zip(got, outs):
        np.testing.assert_allclose(float(mine), float(theirs), **LOSS_TOL)
    np.testing.assert_allclose(
        tmodel.eegMemoryBank.memory.numpy(),
        np.asarray(mutated["membank"]["eegMemoryBank"]["memory"]), atol=1e-6)
    if lambda_sim == 0.0:
        assert float(got[2]) == float(got[0])


def test_memory_bank_returns_rows_from_before_the_update():
    _, _, tmodel, _, batch = _both_models(0.0)
    bank = tmodel.eegMemoryBank
    before = bank.memory.clone()
    ids = torch.tensor([2, 5])
    data = torch.ones(2, before.shape[1], requires_grad=True)
    rows = bank(ids, data)
    assert torch.equal(rows, before[ids]) and not rows.requires_grad
    np.testing.assert_allclose(bank.memory[ids].numpy(),
                               (0.9 * before[ids] + 0.1).numpy(), atol=1e-7)
    untouched = torch.ones(before.shape[0], dtype=torch.bool)
    untouched[ids] = False
    assert torch.equal(bank.memory[untouched], before[untouched])
    assert torch.equal(bank(ids, data, update=False), bank.memory[ids])


def test_whole_model_gradients_match_jax_grad():
    """Dropout off (the port in eval mode, JAX deterministic): every
    parameter leaf within 1e-4 x max(1, max |g|), with the bank's InfoNCE in
    the loss so both temperatures get a gradient."""
    jmodel, variables, tmodel, jbatch, batch = _both_models(1.0)

    def loss_fn(params):
        outs, _ = jmodel.apply({"params": params, "membank": _jnp(variables["membank"])},
                               *jbatch, deterministic=True, mutable=["membank"])
        return outs[2]

    jgrads = jax.tree.map(np.asarray, jax.grad(loss_fn)(_jnp(variables["params"])))
    want = state_dict_from_jax({"params": jgrads, "membank": variables["membank"]}, tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    loss = tmodel.eval()(*batch)[2]
    grads = torch.autograd.grad(loss, [p for _, p in tmodel.named_parameters()])
    assert len(names) == len(jax.tree_util.tree_leaves(jgrads))
    for name, g in zip(names, grads):
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(1.0, float(w.abs().max())), (name, err)


@pytest.mark.parametrize("optimizer,amsgrad", [("adamw", False), ("adam", False),
                                               ("adamw", True)],
                         ids=["adamw", "adam", "amsgrad"])
def test_optimizer_matches_optax(optimizer, amsgrad):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 3), "b": (5,), "c": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    tx = j_make_optimizer(optimizer, 1e-2, 0.9, 0.999, 0.05, amsgrad)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = make_optimizer(tparams, optimizer, 1e-2, 0.9, 0.999, 0.05, amsgrad)
    for step in range(3):
        grads = {k: np.asarray(rng.standard_normal(s) * (1 + 3 * step), np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.apply([torch.from_numpy(grads[k]) for k in shapes])
    assert opt.step == 3
    for k, p in zip(shapes, tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), atol=1e-6)


@pytest.mark.parametrize("name", ["no", "plateau", "step", "cosine", "cosine_warmup"])
def test_schedulers_match_jax(name):
    mine, theirs = make_scheduler(name, 1e-3, 3), j_make_scheduler(name, 1e-3, 3)
    vals = [1.0, 0.9, 0.95, 0.97, 0.99, 1.2, 1.1, 1.0, 1.3, 1.4, 1.5, 1.6, 0.5, 0.6]
    assert [mine.step(v) for v in vals] == [theirs.step(v) for v in vals]


# -- the trainer, its checkpoint and the CLI on a small fixture -----------------


@pytest.fixture(autouse=True, scope="module")
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
    root = str(tmp_path_factory.mktemp("sparrkulee_torch"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    return root


def _config(root, **overrides):
    kw = dict(data_dir=root, run=0, batch_size=4, epochs=2, patience=5,
              attention_depth=1, latent_dim=4, window_length_s=1, fs=64,
              number_of_training_subjects=3, speech_dim_override=SP_D)
    kw.update(overrides)
    return TrainConfig(**kw)


def _datasets(cfg):
    tr, va, _, _, tra, vaa, _, _ = get_train_val_test_files_final(
        cfg.data_dir, cfg.run, cfg.stimulus_features, cfg.fold_split_path,
        cfg.number_of_training_subjects)
    mk = lambda files, audio, **kw: EEGWindowDataset(  # noqa: E731
        files, audio, cfg.window_length, cfg.hop_length, batch_size=cfg.batch_size,
        seed=cfg.seed, **kw)
    return mk(tr, tra, shuffle=cfg.shuffle_b, shuffle_percentage=cfg.shuffle_percentage), \
        mk(va, vaa)


@pytest.fixture(scope="module")
def trained(fixture_root, tmp_path_factory):
    cfg = _config(fixture_root)
    results_dir = str(tmp_path_factory.mktemp("run") / "results")
    trainer = Trainer(cfg, *_datasets(cfg), results_dir=results_dir, device="cpu")
    return trainer, trainer.fit()


# the line formats of the JAX trainer (train/loop.py), in order per epoch
LINE_FORMATS = [
    r"number of parameters \d+",
    r"no model found at .*, training from scratch",
    r"train epoch 0 batch 0 loss_ce \S+ loss average eeg \S+",
    r"epoch 0 done in \d+\.\ds \(\d+ pairs/s\)",
    r'epoch 0 phases \{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+\}',
    r"validation epoch 0: mean loss ce : \S+, mean loss average: \S+, mean loss total: \S+",
    r"train epoch 1 batch 0 loss_ce \S+ loss average eeg \S+",
    r"epoch 1 done in \d+\.\ds \(\d+ pairs/s\)",
    r'epoch 1 phases \{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+\}',
    r"validation epoch 1: mean loss ce : \S+, mean loss average: \S+, mean loss total: \S+",
]


def test_trainer_writes_the_jax_trainers_loss_lines(trained):
    trainer, out = trained
    lines = open(trainer.loss_file).read().splitlines()
    assert len(lines) == len(LINE_FORMATS)
    for line, fmt in zip(lines, LINE_FORMATS):
        assert re.fullmatch(fmt, line), (line, fmt)
    jcfg = JConfig(**{k: v for k, v in trainer.cfg.to_dict().items()})
    jmodel = j_build(jcfg, bank_size=trainer.cfg.bank_size)
    w = trainer.cfg.window_length
    jvars = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, w, 64), np.float32),
                        np.zeros((1, w, SP_D), np.float32), np.ones((1,), np.int32))
    assert lines[0] == f"number of parameters {j_count_params(jvars['params'])}"
    assert count_params(trainer.model) == j_count_params(jvars["params"])
    for h in out["history"]:
        assert np.isfinite(h["val_loss_ce"]) and len(h["step_s"]) > 0


def test_checkpoint_and_best_meta_round_trip(trained):
    trainer, out = trained
    ckpt_dir = trainer.checkpoint_dir
    assert os.path.exists(os.path.join(ckpt_dir, "model_ckpt.pt"))
    assert ckpt_lib.load_best_meta(ckpt_dir) == pytest.approx(out["best_loss"], rel=1e-6)
    cfg = TrainConfig.load(os.path.join(trainer.results_dir, "args.txt"))
    model = build_model_from_config(cfg, cfg.bank_size, device="cpu", seed=123)
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate)
    sched = make_scheduler(cfg.lr_scheduler, cfg.learning_rate, cfg.step_size_scheduler)
    step = ckpt_lib.restore_checkpoint(ckpt_dir, model, opt, sched)
    saved = torch.load(os.path.join(ckpt_dir, "model_ckpt.pt"), weights_only=True)
    assert step == saved["step"] == opt.step > 0
    for k, v in saved["model"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(opt.mu, saved["optimizer"]["mu"])
    assert sched.epoch == saved["scheduler"]["epoch"]
    assert ckpt_lib.restore_checkpoint(str(trainer.results_dir), model) is None


def test_resume_keeps_the_best_val_bar(fixture_root, trained):
    """A fresh trainer on the same results dir restores the checkpoint and
    the best-val-CE bar (best_meta.json): epochs that are all worse than an
    unbeatable bar never overwrite the saved best."""
    trainer, _ = trained
    ckpt_dir = trainer.checkpoint_dir
    saved_before = os.path.getmtime(os.path.join(ckpt_dir, "model_ckpt.pt"))
    ckpt_lib.save_best_meta(ckpt_dir, 0.0)
    cfg = _config(fixture_root, epochs=1)
    again = Trainer(cfg, *_datasets(cfg), results_dir=trainer.results_dir, device="cpu")
    out = again.fit()
    assert out["best_loss"] == 0.0
    assert ckpt_lib.load_best_meta(ckpt_dir) == 0.0
    assert os.path.getmtime(os.path.join(ckpt_dir, "model_ckpt.pt")) == saved_before
    assert "loaded model from" in open(again.loss_file).read()


def test_warmup_step_follows_loss_ce_alone():
    """With the bank's InfoNCE weighted in, a warmup step moves the
    parameters along the gradient of loss_ce only."""
    _, _, model, _, batch = _both_models(1.0)
    batch = dict(zip(("eeg", "speech", "ids"), batch))
    twin = build_model_from_config(TrainConfig(**SMALL, lambda_sim_loss=1.0), 16,
                                   device="cpu", seed=1)
    twin.load_state_dict(model.state_dict())
    opt = make_optimizer(model.parameters(), "adamw", 1e-3)
    opt_twin = make_optimizer(twin.parameters(), "adamw", 1e-3)
    losses = train_step(model, opt, batch, seed=11, warmup=True)
    # the same step by hand: same dropout seeds, gradient of loss_ce
    from transformer_clip_eeg_tpu_torch.ops.dropout import fold_seed, set_dropout_seeds

    twin.train()
    set_dropout_seeds(twin, fold_seed(11, 0))
    loss_ce = twin(batch["eeg"], batch["speech"], batch["ids"])[0]
    grads = torch.autograd.grad(loss_ce, opt_twin.params, allow_unused=True)
    opt_twin.apply([torch.zeros_like(p) if g is None else g
                    for g, p in zip(grads, opt_twin.params)])
    assert float(losses["loss_ce"]) == pytest.approx(float(loss_ce.detach()), rel=1e-6)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.allclose(p, q, atol=1e-7)
    assert float(losses["loss_total"]) > float(losses["loss_ce"])


@pytest.mark.parametrize("override,error,match", [
    (dict(n_data_shards=2), ValueError, "needs a mesh of as many ranks"),
    (dict(prng_impl="threefry2x32"), NotImplementedError, "ROADMAP.md"),
], ids=["mesh", "prng_impl"])
def test_unported_trainer_options_raise(fixture_root, tmp_path, override, error, match):
    """``prng_impl`` other than the default is not ported; ``n_data_shards``
    is (``parallel/``), and a trainer asked for it without the mesh of its
    ranks raises."""
    cfg = _config(fixture_root, **override)
    with pytest.raises(error, match=match):
        Trainer(cfg, *_datasets(_config(fixture_root)), results_dir=str(tmp_path),
                device="cpu")


def test_cli_trains_and_the_run_serves(fixture_root, tmp_path):
    """``cli.main(..., device="cpu")`` at the default window trains and writes
    args.txt, loss.txt and the checkpoint, and ``from_results_dir`` serves
    the run."""
    argv = ["--data_dir", fixture_root, "--run", "0", "--epochs", "1", "--skip_eval", "yes",
            "--batch_size", "4", "--attention_depth", "1", "--speech_dim_override",
            str(SP_D), "--results_folder", str(tmp_path)]
    assert cli.main(argv, device="cpu") == 0
    (run,) = os.listdir(tmp_path)
    results_dir = os.path.join(tmp_path, run)
    args = json.load(open(os.path.join(results_dir, "args.txt")))
    assert args["batch_size"] == 4 and args["bank_size"] > 0
    assert "validation epoch 0" in open(os.path.join(results_dir, "loss.txt")).read()
    eeg = np.random.default_rng(0).standard_normal((5, 192, 64)).astype(np.float32)
    session = InferenceSession.from_results_dir(results_dir, chunk=4, device="cpu")
    assert session.embed_eeg(eeg).shape == (5, 192 * 8)


def test_the_saved_run_serves_the_trainers_model(trained):
    """``from_results_dir`` rebuilds the trainer's model (its best state,
    which is what the checkpoint holds) from args.txt and the checkpoint."""
    trainer, _ = trained
    w = trainer.cfg.window_length
    rng = np.random.default_rng(1)
    eeg = rng.standard_normal((5, w, 64)).astype(np.float32)
    speech = rng.standard_normal((5, w, SP_D)).astype(np.float32)
    served = InferenceSession.from_results_dir(trainer.results_dir, chunk=4, device="cpu")
    live = InferenceSession(trainer.model, chunk=4, device="cpu")
    np.testing.assert_allclose(served.embed_eeg(eeg), live.embed_eeg(eeg), atol=1e-6)
    np.testing.assert_allclose(served.embed_speech(speech), live.embed_speech(speech),
                               atol=1e-6)
