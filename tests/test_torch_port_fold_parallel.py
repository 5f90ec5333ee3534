"""Torch port, fold-parallel cross-validation training
(``train/fold_parallel.py``) against the JAX package's
``FoldParallelTrainer`` on its own fold fixture (4 stories, 3 subjects, 60
s; folds 0-2 hold one story each), at a small width (``attention_depth 1``,
``latent_dim 4``, ``lstm_units 8``, batch 8), on the CPU: the index
matrices and the chunk order draw for draw, two folds trained over two
epochs from carried weights with dropout off on both sides, early stopping,
fold isolation, fold groups, ``fold_group_size``'s checks, auto-resume and
a fold directory served."""

import os
import re

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.fold_parallel import (
    FoldParallelTrainer as JFoldParallelTrainer,
)
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout
from transformer_clip_eeg_tpu_torch.parallel import Mesh
from transformer_clip_eeg_tpu_torch.serve import InferenceSession
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train import fold_parallel
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

SMALL = dict(batch_size=8, epochs=2, patience=5, attention_depth=1, latent_dim=4,
             lstm_units=8, number_of_training_subjects=3, speech_dim_override=16)
LOSS_TOL = 1e-4    # per-fold train and val CE, of max(1, |l|): 24 AdamW steps a fold
PARAM_TOL = 1e-3   # each best parameter and the bank, of the leaf's largest value
LEAF_FLOOR = 1e-6  # the least scale a leaf is held to (a leaf that is all zeros)
# The leaves whose largest error passes PARAM_TOL, each at 1.3x its measured
# error: 2 of the EEG conv's 262,144 weights end 1.7e-4 and 5.5e-5 from
# JAX's (5.05e-3 of the leaf's largest value; mean error 9.5e-8).  Adam
# divides each gradient by its own running scale, so where an element's
# gradient is near zero a reassociated f32 sum moves it by a fraction of the
# learning rate (1e-3) a step; every leaf's mean error is held to PARAM_TOL.
ADAM_BOUND_LEAVES = {"eegModel.conv_0.conv.weight": 6.6e-3}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_folds"))
    make_fixture(root, n_stories=4, n_subjects=3, story_seconds=60, speech_dim=16)
    return root


def _cfg(root, **kw):
    return TrainConfig(data_dir=root, **{**SMALL, **kw})


def _union(root, cfg):
    files = get_train_val_test_files_final(root, 0, cfg.stimulus_features,
                                           cfg.fold_split_path,
                                           cfg.number_of_training_subjects)
    return files[0] + files[1], files[4] + files[5]


def _trainer(root, out, folds=(0, 1), cfg=None, **kw):
    cfg = cfg or _cfg(root)
    return FoldParallelTrainer(cfg, list(folds), *_union(root, cfg), str(out),
                               device="cpu", **kw)


class _NoDropout(jl.Dropout):
    """JAX's flax Dropout as the identity: its masks cannot be drawn in torch."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _port_without_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        if isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0


def _fold_variables(states, j):
    """Fold ``j``'s params and memory bank out of JAX's stacked state."""
    take = lambda tree: jax.tree.map(lambda x: np.array(x[j]), tree)  # noqa: E731
    return {"params": take(states.params), "membank": take(states.membank)}


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    """JAX's FoldParallelTrainer on folds 0 and 1 for two epochs, flax's
    Dropout patched to the identity; its draws are recorded.  ``row_bucket=1``
    (the masked padding rows of the default bucket change nothing)."""
    out = tmp_path_factory.mktemp("jax_folds")
    jcfg = JConfig(data_dir=root, **SMALL)
    with pytest.MonkeyPatch.context() as mp:
        for module in (je, ja, jh):
            mp.setattr(module, "Dropout", _NoDropout)
        jt = JFoldParallelTrainer(jcfg, [0, 1], *_union(root, _cfg(root)), str(out),
                                  row_bucket=1)
        init = _fold_variables(jt.states, 0)
        draws = _record_draws(jt)
        result = jt.fit()
    best = [_fold_variables(jt.best_states, j) for j in range(2)]
    return dict(trainer=jt, init=init, draws=draws, result=result, best=best,
                loss_txt=open(os.path.join(str(out), "loss.txt")).read())


def _record_draws(trainer) -> list:
    """Wrap ``trainer._chunk_rows`` to record each call's key and matrices."""
    draws, real = [], trainer._chunk_rows

    def chunk_rows(key, participate, add_eeg):
        out = real(key, participate, add_eeg)
        draws.append((key, *(np.array(a) for a in out)))
        return out

    trainer._chunk_rows = chunk_rows
    return draws


@pytest.fixture(scope="module")
def port_run(root, jax_run, tmp_path_factory):
    """The port's trainer on the same folds from JAX's initial weights,
    dropout off, its draws recorded."""
    out = tmp_path_factory.mktemp("port_folds_run")
    trainer = _carried(_trainer(root, out, row_bucket=1), jax_run["init"])
    draws = _record_draws(trainer)
    result = trainer.fit()
    return dict(trainer=trainer, draws=draws, result=result, out=str(out),
                loss_txt=open(os.path.join(str(out), "loss.txt")).read())


def _carried(trainer, variables):
    for model in trainer.models:
        model.load_state_dict(state_dict_from_jax(variables, model))
        _port_without_dropout(model)
    return trainer


def _assert_draws_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]  # the chunk
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_two_folds_draw_jax_index_matrices_in_jax_order(port_run, jax_run):
    """Every chunk of both epochs (train and validation walks) in JAX's
    shuffled order, with each fold's index matrices, subjects, partners and
    valid rows equal to JAX's, draw for draw."""
    _assert_draws_equal(port_run["draws"], jax_run["draws"])


@pytest.mark.parametrize("add_eeg", [False, True], ids=["plain", "addEEG"])
def test_draw_order_matches_jax_with_and_without_mixup(root, jax_run, tmp_path,
                                                       monkeypatch, add_eeg):
    """Two epochs' walks (train then validation, as ``fit`` calls them) with
    the steps stubbed out, at the default row bucket of 8: the chunk order
    and every matrix equal JAX's, the mixup partners (drawn from the shared
    rng) included."""
    jt = jax_run["trainer"]
    jt.cfg.addEEG = "yes" if add_eeg else "no"
    jt.row_bucket = 8
    jt.fold_rngs = [np.random.default_rng(0) for _ in jt.folds]
    jt.shared_rng = np.random.default_rng(0)
    jt.train_scan = lambda st, *a, **k: (st, {"loss_ce": np.zeros(a[6].shape, np.float32)})
    jt.eval_scan = lambda st, *a: (st, {"loss_ce": np.zeros(a[5].shape, np.float32)})
    cfg = _cfg(root, addEEG="yes" if add_eeg else "no")
    pt = _trainer(root, tmp_path, cfg=cfg)
    stub = lambda *a, **k: {"loss_ce": torch.zeros(())}  # noqa: E731
    monkeypatch.setattr(fold_parallel, "chunk_train_step", stub)
    monkeypatch.setattr(fold_parallel, "chunk_eval_step", stub)
    want, got = _record_draws(jt), _record_draws(pt)
    active = np.ones(2, bool)
    for _ in range(2):
        jt._epoch(jt.train_stories, active, train=True, rng_key=None)
        jt._epoch(jt.val_stories, active, train=False, rng_key=None)
        pt._epoch(pt.train_stories, active, train=True)
        pt._epoch(pt.val_stories, active, train=False)
    _assert_draws_equal(got, want)
    if add_eeg:  # the partners are drawn, not the subjects again
        assert any((w[3] != w[2]).any() for w in want)


def test_two_folds_match_jax_over_two_epochs(port_run, jax_run):
    """Per fold and epoch, the train and val CE within 1e-4 of max(1, |l|);
    the same best epochs; each fold's best parameters and memory bank within
    1e-3 of each leaf's largest value (``ADAM_BOUND_LEAVES`` at their own
    bound), and every leaf's mean error within 1e-3 of it."""
    got, want = port_run["result"], jax_run["result"]
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        for key in ("train_loss_ce", "val_loss_ce"):
            for a, b in zip(g[key], w[key]):
                assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b)), (g["epoch"], key, a, b)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["best_loss"], want["best_loss"], rtol=LOSS_TOL)
    trainer = port_run["trainer"]
    for j in range(2):
        model = trainer.fold_state(trainer.folds[j])
        want_sd = state_dict_from_jax(jax_run["best"][j], model)
        for name, value in model.state_dict().items():
            w = want_sd[name]
            err = float((value - w).abs().max())
            err = float((value - w).abs().max())
            scale = max(float(w.abs().max()), LEAF_FLOOR)
            assert err <= ADAM_BOUND_LEAVES.get(name, PARAM_TOL) * scale, (j, name, err / scale)
            mean = float((value - w).abs().mean())
            assert mean <= PARAM_TOL * scale, (j, name, mean / scale)


def _loss_lines(text: str) -> list:
    """``loss.txt`` without its timings: the losses of each epoch line and
    every early-stopping line."""
    out = []
    for line in text.splitlines():
        if line.startswith("epoch ") and " phases " not in line:
            out.append(line.split(" (", 1)[0])
        elif "early stopping" in line:
            out.append(line)
    return out


def test_loss_txt_writes_the_jax_lines(port_run, jax_run):
    """The root ``loss.txt``: the same lines as JAX's, numbers to 4 places,
    then each epoch's upload record (one upload per union chunk an epoch on
    the CPU's count cap of 2 resident chunks)."""
    text = port_run["loss_txt"]
    assert _loss_lines(text) == _loss_lines(jax_run["loss_txt"])
    assert text.splitlines()[0] == jax_run["loss_txt"].splitlines()[0]
    for e in range(2):
        assert re.search(rf"^epoch {e}: train loss_ce \[[^]]+\] val loss_ce \[[^]]+\] "
                         r"\(\d+ pairs/s aggregate\)$", text, re.M)
        assert re.search(rf'^epoch {e} phases {{"uploads": 6, "upload_gb": \S+, '
                         r'"upload_s": \S+, "upload_wait_s": \S+}$', text, re.M)


@pytest.mark.parametrize("script", ["fold0_stalls", "both_stall"])
def test_early_stopping_matches_jax(root, jax_run, tmp_path, monkeypatch, script):
    """``fit``'s per-fold early stopping, best epochs and checkpoints on
    scripted losses (the epoch walks stubbed out on both sides), patience 1
    over 5 epochs: the early-stopping lines, the per-epoch CE lines and the
    results equal JAX's."""
    vals = {"fold0_stalls": [[1.0, 2.0], [1.5, 1.5], [1.2, 1.0], [0.5, 0.9], [0.1, 0.8]],
            "both_stall": [[1.0, 2.0], [1.5, 2.5], [1.2, 2.1], [0.5, 0.9], [0.1, 0.8]]}[script]

    def scripted(calls):
        def epoch(member, active, train, rng_key=None, warmup=False):
            e = calls.count(False)
            calls.append(train)
            counts = np.where(active, 3, 0).astype(np.int64)
            ce = np.full(2, 0.25 * (e + 1)) if train else np.asarray(vals[e])
            return {"loss_ce": ce * counts}, counts
        return epoch

    jt = jax_run["trainer"]
    for a in ("train_stories", "val_stories"):
        assert getattr(jt, a)
    jt.cfg.epochs, jt.cfg.patience = 5, 1
    jt.fold_dirs = [str(tmp_path / "jax" / f"fold_{f}") for f in jt.folds]
    for d in jt.fold_dirs:
        os.makedirs(os.path.join(d, "checkpoints"))
    jt.loss_file = str(tmp_path / "jax_loss.txt")
    jt.resume_best_loss = np.full(2, np.inf)
    monkeypatch.setattr(jt, "_epoch", scripted([]))
    want = jt.fit()
    pt = _trainer(root, tmp_path / "port", cfg=_cfg(root, epochs=5, patience=1))
    monkeypatch.setattr(pt, "_epoch", scripted([]))
    got = pt.fit()
    jt.cfg.epochs, jt.cfg.patience = SMALL["epochs"], SMALL["patience"]
    assert (got["best_epoch"], got["best_loss"]) == (want["best_epoch"], want["best_loss"])
    assert [h["val_loss_ce"] for h in got["history"]] == \
        [h["val_loss_ce"] for h in want["history"]]
    lines = _loss_lines(open(pt.loss_file).read())
    assert lines == _loss_lines(open(jt.loss_file).read())
    assert any("early stopping" in line for line in lines)
    for d in pt.fold_dirs:  # every fold's best is on disk
        assert os.path.exists(ckpt_lib.checkpoint_path(os.path.join(d, "checkpoints")))


@pytest.fixture(scope="module")
def solo_run(root, jax_run, tmp_path_factory):
    """Fold 1 trained alone from the same weights, dropout off."""
    trainer = _carried(_trainer(root, tmp_path_factory.mktemp("solo"), folds=(1,)),
                       jax_run["init"])
    return trainer, trainer.fit()


# Two runs of one fold on the CPU, held at the JAX package's own limits for
# these checks (tests/test_fold_parallel.py): the same operations in the same
# order, but the CPU's BLAS may sum a product in another order when its
# operands sit at other addresses, and AdamW amplifies that.  The card's
# check in chip_smoke.py is bit for bit.
SAME_FOLD_LOSS_TOL = 2e-5   # relative and absolute, per epoch's CE
SAME_FOLD_PARAM_TOL = 5e-4  # relative and absolute, per parameter


def _assert_same_fold(a, ja, b, jb):
    """Fold ``ja`` of trainer ``a`` and fold ``jb`` of ``b``: the same CE
    every epoch and the same best parameters and bank."""
    (ta, ra), (tb, rb) = a, b
    for ea, eb in zip(ra["history"], rb["history"], strict=True):
        for key in ("train_loss_ce", "val_loss_ce"):
            np.testing.assert_allclose(ea[key][ja], eb[key][jb], rtol=SAME_FOLD_LOSS_TOL,
                                       atol=SAME_FOLD_LOSS_TOL, err_msg=key)
    sa = ta.fold_state(ta.folds[ja]).state_dict()
    for name, value in tb.fold_state(tb.folds[jb]).state_dict().items():
        np.testing.assert_allclose(sa[name].numpy(), value.numpy(), rtol=SAME_FOLD_PARAM_TOL,
                                   atol=SAME_FOLD_PARAM_TOL, err_msg=name)


def test_fold_parallel_isolates_folds(port_run, solo_run):
    """Fold 1 inside the two-fold run equals fold 1 trained alone:
    per-epoch train and val CE, best parameters and bank (the shared chunk
    order and the other fold's steps do not reach it)."""
    _assert_same_fold((port_run["trainer"], port_run["result"]), 1, solo_run, 0)


def test_fold_group_chunking_matches_ungrouped(root, jax_run, port_run, tmp_path):
    """Groups of one fold walk each chunk once per group; every draw is made
    before the walk, so both folds equal the ungrouped run's."""
    grouped = _carried(_trainer(root, tmp_path, row_bucket=1, fold_group_size=1),
                       jax_run["init"])
    assert grouped.fold_group_size == 1
    result = grouped.fit()
    for j in range(2):
        _assert_same_fold((port_run["trainer"], port_run["result"]), j, (grouped, result), j)
    assert "fold-group chunking: 2 folds in groups of 1 per dispatch" in \
        open(grouped.loss_file).read()


def test_fold_group_size_validation(root, tmp_path, capsys):
    """JAX's checks and texts: a size that does not divide F, folds that do
    not divide over a mesh, a group size with a mesh (JAX
    ``fold_parallel.py:520-523``), ``n_data_shards`` without the mesh of its
    ranks; ``'auto'`` is every fold, with its reason printed."""
    with pytest.raises(ValueError, match="fold_group_size 2 must be a positive divisor of "
                                         r"the fold count \(3\)"):
        _trainer(root, tmp_path / "bad", folds=(0, 1, 2), fold_group_size=2)
    with pytest.raises(ValueError, match="divisor"):
        _trainer(root, tmp_path / "zero", fold_group_size=-1)
    mesh = Mesh(2, 0, torch.device("cpu"), "gloo", 2)
    with pytest.raises(ValueError, match="3 folds do not shard evenly over the mesh's "
                                         "2-device 'data' axis"):
        _trainer(root, tmp_path / "uneven", folds=(0, 1, 2), mesh=mesh)
    with pytest.raises(ValueError, match="fold_group_size cannot combine with a fold-sharded "
                                         "mesh"):
        _trainer(root, tmp_path / "mesh", mesh=mesh, fold_group_size=1)
    with pytest.raises(ValueError, match="n_data_shards=2 needs a mesh of as many ranks"):
        _trainer(root, tmp_path / "shards", cfg=_cfg(root, n_data_shards=2))
    assert _trainer(root, tmp_path / "auto", fold_group_size="auto").fold_group_size == 2
    assert "auto fold grouping: G=2" in capsys.readouterr().out


@pytest.fixture(scope="module")
def resumed_root(root, tmp_path_factory):
    """One epoch of fold 0, the sweep a resumed run starts from."""
    out = tmp_path_factory.mktemp("resume")
    first = _trainer(root, out, folds=(0,), cfg=_cfg(root, epochs=1))
    return str(out), first, first.fit()


def test_fold_parallel_auto_resume(root, resumed_root, tmp_path):
    """A new trainer on the same root restores the fold's best checkpoint
    (model and bank) and the val CE it was saved at; a fresh root does not."""
    out, first, result = resumed_root
    again = _trainer(root, out, folds=(0,), cfg=_cfg(root, epochs=1))
    assert again.resumed.all()
    want = first.fold_state(0).state_dict()
    for name, value in again.models[0].state_dict().items():
        assert torch.equal(value, want[name]), name
    np.testing.assert_allclose(again.resume_best_loss, result["best_loss"], rtol=1e-6)
    assert "auto-resumed folds [0] from their checkpoints" in open(again.loss_file).read()
    assert not _trainer(root, tmp_path, folds=(0,)).resumed.any()


def test_resume_keeps_the_best_checkpoint(root, resumed_root):
    """A resumed sweep whose epochs are all worse than the recorded best
    leaves the checkpoint and its meta untouched."""
    out, first, result = resumed_root
    ckpt_dir = os.path.join(result["fold_dirs"][0], "checkpoints")
    before = ckpt_lib.load_checkpoint(ckpt_dir)["model"]
    ckpt_lib.save_best_meta(ckpt_dir, 0.0)  # a bar no epoch can beat
    again = _trainer(root, out, folds=(0,), cfg=_cfg(root, epochs=1))
    np.testing.assert_allclose(again.resume_best_loss, [0.0])
    assert again.fit()["best_loss"] == [0.0]
    assert ckpt_lib.load_best_meta(ckpt_dir) == 0.0
    after = ckpt_lib.load_checkpoint(ckpt_dir)["model"]
    for name, value in before.items():
        assert torch.equal(after[name], value), name


def test_fold_dirs_hold_args_and_checkpoints(port_run):
    """Each fold's directory: ``args.txt`` with the fold as ``run`` and the
    union's segments as ``bank_size``, and its checkpoint."""
    trainer = port_run["trainer"]
    for fold, d in zip((0, 1), port_run["result"]["fold_dirs"]):
        cfg = TrainConfig.load(os.path.join(d, "args.txt"))
        assert cfg.run == fold and d == os.path.join(port_run["out"], f"fold_{fold}")
        assert cfg.bank_size == trainer.models[0].eegMemoryBank.memory.shape[0] - 1
        assert os.path.exists(ckpt_lib.checkpoint_path(os.path.join(d, "checkpoints")))


def test_fold_run_dir_serves(resumed_root):
    """A fold directory loads straight into ``InferenceSession``: L2-normal
    embeddings from the fold's best weights, not a fresh init."""
    _out, trainer, result = resumed_root
    session = InferenceSession.from_results_dir(result["fold_dirs"][0], chunk=4, device="cpu")
    eeg = np.random.default_rng(0).standard_normal((2, 192, 64)).astype(np.float32)
    emb = session.embed_eeg(eeg)
    assert emb.shape[0] == 2 and np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    want = trainer.fold_state(0).state_dict()
    for name, value in session.model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_release_host_data_keeps_the_models(root, tmp_path):
    trainer = _trainer(root, tmp_path, folds=(0,), cfg=_cfg(root, epochs=0))
    trainer.fit()
    trainer.release_host_data()
    assert trainer.store is None and trainer.dataset is None
    assert trainer.fold_state(0) is trainer.models[0]
