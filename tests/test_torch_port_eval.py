"""Torch port, the post-training evaluation suite against the JAX package's
on the CPU: the fixture's ``icassp/`` tree, the label loaders, the windowing
ops, the match-mismatch evaluation and the regression blocks on weights
carried across from JAX, the batched probe trainer (from JAX's initial
params, and against the port's own sequential trainer), the sub-specific
fallback (the CLI's default run: ``test_torch_port_eval_cli.py``)."""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.cli import find_icassp_folder as j_find_icassp
from transformer_clip_eeg_tpu.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu.data.fixtures import make_fixture as j_make_fixture
from transformer_clip_eeg_tpu.data.fixtures import regen_icassp_testset as j_regen
from transformer_clip_eeg_tpu.eval import labels as j_labels
from transformer_clip_eeg_tpu.eval import match_mismatch as j_mm
from transformer_clip_eeg_tpu.eval import regression as j_reg
from transformer_clip_eeg_tpu.models.regression import RegressionModel as JProbe
from transformer_clip_eeg_tpu.models.regression import pearson_loss as j_pearson
from transformer_clip_eeg_tpu.models.regression import pearson_loss_mean as j_pearson_mean
from transformer_clip_eeg_tpu.ops import windowing as j_win
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture, regen_icassp_testset
from transformer_clip_eeg_tpu_torch.eval import labels
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.eval.match_mismatch import evaluate_model_challenge_2023_mm
from transformer_clip_eeg_tpu_torch.models.regression import (
    RegressionModel,
    pearson_loss,
    pearson_loss_mean,
)
from transformer_clip_eeg_tpu_torch.ops import windowing
from transformer_clip_eeg_tpu_torch.serve import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import (
    probe_state_dict_from_jax,
    state_dict_from_jax,
)

WL, SP_D, BANK = 64, 8, 16
SMALL = dict(window_length_s=1, fs=WL, attention_depth=2, latent_dim=4, speech_dim_override=SP_D)
FIXTURE = dict(n_stories=3, n_subjects=2, story_seconds=30, speech_dim=SP_D, window_length=WL)
EMB_TOL = 1e-4     # encoder outputs, JAX vs the port (as the serving tests)
LOGIT_TOL = 1e-5   # similarities of L2-normalised embeddings
PROBE_TOL = 1e-4   # probe params after a few Adam epochs from the same start
VAL_TOL = 1e-5     # best validation loss, test loss and challenge r


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers;
    torch's default of one thread a core makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same fixture written by both packages."""
    roots = {}
    for name, make in (("port", make_fixture), ("jax", j_make_fixture)):
        roots[name] = str(tmp_path_factory.mktemp(f"eval_{name}"))
        make(roots[name], **FIXTURE)
    return roots


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model holding the same
    weights), dropout off."""
    jmodel = j_build(JConfig(**SMALL), bank_size=BANK)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0),
        rng.standard_normal((2, WL, 64)).astype(np.float32),
        rng.standard_normal((2, WL, SP_D)).astype(np.float32),
        np.arange(1, 3, dtype=np.int32),
    )))
    tmodel = build_model_from_config(TrainConfig(**SMALL), BANK, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    return jmodel, variables, tmodel.eval()


def _files(root):
    return get_train_val_test_files_final(root, 0, "wav2vec_19", f"{root}/fold_split.json", 2)


# -- the fixture, the loaders, the small ops -----------------------------------

@pytest.mark.parametrize("what", ["make_fixture", "regen_icassp_testset"])
def test_fixture_files_equal_jax(corpus, tmp_path, what):
    """Every file the port writes, the ``icassp/`` tree included, is
    byte-identical to the JAX package's."""
    if what == "make_fixture":
        a, b = corpus["port"], corpus["jax"]
    else:
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        regen_icassp_testset(a, SP_D, WL, n_subjects=3, noise=0.8, seed=2, trials=4)
        j_regen(b, SP_D, WL, n_subjects=3, noise=0.8, seed=2, trials=4)
    files = _tree(a)
    assert files == _tree(b)
    assert any(f.startswith("icassp/TEST_task1_matchmismatch/") for f in files)
    assert any(f.startswith("icassp/TEST_task2_regression/labels/") for f in files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


def test_label_loaders_match_jax(corpus):
    root = corpus["port"]
    mm = os.path.join(root, "icassp", "TEST_task1_matchmismatch", "labels")
    rg = os.path.join(root, "icassp", "TEST_task2_regression", "labels")
    assert labels.load_labels_match_mismatch_2023(mm) == j_labels.load_labels_match_mismatch_2023(mm)
    for sub in (None, "sub-901"):
        got = labels.load_labels_regression_2023(rg, subject=sub)
        assert got == j_labels.load_labels_regression_2023(rg, subject=sub) and got


@pytest.mark.parametrize("layout", ["inside", "sibling", "both", "none"])
def test_find_icassp_folder_matches_jax(tmp_path, layout):
    data = tmp_path / "data"
    data.mkdir()
    task = "TEST_task1_matchmismatch"
    if layout in ("inside", "both"):
        (data / "icassp" / task).mkdir(parents=True)
    if layout in ("sibling", "both"):
        (tmp_path / "ICASSP-2023-eeg-decoding-challenge-dataset" / task).mkdir(parents=True)
    got = cli.find_icassp_folder(str(data), task)
    assert got == j_find_icassp(str(data), task)
    assert (got is None) == (layout == "none")


@pytest.mark.parametrize("shape", [(3, 50, 64), (1, 192, 8)])
def test_mvn_normalize_matches_jax(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3 + 2).astype(np.float32)
    np.testing.assert_allclose(windowing.mvn_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j_win.mvn_normalize(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("n_seg,wl,total", [(5, 16, 48), (5, 16, 40), (7, 192, 768), (1, 8, 8)])
def test_overlap_add_hann_matches_jax(n_seg, wl, total):
    """Hann weights, the boundary correction and samples past ``total``
    dropped; also through the regression module's host wrapper."""
    seg = np.random.default_rng(n_seg).standard_normal((n_seg, wl)).astype(np.float32)
    want = np.asarray(j_win.overlap_add_hann(jnp.asarray(seg), total, wl))
    np.testing.assert_allclose(windowing.overlap_add_hann(torch.from_numpy(seg), total, wl).numpy(),
                               want, atol=1e-6)
    np.testing.assert_allclose(reg.hann_overlap_add(seg, wl, total),
                               j_reg.hann_overlap_add(seg, wl, total), atol=1e-6)
    np.testing.assert_allclose(windowing.hann_window(wl).numpy(),
                               np.asarray(j_win.hann_window(wl)), atol=1e-7)


@pytest.mark.parametrize("target", [12, 4, 7, 6, 13, 20])
def test_match_time_length_matches_jax(target):
    emb = np.arange(36, dtype=np.float32).reshape(2, 6, 3)
    np.testing.assert_array_equal(reg.match_time_length(emb, target),
                                  j_reg.match_time_length(emb, target))


def test_pearson_losses_and_probe_match_jax():
    """The negative-Pearson losses (a constant row takes the eps clamp) and
    the probe's forward on params carried from JAX."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32, 3)).astype(np.float32)
    y = rng.standard_normal((4, 32, 3)).astype(np.float32)
    x[1] = 0.5  # zero variance over time
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(pearson_loss(tx, ty).numpy(), np.asarray(j_pearson(x, y)),
                               atol=1e-6)
    assert float(pearson_loss_mean(tx, ty)) == pytest.approx(float(j_pearson_mean(x, y)),
                                                             abs=1e-6)
    emb = rng.standard_normal((5, 40, 8)).astype(np.float32)
    params = JProbe(output_dim=2).init(jax.random.PRNGKey(3), jnp.asarray(emb[:1]))
    probe = RegressionModel.from_state_dict(probe_state_dict_from_jax(params))
    assert tuple(probe.conv.weight.shape) == (2, 8, 32)
    with torch.no_grad():
        got = probe(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, np.asarray(JProbe(output_dim=2).apply(params, emb)),
                               atol=1e-5)


# -- the match-mismatch evaluation ---------------------------------------------

def test_match_mismatch_matches_jax(corpus, models):
    """On the same weights: logits within 1e-5, and equal accuracies and
    top-X curves.  The smallest gap that decides them (the two candidates'
    logits; the true segment's logit against every other) is checked to be
    well above the tolerance, so no tie can flip."""
    jmodel, variables, tmodel = models
    mm_dir = os.path.join(corpus["port"], "icassp", "TEST_task1_matchmismatch")
    want = j_mm.evaluate_model_challenge_2023_mm(jmodel, variables, mm_dir,
                                                 speech_feature="wav2vec_19", chunk=4)
    got = evaluate_model_challenge_2023_mm(tmodel, mm_dir, speech_feature="wav2vec_19", chunk=4)
    ev, logits, top_x, top_x_logits = got
    assert set(ev) == {"sub-900_mvn", "sub-901_mvn"}
    assert ev == want[0] and top_x == want[2]
    margins, err = [], 0.0
    for sub, per_key in logits.items():
        assert per_key.keys() == want[1][sub].keys()
        for key, (pair, label) in per_key.items():
            np.testing.assert_allclose(pair, want[1][sub][key][0], atol=LOGIT_TOL)
            err = max(err, float(np.abs(np.subtract(pair, want[1][sub][key][0])).max()))
            assert label == want[1][sub][key][1]
            margins.append(abs(pair[0] - pair[1]))
        full = np.asarray(top_x_logits[sub]["logits"])
        np.testing.assert_allclose(full, want[3][sub]["logits"], atol=LOGIT_TOL)
        assert top_x_logits[sub]["correct_keys_idx"] == want[3][sub]["correct_keys_idx"]
        # the top-X curve reads only the true segment's rank in each row
        for row, c in zip(full, top_x_logits[sub]["correct_keys_idx"]):
            margins.append(float(np.min(np.abs(np.delete(row, c) - row[c]))))
        err = max(err, float(np.abs(full - np.asarray(want[3][sub]["logits"])).max()))
    # a gap wider than twice the largest logit error cannot flip (3.8e-5
    # here, against errors under 1e-6)
    assert min(margins) > 2 * err


# -- the regression evaluation -------------------------------------------------

def test_subject_embeddings_match_jax(corpus, models):
    jmodel, variables, tmodel = models
    f = _files(corpus["port"])
    want = j_reg.extract_subject_embeddings(jmodel, variables, f[2], f[6], WL, batch_size=4)
    got = reg.extract_subject_embeddings(tmodel, f[2], f[6], WL, batch_size=4)
    assert got.keys() == want.keys() and got
    for sub in got:
        assert got[sub][0].shape == want[sub][0].shape and got[sub][0].shape[1] == WL
        np.testing.assert_allclose(got[sub][0], want[sub][0], atol=EMB_TOL)
        np.testing.assert_array_equal(got[sub][1], want[sub][1])


def _probe_data(seed=3):
    """Ragged subjects (s2 an exact multiple of the batch); s4's validation
    targets have the sign of its training targets flipped, so its validation
    loss worsens as it learns and it stops early."""
    rng = np.random.default_rng(seed)
    t, d = 24, 4
    ns = {"s1": 50, "s2": 64, "s3": 37, "s4": 45}
    vns = {"s1": 20, "s2": 10, "s3": 30, "s4": 70}

    def mk(n, sign=1.0):
        emb = rng.standard_normal((n, t, d)).astype(np.float32)
        env = sign * emb.sum(-1, keepdims=True) * 0.1 + 0.05 * rng.standard_normal((n, t, 1))
        return emb, env.astype(np.float32)

    subjects = list(ns)
    return (subjects, {s: mk(ns[s]) for s in subjects},
            {s: mk(vns[s], -1.0 if s == "s4" else 1.0) for s in subjects})


def _jax_init(train_by, subjects, seed=0):
    s0 = subjects[0]
    return JProbe(output_dim=train_by[s0][1].shape[-1]).init(
        jax.random.PRNGKey(seed), jnp.asarray(train_by[s0][0][:1]))


EPOCHS, PATIENCE = 20, 2


@pytest.fixture(scope="module")
def probe_runs(tmp_path_factory):
    subjects, train_by, val_by = _probe_data()
    init = probe_state_dict_from_jax(_jax_init(train_by, subjects))
    kw = dict(epochs=EPOCHS, patience=PATIENCE)
    log_dir = tmp_path_factory.mktemp("probe_logs")
    sequential = {s: reg.train_regression_probe(*train_by[s], *val_by[s], init_params=init,
                                                device="cpu", loss_file=str(log_dir / s), **kw)
                  for s in subjects}
    return dict(
        subjects=subjects,
        jax=j_reg.train_regression_probes_batched(subjects, train_by, val_by, **kw),
        port=reg.train_regression_probes_batched(subjects, train_by, val_by, init_params=init,
                                                 device="cpu", **kw),
        sequential=sequential,
        epochs_run={s: len(open(log_dir / s).read().splitlines()) for s in subjects},
    )


def test_batched_probes_match_jax_from_its_initial_params(probe_runs):
    """Per subject, params within 1e-4 and the best validation loss within
    1e-5 of the JAX package's vmapped trainer, with ragged lengths and a
    subject that stops early."""
    assert min(probe_runs["epochs_run"].values()) < EPOCHS  # someone stopped early
    for s in probe_runs["subjects"]:
        (jp, jv), (p, v) = probe_runs["jax"][s], probe_runs["port"][s]
        assert v == pytest.approx(jv, abs=VAL_TOL), s
        want = probe_state_dict_from_jax(jp)
        for k in want:
            np.testing.assert_allclose(p[k].numpy(), want[k].numpy(), atol=PROBE_TOL,
                                       err_msg=f"{s} {k}")


def test_batched_probes_match_sequential(probe_runs):
    """All subjects at once give each subject what the per-subject trainer
    gives it (the JAX package's own check of its vmapped trainer)."""
    for s in probe_runs["subjects"]:
        (sp, sv), (p, v) = probe_runs["sequential"][s], probe_runs["port"][s]
        assert v == pytest.approx(sv, abs=VAL_TOL), s
        for k in sp:
            np.testing.assert_allclose(p[k].numpy(), sp[k].numpy(), atol=PROBE_TOL,
                                       err_msg=f"{s} {k}")


def test_probes_without_init_params_are_seeded():
    subjects, train_by, val_by = _probe_data(4)
    runs = [reg.train_regression_probes_batched(subjects[:2], train_by, val_by, epochs=2,
                                                seed=seed, device="cpu")
            for seed in (5, 5, 6)]
    for k in runs[0]["s1"][0]:
        assert torch.equal(runs[0]["s1"][0][k], runs[1]["s1"][0][k])
    assert not torch.equal(runs[0]["s1"][0]["conv.weight"], runs[2]["s1"][0]["conv.weight"])


def _few_epochs(monkeypatch, jax_too: bool):
    """Both packages' batched trainers at 3 epochs; the port's from JAX's
    initial params, so the probes can be compared."""
    port_orig, jax_orig = reg.train_regression_probes_batched, j_reg.train_regression_probes_batched

    def port(subjects, tr, va, **kw):
        init = probe_state_dict_from_jax(_jax_init(tr, list(subjects)))
        return port_orig(subjects, tr, va, **{**kw, "epochs": 3, "init_params": init})

    monkeypatch.setattr(reg, "train_regression_probes_batched", port)
    if jax_too:
        monkeypatch.setattr(j_reg, "train_regression_probes_batched",
                            lambda *a, **kw: jax_orig(*a, **{**kw, "epochs": 3}))


def test_regression_blocks_and_challenge_match_jax(corpus, models, tmp_path, monkeypatch):
    """The sub-specific and sub-independent blocks (one shared embedding
    cache, as the CLI runs them) and the challenge regression, on the same
    weights and the same initial probes: every evaluation within 1e-5, the
    same files written."""
    _few_epochs(monkeypatch, jax_too=True)
    jmodel, variables, tmodel = models
    root = corpus["port"]
    f = _files(root)
    args = (f[0], f[1], f[2], f[4], f[5], f[6])
    kw = dict(window_length=1, fs=WL, batch_size=4)
    out = {}
    for name in ("jax", "port"):
        rd = str(tmp_path / name)
        os.makedirs(rd)
        cache: dict = {}
        if name == "jax":
            blocks = [fn(jmodel, variables, *args, rd, embeddings_cache=cache, **kw)
                      for fn in (j_reg.evaluate_model_do_regression_sub_specific,
                                 j_reg.evaluate_model_do_regression_sub_independent)]
            blocks += j_reg.evaluate_model_challenge_2023_regression(
                jmodel, variables, rd, os.path.join(root, "icassp", "TEST_task2_regression"))
        else:
            blocks = [fn(tmodel, *args, rd, embeddings_cache=cache, **kw)
                      for fn in (reg.evaluate_model_do_regression_sub_specific,
                                 reg.evaluate_model_do_regression_sub_independent)]
            blocks += reg.evaluate_model_challenge_2023_regression(
                tmodel, rd, os.path.join(root, "icassp", "TEST_task2_regression"))
        out[name] = (rd, blocks)
    (jrd, want), (rd, got) = out["jax"], out["port"]
    # the same names (a probe is one torch file here, an orbax directory there)
    for sub in ("", "sub_specific", "regression_2023_icassp"):
        assert sorted(os.listdir(os.path.join(rd, sub))) == \
            sorted(os.listdir(os.path.join(jrd, sub)))
    assert [len(b) for b in got] == [2, 2, 2, 0]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == pytest.approx(w[k], abs=VAL_TOL), k
    for name in os.listdir(os.path.join(rd, "regression_2023_icassp")):
        with open(os.path.join(rd, "regression_2023_icassp", name)) as a, \
                open(os.path.join(jrd, "regression_2023_icassp", name)) as b:
            pa, pb = json.load(a), json.load(b)
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], atol=VAL_TOL)
    # the sub-independent block loads a probe that exists rather than train
    again = reg.evaluate_model_do_regression_sub_independent(tmodel, *args, rd, **kw)
    assert again == got[1]


def test_sub_specific_falls_back_to_sequential_probes(corpus, models, tmp_path, monkeypatch):
    """If training all probes at once fails, each subject is trained on its
    own: the failure and the per-epoch losses are written, every subject
    still gets a probe and an evaluation."""
    def boom(*a, **k):
        raise RuntimeError("injected batched-probe failure")

    seq = reg.train_regression_probe
    monkeypatch.setattr(reg, "train_regression_probes_batched", boom)
    monkeypatch.setattr(reg, "train_regression_probe", lambda *a, **k: seq(*a, **{**k, "epochs": 2}))
    f = _files(corpus["port"])
    rd = str(tmp_path)
    ev = reg.evaluate_model_do_regression_sub_specific(
        models[2], f[0], f[1], f[2], f[4], f[5], f[6], rd, window_length=1, fs=WL, batch_size=4)
    assert len(ev) == 2 and all(-1.0 <= v <= 1.0 for v in ev.values())
    with open(os.path.join(rd, "error_regression.txt")) as fh:
        assert "falling back to sequential" in fh.read()
    with open(os.path.join(rd, "loss_regression.txt")) as fh:
        assert "val_loss" in fh.read()
    assert sorted(os.listdir(os.path.join(rd, "sub_specific"))) == sorted(
        f"regression_model_{s}" for s in ev)
