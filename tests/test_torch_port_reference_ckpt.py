"""Torch port, the reference's ``checkpoints/model.ckpt`` (``utils/
torch_import.py``, ``utils/torch_export.py``, ``train/checkpoint.
restore_torch_checkpoint``) against the JAX package's interop on the CPU.

The reference's code is not in the repo, so reference-named state_dicts come
from ``torch_export.reference_layout`` and are held to JAX's key grammar:
JAX's ``convert_state_dict`` takes them with no key unmatched and gives
back JAX's variables.  For the flagship, Z1-Z6 (PERF.md §4) at a small
width and the regression probe: the port's import of JAX's export equals
``utils/convert.py``'s carry of the same variables, and the port's export
equals JAX's, key for key, bit for bit; the partial-load semantics; resume
through ``Trainer.fit``; ``--only_evaluate`` on a reference results
directory against JAX's CLI on the same file (every number of the 8 JSON
files within 1e-5); the ``torch_export`` CLI."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformer_clip_eeg_tpu.cli as j_cli
from transformer_clip_eeg_tpu.eval import regression as j_reg
from transformer_clip_eeg_tpu.models.regression import RegressionModel as JProbe
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.utils import torch_export as j_export
from transformer_clip_eeg_tpu.utils import torch_import as j_import
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.loop import Trainer
from transformer_clip_eeg_tpu_torch.utils import torch_export, torch_import
from transformer_clip_eeg_tpu_torch.utils.convert import (
    _torch_leaf,
    probe_state_dict_from_jax,
    state_dict_from_jax,
    variables_from_state_dict,
)

B, T, SP_D = 2, 32, 12
CONFIGS = {
    "flagship": dict(),
    "Z1": dict(eeg_encoder="conformer", speech_encoder="convLSTM", model_arch="clip_sim"),
    "Z2": dict(eeg_encoder="convLSTM", speech_encoder="smallConv", model_arch="clip_mp"),
    "Z3": dict(eeg_encoder="convLSTMnew", speech_encoder="convLSTM", model_arch="clip_kld"),
    "Z4": dict(eeg_encoder="lstm", speech_encoder="lstm", stimulus_features="mel",
               model_arch="no_contrastive_learning"),
    "Z5": dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
               model_arch="clip_kld_latent_proj"),
    "Z6": dict(eeg_encoder="vlaai", speech_encoder="Wav2vecSmallModel", model_arch="clip_sim"),
}
EVAL_TOL = 1e-5  # every number of the eval JSONs, JAX vs the port on the same weights


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_PAIRS: dict = {}


def _pair(name):
    """(JAX variables, the port model holding them) at a small width, random
    weights from seed 0, every collection (bank, batch statistics)
    included."""
    if name not in _PAIRS:
        kw = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4, lstm_units=8,
                  **CONFIGS[name])
        if kw.get("stimulus_features") != "mel":
            kw["speech_dim_override"] = SP_D
        tcfg = TrainConfig(**kw)
        rng = np.random.default_rng(0)
        jmodel = j_build(JConfig(**kw), bank_size=16)
        variables = jax.tree.map(np.asarray, dict(jmodel.init(
            {"params": jax.random.PRNGKey(0)},
            rng.standard_normal((B, T, 64)).astype(np.float32),
            rng.standard_normal((B, T, tcfg.speech_dimension)).astype(np.float32),
            np.array([3, 1], np.int32))))
        tmodel = build_model_from_config(tcfg, 16, device="cpu", seed=1)
        tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
        _PAIRS[name] = (variables, tmodel)
    return _PAIRS[name]


def _trees_equal(a, b, path=()):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _trees_equal(a[k], b[k], path + (k,))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def _sd_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        g = got[k].numpy() if hasattr(got[k], "numpy") else np.asarray(got[k])
        w = want[k].numpy() if hasattr(want[k], "numpy") else np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_layout_follows_the_jax_grammar(name):
    """JAX's ``convert_state_dict`` takes every key of the port's
    ``reference_layout`` and reproduces JAX's variables bit for bit, and the
    port's inverse carry is JAX's tree."""
    variables, tmodel = _pair(name)
    layout = torch_export.reference_layout(tmodel)
    converted, unmatched = j_import.convert_state_dict(layout, variables)
    assert unmatched == []
    _trees_equal(converted, variables)
    _trees_equal(variables_from_state_dict(tmodel), variables)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_imports_the_jax_export(name):
    """JAX's export of its variables in the reference layout, imported by the
    port: ``utils/convert.py``'s carry of the same variables, bit for bit,
    nothing reported."""
    variables, tmodel = _pair(name)
    layout = torch_export.reference_layout(tmodel)
    exported, _ = j_export.export_state_dict(variables, layout)
    merged, report = torch_import.load_torch_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in exported.items()}, tmodel)
    assert report == []
    _sd_equal(merged, state_dict_from_jax(variables, tmodel))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_export_equals_jax(name):
    """The port's export of a model equals JAX's export of the same
    variables key for key, bit for bit, with the same report (a batch norm's
    ``num_batches_tracked`` keeps its template value)."""
    variables, tmodel = _pair(name)
    layout = torch_export.reference_layout(tmodel)
    got, report = torch_export.export_state_dict(tmodel, layout)
    want, j_report = j_export.export_state_dict(variables, layout)
    assert report == j_report
    assert list(got) == list(want) == list(layout)
    _sd_equal(got, want)
    if name == "Z4":
        assert report and all(r.endswith("num_batches_tracked") for r in report)


def test_partial_load_semantics():
    """As JAX ``tests/test_torch_ckpt_e2e.py:126``: a key that matches nothing
    is reported, a template leaf with no entry keeps its value, a shape
    mismatch is skipped and reported; the merge equals JAX's on the same
    file, carried."""
    variables, tmodel = _pair("flagship")
    other = build_model_from_config(TrainConfig(window_length_s=1, fs=T, attention_depth=2,
                                                latent_dim=4, speech_dim_override=SP_D),
                                    16, device="cpu", seed=7)
    sd = torch_export.reference_layout(other)
    sd["not_a_real.module.weight"] = torch.zeros(3, 3)
    del sd["temperature"]
    bad = "eegModel.final_layer.weight"
    sd[bad] = torch.zeros(5, 64)
    merged, report = torch_import.load_torch_state_dict(sd, tmodel)
    j_merged, j_report = j_import.load_torch_state_dict(sd, variables)
    assert "not_a_real.module" in report and bad in report and len(report) == 2
    tpl = variables_from_state_dict(tmodel)
    mapped = []
    for item in j_report:
        if "/" not in item:
            mapped.append(item)
            continue
        coll, *path = item.split("/")
        leaf = tpl[coll]
        for p in path:
            leaf = leaf[p]
        mapped.append(_torch_leaf(coll, tuple(path), leaf)[0])
    assert mapped == report
    assert torch.equal(merged["temperature"], tmodel.state_dict()["temperature"])
    assert torch.equal(merged[bad], tmodel.state_dict()[bad])
    _sd_equal(merged, state_dict_from_jax(jax.tree.map(np.asarray, j_merged), tmodel))


def test_restore_torch_checkpoint_prints_what_it_skips(tmp_path, capsys):
    """``train/checkpoint.restore_torch_checkpoint``: the model takes the
    file's weights in place, each skipped item printed as JAX prints it;
    no file: None."""
    variables, tmodel = _pair("flagship")
    assert ckpt_lib.restore_torch_checkpoint(str(tmp_path), tmodel) is None
    other = build_model_from_config(TrainConfig(window_length_s=1, fs=T, attention_depth=2,
                                                latent_dim=4, speech_dim_override=SP_D),
                                    16, device="cpu", seed=8)
    sd = torch_export.reference_layout(other)
    sd["not_a_real.module.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / "model.ckpt")
    model = build_model_from_config(TrainConfig(window_length_s=1, fs=T, attention_depth=2,
                                                latent_dim=4, speech_dim_override=SP_D),
                                    16, device="cpu", seed=9)
    assert ckpt_lib.restore_torch_checkpoint(str(tmp_path), model) == ["not_a_real.module"]
    assert "torch checkpoint: skipped not_a_real.module" in capsys.readouterr().out
    _sd_equal(model.state_dict(), other.state_dict())


def _module_with(state_dict):
    """A bare module tree whose ``state_dict`` holds exactly these keys (the
    reference's classes are not in the repo)."""
    root = torch.nn.Module()
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            if p not in node._modules:
                node.add_module(p, torch.nn.Module())
            node = node._modules[p]
        node.register_buffer(leaf, t.clone())
    return root


def test_module_walkers_take_the_state_dict_path(tmp_path):
    """``convert_head``, ``convert_encoder`` and ``load_torch_checkpoint`` on a
    module holding reference-named tensors: the grammar's conversion of its
    ``state_dict``, equal to JAX's walk-free conversion, carried."""
    variables, tmodel = _pair("Z3")
    layout = torch_export.reference_layout(tmodel)
    head = _module_with(layout)
    want = state_dict_from_jax(variables, tmodel)
    _sd_equal(torch_import.convert_head(head, tmodel), want)
    eeg = _module_with({k[len("eegModel."):]: v for k, v in layout.items()
                        if k.startswith("eegModel.")})
    got = torch_import.convert_encoder(eeg, tmodel.eegModel)
    _sd_equal(got, {k[len("eegModel."):]: v for k, v in want.items()
                    if k.startswith("eegModel.")})
    torch.save(layout, tmp_path / "model.ckpt")
    loaded = torch_import.load_torch_checkpoint(str(tmp_path / "model.ckpt"),
                                                lambda: _module_with(layout), tmodel)
    _sd_equal(loaded, want)


def test_regression_probe_walker_matches_jax():
    """``convert_regression_model`` on a module shaped as the reference's
    probe (a Conv1d named ``conv``) equals JAX's walker, carried."""
    probe = torch.nn.Module()
    torch.manual_seed(3)
    probe.conv = torch.nn.Conv1d(5, 1, 32)
    got = torch_import.convert_regression_model(probe)
    _sd_equal(got, probe_state_dict_from_jax(j_import.convert_regression_model(probe)))
    assert torch.equal(got["conv.weight"], probe.conv.weight.detach())


# -- the training and command-line paths --------------------------------------

WL, EVAL_SP_D = 64, 8
FIXTURE = dict(n_stories=3, n_subjects=2, story_seconds=30, speech_dim=EVAL_SP_D,
               window_length=WL)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_ckpt_data"))
    make_fixture(root, **FIXTURE)
    return root


def _run_kw(root):
    return dict(data_dir=root, run=0, window_length_s=1, fs=WL, attention_depth=2,
                latent_dim=4, speech_dim_override=EVAL_SP_D, number_of_training_subjects=2,
                batch_size=4, epochs=1)


def _bank_size(cfg) -> int:
    files = get_train_val_test_files_final(cfg.data_dir, cfg.run, cfg.stimulus_features,
                                           cfg.fold_split_path, cfg.number_of_training_subjects)
    return max(EEGWindowDataset(files[i], files[4 + i], cfg.window_length, cfg.hop_length,
                                batch_size=cfg.batch_size, seed=cfg.seed
                                ).get_number_of_stimuli_segments() for i in (0, 1))


@pytest.fixture(scope="module")
def reference_run(root, tmp_path_factory):
    """A reference results directory: ``args.txt`` and a ``model.ckpt``
    written by JAX's ``save_torch_checkpoint`` from its own random weights
    (seed 2) in the reference layout; returns (dir, JAX variables, the
    port's config)."""
    cfg = TrainConfig(**_run_kw(root))
    cfg.bank_size = _bank_size(cfg)
    jmodel = j_build(JConfig(**cfg.to_dict()), bank_size=cfg.bank_size)
    rng = np.random.default_rng(2)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(2), rng.standard_normal((B, WL, 64)).astype(np.float32),
        rng.standard_normal((B, WL, EVAL_SP_D)).astype(np.float32),
        np.arange(1, 3, dtype=np.int32))))
    tmodel = build_model_from_config(cfg, cfg.bank_size, device="cpu")
    rd = str(tmp_path_factory.mktemp("reference_run"))
    os.makedirs(os.path.join(rd, "checkpoints"))
    JConfig(**cfg.to_dict()).save(os.path.join(rd, "args.txt"))
    j_export.save_torch_checkpoint(variables, torch_export.reference_layout(tmodel),
                                   os.path.join(rd, "checkpoints", "model.ckpt"))
    return rd, variables, cfg


def test_training_resumes_from_the_reference_checkpoint(reference_run, tmp_path, capsys):
    """``Trainer.fit`` in a results directory holding only ``model.ckpt``:
    ``loaded model from``; before the first step the weights, bank and
    batch-norm statistics are JAX's ``load_torch_state_dict`` of the same
    file, carried, bit for bit; the optimizer starts fresh; training goes
    on and writes the port's checkpoint."""
    src, variables, cfg = reference_run
    rd = str(tmp_path / "resume")
    os.makedirs(os.path.join(rd, "checkpoints"))
    shutil.copy(os.path.join(src, "checkpoints", "model.ckpt"), os.path.join(rd, "checkpoints"))
    files = get_train_val_test_files_final(cfg.data_dir, cfg.run, cfg.stimulus_features,
                                           cfg.fold_split_path, cfg.number_of_training_subjects)
    ds = [EEGWindowDataset(files[i], files[4 + i], cfg.window_length, cfg.hop_length,
                           batch_size=cfg.batch_size, seed=cfg.seed) for i in (0, 1)]
    trainer = Trainer(TrainConfig(**_run_kw(cfg.data_dir)), *ds, results_dir=rd, device="cpu")
    seen = {}
    real = ckpt_lib.restore_torch_checkpoint

    def restore(checkpoint_dir, model):
        out = real(checkpoint_dir, model)
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["step"] = trainer.optimizer.step
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ckpt_lib, "restore_torch_checkpoint", restore)
    try:
        out = trainer.fit()
    finally:
        mp.undo()
    assert "loaded model from" in capsys.readouterr().out
    with open(trainer.loss_file) as f:
        assert any(line.startswith("loaded model from") for line in f)
    j_merged, j_report = j_import.load_torch_state_dict(
        os.path.join(rd, "checkpoints", "model.ckpt"), variables)
    assert j_report == [] and seen["step"] == 0
    _sd_equal(seen["state"], state_dict_from_jax(jax.tree.map(np.asarray, j_merged),
                                                 trainer.model))
    assert len(out["history"]) == 1
    assert os.path.exists(ckpt_lib.checkpoint_path(trainer.checkpoint_dir))


def _jax_probe_init(train_by, subjects):
    s0 = subjects[0]
    return JProbe(output_dim=train_by[s0][1].shape[-1]).init(
        jax.random.PRNGKey(0), jnp.asarray(train_by[s0][0][:1]))


def _numbers(obj, path=""):
    if isinstance(obj, dict):
        return [v for k in sorted(obj) for v in _numbers(obj[k], f"{path}/{k}")]
    if isinstance(obj, list):
        return [v for i, x in enumerate(obj) for v in _numbers(x, f"{path}[{i}]")]
    return [(path, obj)]


def test_only_evaluate_on_a_reference_directory_matches_jax(reference_run, tmp_path,
                                                           monkeypatch, capsys):
    """``--only_evaluate yes`` on a directory holding ``args.txt`` and
    ``model.ckpt``, the port's CLI against JAX's on the same file (the
    probes from JAX's initial params, 3 epochs on both sides): the same 8
    files, every number within 1e-5."""
    src, _, _ = reference_run
    dirs = {name: str(tmp_path / name) for name in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(src, d)
    port_probes, jax_probes = reg.train_regression_probes_batched, \
        j_reg.train_regression_probes_batched

    def port(subjects, tr, va, **kw):
        init = probe_state_dict_from_jax(_jax_probe_init(tr, list(subjects)))
        return port_probes(subjects, tr, va, **{**kw, "epochs": 3, "init_params": init})

    monkeypatch.setattr(reg, "train_regression_probes_batched", port)
    monkeypatch.setattr(j_reg, "train_regression_probes_batched",
                        lambda *a, **kw: jax_probes(*a, **{**kw, "epochs": 3}))
    assert j_cli.main(["--only_evaluate", "yes", "--results_folder", dirs["jax"]]) == 0
    assert cli.main(["--only_evaluate", "yes", "--results_folder", dirs["port"]],
                    device="cpu") == 0
    assert "loaded model from" in capsys.readouterr().out
    names = [n for n in os.listdir(dirs["jax"]) if n.endswith(".json")]
    assert len(names) == 8 and sorted(names) == sorted(
        n for n in os.listdir(dirs["port"]) if n.endswith(".json"))
    for name in names:
        with open(os.path.join(dirs["jax"], name)) as a, \
                open(os.path.join(dirs["port"], name)) as b:
            want, got = _numbers(json.load(a)), _numbers(json.load(b))
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, g), (_, w) in zip(got, want):
            if isinstance(w, (int, float)) and not isinstance(w, bool):
                assert g == pytest.approx(w, abs=EVAL_TOL), (name, path)
            else:
                assert g == w, (name, path)


def test_torch_export_cli(reference_run, tmp_path, capsys):
    """``python -m transformer_clip_eeg_tpu_torch.utils.torch_export --run
    --template --out`` on a port run's checkpoint: the file equals the
    port's ``export_state_dict`` and JAX's export of the same weights, bit
    for bit, and imports back to the checkpoint; no checkpoint: a usage
    error, as in JAX."""
    _, _, cfg = reference_run
    model = build_model_from_config(cfg, cfg.bank_size, device="cpu", seed=4)
    run = str(tmp_path / "run")
    os.makedirs(os.path.join(run, "checkpoints"))
    torch.save({"step": 3, "model": model.state_dict(), "optimizer": {}, "scheduler": {}},
               ckpt_lib.checkpoint_path(os.path.join(run, "checkpoints")))
    template = str(tmp_path / "template.ckpt")
    torch.save(torch_export.reference_layout(
        build_model_from_config(cfg, cfg.bank_size, device="cpu", seed=9)), template)
    out = str(tmp_path / "model.ckpt")
    assert torch_export.main(["--run", run, "--template", template, "--out", out]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    written = torch.load(out, weights_only=True)
    _sd_equal(written, torch_export.export_state_dict(model, torch.load(template))[0])
    want, _ = j_export.export_state_dict(variables_from_state_dict(model), torch.load(template))
    _sd_equal(written, want)
    merged, report = torch_import.load_torch_state_dict(out, model)
    assert report == []
    _sd_equal(merged, model.state_dict())
    with pytest.raises(SystemExit):
        torch_export.main(["--run", str(tmp_path / "nothing"), "--template", template,
                           "--out", out])
