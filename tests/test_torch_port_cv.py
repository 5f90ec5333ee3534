"""Torch port, the cross-validation driver (``cv.py``) on the CPU, at a small
width on JAX's CV fixture (3 stories, 2 subjects, 45 s): ``cv.main`` with
``--parallel no`` and ``--parallel yes`` (train, each fold's evaluation
suite, ``cv_summary.json``), the summary against the JAX driver's
aggregation of the same per-fold JSONs, the ingest file cache against JAX
``tests/test_ingest_cache.py``, the host-memory helpers against JAX's, and
training resumed from a fold's weights exported as the reference's
``model.ckpt``."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import transformer_clip_eeg_tpu.cli as j_cli
from transformer_clip_eeg_tpu import cv as j_cv
from transformer_clip_eeg_tpu.data.dataset import EEGWindowDataset as JDataset
from transformer_clip_eeg_tpu.utils import platform as j_platform
from transformer_clip_eeg_tpu_torch import cli, cv
from transformer_clip_eeg_tpu_torch.data import dataset as port_dataset
from transformer_clip_eeg_tpu_torch.data.dataset import (
    EEGWindowDataset,
    _cached_load,
    set_ingest_file_cache,
)
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.serve import InferenceSession
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils import platform, torch_export
from transformer_clip_eeg_tpu_torch.utils.torch_export import reference_layout

SMALL_FLAGS = ["--epochs", "1", "--batch_size", "4", "--attention_depth", "1",
               "--latent_dim", "4", "--lstm_units", "8", "--speech_dim_override", "8",
               "--number_of_training_subjects", "2"]
WL = 192



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ingest_cache_left():
    """The cache is process-wide: no test leaves it installed."""
    yield
    assert port_dataset._FILE_CACHE is None
    set_ingest_file_cache(None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cv_data"))
    make_fixture(root, n_stories=3, n_subjects=2, story_seconds=45, speech_dim=8)
    return root


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """``cv.main`` once per mode, the regression probes at 2 epochs (250 is
    the reference's); the suites see the ingest cache installed."""
    mp = pytest.MonkeyPatch()
    probes = reg.train_regression_probes_batched
    mp.setattr(reg, "train_regression_probes_batched",
               lambda *a, **k: probes(*a, **{**k, "epochs": 2}))
    suite, cache_seen = cli.run_eval_suite, []

    def run_eval_suite(*a, **k):
        cache_seen.append(port_dataset._FILE_CACHE is not None)
        suite(*a, **k)
        cache_seen.append(len(port_dataset._FILE_CACHE or {}))

    mp.setattr(cli, "run_eval_suite", run_eval_suite)
    out = {}
    for mode, folds in (("no", ["0"]), ("yes", ["0", "1"])):
        results = str(tmp_path_factory.mktemp(f"cv_parallel_{mode}"))
        cache_seen.clear()
        rc = cv.main(["--folds", *folds, "--parallel", mode, "--data_dir", root,
                      "--results_folder", results, *SMALL_FLAGS], device="cpu")
        with open(os.path.join(results, "cv_summary.json")) as f:
            out[mode] = dict(rc=rc, results=results, summary=json.load(f),
                             cache_seen=list(cache_seen))
    mp.undo()
    return out


def test_sequential_folds_write_the_summary(runs):
    """``--parallel no --folds 0``: one ``cli.main`` run, its suite, and the
    summary of its JSONs (no ingest cache: that is the parallel path's)."""
    run = runs["no"]
    assert run["rc"] == 0
    assert set(run["summary"]["folds"]) == {"0"}
    fold = run["summary"]["folds"]["0"]
    assert os.path.basename(fold["results_dir"]).startswith("results_clip_sim_no_latent_proj")
    assert np.isfinite(fold["mm_accuracy_mean"])
    assert run["summary"]["mm_accuracy_mean_over_folds"] == fold["mm_accuracy_mean"]
    assert run["cache_seen"] == [False, 0]


def test_parallel_folds_write_the_summary_and_serve(runs):
    """``--parallel yes --folds 0 1``: both folds trained in one run, each
    fold's suite into ``fold_{f}/`` with the ingest cache installed (and
    filled), the summary over both, and each fold directory served."""
    run = runs["yes"]
    assert run["rc"] == 0
    summary = run["summary"]
    assert set(summary["folds"]) == {"0", "1"}
    for f in ("0", "1"):
        d = os.path.join(run["results"], f"fold_{f}")
        assert summary["folds"][f]["results_dir"] == d
        assert os.path.exists(os.path.join(d, "evaluation_challenge_set_2023_mm.json"))
        assert np.isfinite(summary["folds"][f]["mm_accuracy_mean"])
        assert TrainConfig.load(os.path.join(d, "args.txt")).run == int(f)
        session = InferenceSession.from_results_dir(d, chunk=4, device="cpu")
        emb = session.embed_eeg(np.random.default_rng(0).standard_normal(
            (2, WL, 64)).astype(np.float32))
        assert np.isfinite(emb).all()
    assert summary["mm_accuracy_mean_over_folds"] is not None
    assert run["cache_seen"][0::2] == [True, True]
    assert all(n > 0 for n in run["cache_seen"][1::2])
    with open(os.path.join(run["results"], "loss.txt")) as f:
        assert f.readline().startswith("fold-parallel over folds [0, 1]: ")


@pytest.mark.parametrize("mode", ["no", "yes"])
def test_summary_aggregates_as_the_jax_driver(runs, mode, monkeypatch, tmp_path):
    """The JAX driver (its sequential path, whose aggregation both modes
    share) on the same per-fold JSONs: a stand-in for its ``cli.main``
    copies each fold's files of the port's run into a new results dir.  Its
    summary equals the port's, results dirs aside."""
    run = runs[mode]
    port_dirs = {f: s["results_dir"] for f, s in run["summary"]["folds"].items()}
    jax_results = str(tmp_path / "jax")

    def train_main(argv):
        fold = argv[argv.index("--run") + 1]
        dst = os.path.join(jax_results, f"results_fold_{fold}")
        shutil.copytree(port_dirs[fold], dst,
                        ignore=shutil.ignore_patterns("checkpoints", "*.txt"))
        return 0

    monkeypatch.setattr(j_cli, "main", train_main)
    assert j_cv.main(["--folds", *sorted(port_dirs), "--results_folder", jax_results]) == 0
    with open(os.path.join(jax_results, "cv_summary.json")) as f:
        want = json.load(f)

    def strip(summary):
        return {**summary, "folds": {f: {k: v for k, v in s.items() if k != "results_dir"}
                                     for f, s in summary["folds"].items()}}

    assert strip(run["summary"]) == strip(want)
    assert strip(cv.summarize(port_dirs)) == strip(want)


def test_summary_skips_missing_and_empty_files(tmp_path):
    """A fold without the suite's files, or with empty ones, has only its
    results dir; no fold with an accuracy gives ``None`` over the folds."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "evaluation_challenge_set_2023_mm.json").write_text("{}")
    out = cv.summarize({0: str(tmp_path / "a"), 3: str(tmp_path / "b")})
    assert out == {"folds": {"0": {"results_dir": str(tmp_path / "a")},
                             "3": {"results_dir": str(tmp_path / "b")}},
                   "mm_accuracy_mean_over_folds": None}


class _FakeTrainer:
    """Stands in for ``FoldParallelTrainer`` and records its arguments."""

    seen: dict = {}

    def __init__(self, cfg, folds, union_files, union_audio, results_root, **kw):
        _FakeTrainer.seen = dict(cfg=cfg, folds=folds, root=results_root, n=len(union_files),
                                 union=(union_files, union_audio), **kw)
        self.dirs = [os.path.join(results_root, f"fold_{f}") for f in folds]

    def fit(self):
        for d in self.dirs:
            os.makedirs(d)
        return {"best_loss": [1.0] * len(self.dirs), "fold_dirs": self.dirs}

    def release_host_data(self):
        _FakeTrainer.seen["released"] = True


@pytest.mark.parametrize("flag,want", [([], None), (["--fold_group_size", "auto"], "auto"),
                                       (["--fold_group_size", "1"], 1)])
def test_parallel_flags_reach_the_trainer(root, tmp_path, monkeypatch, flag, want):
    """``--fold_group_size``, the folds, the union of fold 0's train and val
    files, the pass-through flags and ``device`` reach the trainer; with
    ``--skip_eval yes`` no suite runs, and the cache is cleared after."""
    from transformer_clip_eeg_tpu_torch.train import fold_parallel

    monkeypatch.setattr(fold_parallel, "FoldParallelTrainer", _FakeTrainer)
    monkeypatch.setattr(cli, "run_eval_suite", lambda *a, **k: pytest.fail("suite ran"))
    results = str(tmp_path / "res")
    assert cv.main(["--folds", "0", "1", "--parallel", "yes", *flag, "--data_dir", root,
                    "--results_folder", results, "--skip_eval", "yes", "--learning_rate",
                    "0.01", *SMALL_FLAGS], device="cpu") == 0
    seen = _FakeTrainer.seen
    assert (seen["folds"], seen["fold_group_size"], str(seen["device"])) == ([0, 1], want, "cpu")
    assert seen["root"] == results and seen["released"]
    assert seen["cfg"].learning_rate == 0.01 and seen["cfg"].results_folder == results
    files = get_train_val_test_files_final(root, 0, "wav2vec_19",
                                           seen["cfg"].fold_split_path, 2)
    assert seen["n"] == len(files[0]) + len(files[1])
    with open(os.path.join(results, "cv_summary.json")) as f:
        assert set(json.load(f)["folds"]) == {"0", "1"}


def test_the_union_is_the_same_whatever_the_folds(root, tmp_path, monkeypatch):
    """The union the trainer gets, train and val files of fold 0 or of fold
    1, sorted: the same lists for ``--folds 0 1`` and ``--folds 1``, so that
    a fold alone sees the chunk order (and bank rows) it sees among others."""
    from transformer_clip_eeg_tpu_torch.train import fold_parallel

    monkeypatch.setattr(fold_parallel, "FoldParallelTrainer", _FakeTrainer)
    unions = []
    for folds in (["0", "1"], ["1"]):
        assert cv.main(["--folds", *folds, "--parallel", "yes", "--data_dir", root,
                        "--results_folder", str(tmp_path / "_".join(folds)), "--skip_eval",
                        "yes", *SMALL_FLAGS], device="cpu") == 0
        unions.append(_FakeTrainer.seen["union"])
    assert unions[0] == unions[1]
    files, audio = unions[0]
    assert files == sorted(files) and audio == sorted(audio) and len(set(files)) == len(files)
    split = get_train_val_test_files_final(root, 1, "wav2vec_19",
                                           os.path.join(root, "fold_split.json"), 2)
    assert set(files) == set(split[0] + split[1]) and set(audio) == set(split[4] + split[5])


def test_a_raising_suite_leaves_no_cache_installed(root, tmp_path, monkeypatch):
    """The cache is cleared and the heap trimmed when a suite raises."""
    from transformer_clip_eeg_tpu_torch.train import fold_parallel

    _FakeTrainer.fold_state = lambda self, fold: type("M", (), {"eval": lambda s: s})()
    monkeypatch.setattr(fold_parallel, "FoldParallelTrainer", _FakeTrainer)
    trims = []
    monkeypatch.setattr(cv, "trim_host_heap", lambda: trims.append(1))

    def suite(*a, **k):
        assert port_dataset._FILE_CACHE is not None
        raise RuntimeError("suite failed")

    monkeypatch.setattr(cli, "run_eval_suite", suite)
    with pytest.raises(RuntimeError, match="suite failed"):
        cv.main(["--folds", "0", "--parallel", "yes", "--data_dir", root,
                 "--results_folder", str(tmp_path), *SMALL_FLAGS], device="cpu")
    assert port_dataset._FILE_CACHE is None and trims == [1]
    del _FakeTrainer.fold_state


def test_parallel_refuses_a_mesh(root, tmp_path):
    """``--parallel yes --n_data_shards N`` is ported
    (``tests/test_torch_port_fold_mesh.py``): folds that do not divide over
    the N ranks raise JAX's ``ValueError`` before any rank starts."""
    with pytest.raises(ValueError, match="1 folds do not shard evenly over the mesh's "
                                         "2-device 'data' axis"):
        cv.main(["--folds", "0", "--parallel", "yes", "--n_data_shards", "2", "--data_dir",
                 root, "--results_folder", str(tmp_path), *SMALL_FLAGS], device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "cv_summary.json"))


# -- the ingest file cache, as JAX tests/test_ingest_cache.py ----------------


@pytest.fixture(scope="module")
def cache_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ingest_cache_corpus"))
    make_fixture(root, n_stories=4, n_subjects=3, story_seconds=120, speech_dim=8,
                 window_length=WL, seed=3)
    return root


def test_cached_load_disabled_returns_heap_array(tmp_path):
    path = os.path.join(tmp_path, "x.npy")
    np.save(path, np.arange(12.0).reshape(3, 4))
    arr = _cached_load(path)
    assert not isinstance(arr, np.memmap) and arr.flags.writeable
    np.testing.assert_array_equal(arr, np.arange(12.0).reshape(3, 4))


def test_cached_load_memoizes_readonly_memmaps(tmp_path):
    path = os.path.join(tmp_path, "x.npy")
    ref = np.arange(30.0).reshape(5, 6)
    np.save(path, ref)
    cache = {}
    set_ingest_file_cache(cache)
    try:
        arr = _cached_load(path)
        assert isinstance(arr, np.memmap) and not arr.flags.writeable
        np.testing.assert_array_equal(np.asarray(arr), ref)
        assert _cached_load(path) is arr and cache[path] is arr
        with pytest.raises((ValueError, RuntimeError)):
            arr[0, 0] = -1.0
    finally:
        set_ingest_file_cache(None)


def _ingest(root, io_workers, cache):
    tr, _va, _te, _teh, tra, *_ = get_train_val_test_files_final(
        root, 0, "wav2vec_19", os.path.join(root, "fold_split.json"), 1000)
    set_ingest_file_cache(cache)
    try:
        return EEGWindowDataset(tr, tra, WL, WL, batch_size=8, seed=0, io_workers=io_workers)
    finally:
        set_ingest_file_cache(None)


@pytest.mark.parametrize("io_workers", [1, 4])
def test_ingest_identical_with_cache_installed(cache_root, io_workers):
    """Ingest with the cache installed (serial and threaded reads) gives the
    chunks of a plain ingest and of JAX's dataset byte for byte; every file it
    read is cached as a read-only memmap, and a second ingest from the warm
    cache is byte-identical too."""
    baseline = _ingest(cache_root, 1, None)
    tr, _va, _te, _teh, tra, *_ = get_train_val_test_files_final(
        cache_root, 0, "wav2vec_19", os.path.join(cache_root, "fold_split.json"), 1000)
    jax_ds = JDataset(tr, tra, WL, WL, batch_size=8, seed=0, io_workers=1)
    cache = {}
    cached = _ingest(cache_root, io_workers, cache)
    assert baseline.chunks and sorted(cached.chunks) == sorted(baseline.chunks)
    assert list(cached.chunks) == list(jax_ds.chunks)
    for key, chunk in baseline.chunks.items():
        got = cached.chunks[key]
        for feat in ("eeg", "wav2vec_19"):
            np.testing.assert_array_equal(got[feat], chunk[feat])
            np.testing.assert_array_equal(got[feat], jax_ds.chunks[key][feat])
            if isinstance(got[feat], np.memmap) or isinstance(got[feat].base, np.memmap):
                assert not got[feat].flags.writeable
        assert got["identifiers"] == chunk["identifiers"] == jax_ds.chunks[key]["identifiers"]
        assert got["sub"] == chunk["sub"]
    assert cache
    for path, arr in cache.items():
        assert path.endswith(".npy") and isinstance(arr, np.memmap)
        assert not arr.flags.writeable
    rewarm = _ingest(cache_root, io_workers, cache)
    for key, chunk in baseline.chunks.items():
        np.testing.assert_array_equal(rewarm.chunks[key]["eeg"], chunk["eeg"])


def test_create_eeg_indices_draws_from_the_given_rng(cache_root):
    """``rng=`` draws from that Generator and leaves the dataset's own
    alone, as in JAX."""
    tr, _va, _te, _teh, tra, *_ = get_train_val_test_files_final(
        cache_root, 0, "wav2vec_19", os.path.join(cache_root, "fold_split.json"), 1000)
    ds = EEGWindowDataset(tr, tra, WL, WL, batch_size=3, seed=0, io_workers=1, shuffle=True,
                          shuffle_percentage=0.5)
    jds = JDataset(tr, tra, WL, WL, batch_size=3, seed=0, io_workers=1, shuffle=True,
                   shuffle_percentage=0.5)
    eeg = ds.chunks[ds.batches_keys[0]]["eeg"]
    state = ds.rng.bit_generator.state
    got = ds.create_eeg_indices(eeg, rng=np.random.default_rng(7))
    want = jds.create_eeg_indices(eeg, rng=np.random.default_rng(7))
    assert ds.rng.bit_generator.state == state
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the host-memory helpers, and the reference checkpoint -------------------


def test_host_memory_helpers_match_jax():
    platform.trim_host_heap()
    assert platform.host_mem_total_gb() == j_platform.host_mem_total_gb() > 0
    rss = platform.host_rss_gb()
    assert 0 < rss < platform.host_mem_total_gb()
    assert abs(rss - j_platform.host_rss_gb()) < 0.5


def test_training_resumes_from_an_exported_reference_checkpoint(root, runs, tmp_path,
                                                                 monkeypatch, capsys):
    """A results dir whose ``checkpoints/`` holds only the reference's
    ``model.ckpt``, written by the ``torch_export`` CLI from the sequential
    run's fold 0: ``cli.main`` resumes from it (``loaded model from``), the
    weights and bank before the first step are fold 0's checkpoint bit for
    bit, and training goes on to write the port's own checkpoint."""
    fold0 = runs["no"]["summary"]["folds"]["0"]["results_dir"]
    saved = ckpt_lib.load_checkpoint(os.path.join(fold0, "checkpoints"))["model"]
    fold_cfg = TrainConfig.load(os.path.join(fold0, "args.txt"))
    template = str(tmp_path / "template.ckpt")
    torch.save(reference_layout(build_model_from_config(fold_cfg, fold_cfg.bank_size,
                                                        device="cpu", seed=9)), template)
    results = tmp_path / "res"
    cfg = TrainConfig(run=0)
    run_dir = results / cfg.results_dir_name("STAMP")
    (run_dir / "checkpoints").mkdir(parents=True)
    assert torch_export.main(["--run", fold0, "--template", template, "--out",
                              str(run_dir / "checkpoints" / "model.ckpt")]) == 0
    seen = {}
    real = ckpt_lib.restore_torch_checkpoint

    def restore(checkpoint_dir, model):
        out = real(checkpoint_dir, model)
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        return out

    monkeypatch.setattr(ckpt_lib, "restore_torch_checkpoint", restore)
    monkeypatch.setattr(cli.time, "strftime", lambda fmt: "STAMP")
    assert cli.main(["--run", "0", "--data_dir", root, "--results_folder", str(results),
                     "--skip_eval", "yes", *SMALL_FLAGS], device="cpu") == 0
    assert "loaded model from" in capsys.readouterr().out
    assert seen["state"].keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(seen["state"][k], v), k
    assert os.path.exists(ckpt_lib.checkpoint_path(str(run_dir / "checkpoints")))
    with open(run_dir / "loss.txt") as f:
        log = f.read()
    assert "loaded model from" in log and "epoch 0" in log
