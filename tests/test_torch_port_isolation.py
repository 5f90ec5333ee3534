"""Torch port, isolation: the port and its chip scripts import nothing of JAX,
of the JAX package or of ``transformers`` (the card's machine has none), and
nothing falls back to the CPU when the card is asked for and absent."""

import ast
import os
from pathlib import Path

import pytest
import torch

from transformer_clip_eeg_tpu_torch import _build
from transformer_clip_eeg_tpu_torch.serve import (
    InferenceSession,
    RetrievalIndex,
    build_model_from_config,
)
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "transformer_clip_eeg_tpu",
             "transformers")
SMALL = dict(window_length_s=1, fs=16, attention_depth=1, latent_dim=4,
             speech_dim_override=8)


def _port_files():
    files = sorted((REPO / "transformer_clip_eeg_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    bad = [name for name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_sees_the_port():
    names = {p.name for p in _port_files()}
    assert {"serve.py", "server.py", "fused_block.py", "lstm_scan.py",
            "convert.py", "chip_smoke.py", "dropout.py", "cli.py", "loop.py",
            "state.py", "checkpoint.py", "dataset.py", "fixtures.py",
            "fused_conv.py", "augment.py", "cv.py", "fold_parallel.py",
            "platform.py", "torch_import.py", "torch_export.py", "wav2vec2.py",
            "wav2vec.py", "baselines.py"} <= names


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model_from_config(TrainConfig(**SMALL), bank_size=4)
    model = build_model_from_config(TrainConfig(**SMALL), bank_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalIndex(8)


def test_fold_parallel_and_cv_default_to_the_card(tmp_path):
    """``FoldParallelTrainer`` and ``cv.main`` run on the card unless the
    caller passes ``device="cpu"``: without one they raise before reading any
    data."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is usable")
    from transformer_clip_eeg_tpu_torch import cv
    from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FoldParallelTrainer(TrainConfig(**SMALL), [0], [], [], str(tmp_path))
    assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.main(["--folds", "0", "--parallel", "yes", "--data_dir", str(tmp_path / "none"),
                 "--results_folder", str(tmp_path / "res")])


def test_wav2vec_extraction_defaults_to_the_card(tmp_path):
    """``preprocess/wav2vec.main`` runs on the card unless the caller passes
    ``device="cpu"``: without one it raises before reading the checkpoint or
    the tree."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is usable")
    from transformer_clip_eeg_tpu_torch.preprocess import wav2vec

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wav2vec.main(["--dataset_root", str(tmp_path), "--model_path",
                      str(tmp_path / "no_model")])
    assert not any(tmp_path.iterdir())


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not any(tmp_path.iterdir())


def test_kernel_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert _build.library_path().parent == _build.BUILD_DIR
    assert os.path.basename(first).startswith("libtce_kernels_")
