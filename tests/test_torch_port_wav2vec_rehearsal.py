"""Torch port, the wav2vec2 extraction rehearsal
(``tools/wav2vec_rehearsal.py``) on the CPU at the ``W2V_SMOKE`` model: the
checkpoint directory it writes without ``transformers`` reads back to its
weights; a first pass stopped right after its first story's file, then
resumed, gives the files of an uninterrupted run byte for byte and extracts
exactly the missing stories; a write stopped midway, or between a story's
layers, leaves no file for the skip rule; the whole rehearsal at
``W2V_SMOKE``."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu_torch.models.wav2vec2 import (
    _fold_weight_norm,
    load_wav2vec2,
    read_hf_directory,
)
from transformer_clip_eeg_tpu_torch.preprocess import wav2vec
from transformer_clip_eeg_tpu_torch.tools import wav2vec_rehearsal as wr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER = 1
POS = "encoder.pos_conv_embed.conv."


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_model_dir_reads_back_to_its_weights(tmp_path, fmt):
    path = wr.build_model_dir(str(tmp_path / fmt), wr.SMOKE_CONFIG, seed=3, fmt=fmt)
    want_file = {"bin": "pytorch_model.bin", "safetensors": "model.safetensors"}[fmt]
    assert sorted(os.listdir(path)) == sorted(["config.json", want_file])
    config, sd = read_hf_directory(path)
    assert config == wr.SMOKE_CONFIG
    # the layout save_pretrained writes, rebuilt from the same seed
    ref_dir = wr.build_model_dir(str(tmp_path / "ref"), wr.SMOKE_CONFIG, seed=3, fmt="bin")
    raw = torch.load(os.path.join(ref_dir, "pytorch_model.bin"), weights_only=True)
    assert {k for k in raw if k.startswith("lm_head.")} == {"lm_head.weight", "lm_head.bias"}
    plain = {k[len("wav2vec2."):]: v for k, v in raw.items() if k.startswith("wav2vec2.")}
    g, v = plain.pop(POS + "weight_g"), plain.pop(POS + "weight_v")
    assert set(sd) == set(plain) | {POS + "weight"}
    for k, t in plain.items():
        assert torch.equal(sd[k], t), k
    assert torch.equal(sd[POS + "weight"], _fold_weight_norm(g, v))


def test_model_dir_is_kept_when_present(tmp_path):
    path = wr.build_model_dir(str(tmp_path / "m"), wr.SMOKE_CONFIG)
    stamp = os.path.getmtime(os.path.join(path, "pytorch_model.bin"))
    wr.build_model_dir(path, wr.SMOKE_CONFIG, seed=9)
    assert os.path.getmtime(os.path.join(path, "pytorch_model.bin")) == stamp


def _corpus(root):
    wr.build_stimuli(str(root), n_stories=3, story_min=0.1)
    return str(root)


def _features(root) -> dict:
    return {os.path.basename(p): open(p, "rb").read() for p in wr.feature_files(root, LAYER)}


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """The whole rehearsal at ``W2V_SMOKE``, its first pass ended after one
    story: ``(root, records by stage)``."""
    root = str(tmp_path_factory.mktemp("w2v_smoke"))
    env = dict(os.environ, W2V_SMOKE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m",
                           "transformer_clip_eeg_tpu_torch.tools.wav2vec_rehearsal",
                           "--root", root, "--device", "cpu", "--stop_after", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(root, "rehearsal.jsonl")) as f:
        return root, {r["stage"]: r for r in map(json.loads, f)}


def test_stopped_then_resumed_equals_an_uninterrupted_run(smoke_run, tmp_path):
    root, rec = smoke_run
    first, resume = rec["first_pass_cut"], rec["resume_to_completion"]
    assert first["stopped"] and not first["killed"]
    # the reference's order: stories in reverse sorted order; the pass ended
    # as its first file appeared, and left no temporary behind
    assert first["files"] == [f"rehearsal_story_002_-_wav2vec_{LAYER}.npy"]
    assert resume["rc"] == 0
    assert sorted(resume["saved"]) == [f"rehearsal_story_00{i}_-_wav2vec_{LAYER}.npy"
                                       for i in (0, 1)]
    assert resume["extracted_exactly_the_missing"]
    assert not [n for n in os.listdir(os.path.join(root, "derivatives", "preprocessed_stimuli"))
                if n.endswith(".partial")]
    whole = _corpus(tmp_path / "whole")
    full = wr.run_cli(whole, os.path.join(root, "hf_model"), device="cpu", layers=[LAYER])
    assert full["rc"] == 0 and len(full["saved"]) == 3
    assert _features(root) == _features(whole)


def test_a_stopped_write_leaves_no_file(tmp_path, monkeypatch):
    """A save stopped midway (half the array written) leaves neither the
    feature file nor its temporary, so the next run extracts the story."""
    model_dir = wr.build_model_dir(str(tmp_path / "model"), wr.SMOKE_CONFIG)
    root = _corpus(tmp_path / "c")
    extractor = wav2vec.Wav2Vec2FeatureExtractor(load_wav2vec2(model_dir, device="cpu"),
                                                 [LAYER])
    stim = os.path.join(root, "stimuli", "eeg")
    save = os.path.join(root, "derivatives", "preprocessed_stimuli")
    real_save = np.save

    def stopped_save(f, value):
        real_save(f, value[: len(value) // 2])
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "save", stopped_save)
    with pytest.raises(KeyboardInterrupt):
        wav2vec.extract_stimulus_features(extractor, stim, save)
    assert os.listdir(save) == []
    monkeypatch.undo()
    assert len(wav2vec.extract_stimulus_features(extractor, stim, save)) == 3


def test_a_story_stopped_between_its_layers_is_extracted_again(tmp_path, monkeypatch):
    """With two layers, a run stopped as soon as a story's first feature
    file lands leaves none of the first layer's, which the skip rule reads,
    so the resume extracts that story whole: every file equal, byte for
    byte, to an uninterrupted run's."""
    layers = [1, 2]
    model_dir = wr.build_model_dir(str(tmp_path / "model"), wr.SMOKE_CONFIG)
    extractor = wav2vec.Wav2Vec2FeatureExtractor(load_wav2vec2(model_dir, device="cpu"),
                                                 layers)
    dirs = {}
    for name in ("stopped", "whole"):
        root = _corpus(tmp_path / name)
        dirs[name] = (os.path.join(root, "stimuli", "eeg"),
                      os.path.join(root, "derivatives", "preprocessed_stimuli"))
    real = wav2vec._replaced_on_close
    landed = []

    @contextlib.contextmanager
    def stopped_after_one(path):
        with real(path) as f:
            yield f
        if "_-_wav2vec_" in os.path.basename(path):
            landed.append(os.path.basename(path))
            raise KeyboardInterrupt

    stim, save = dirs["stopped"]
    monkeypatch.setattr(wav2vec, "_replaced_on_close", stopped_after_one)
    with pytest.raises(KeyboardInterrupt):
        wav2vec.extract_stimulus_features(extractor, stim, save)
    monkeypatch.undo()
    story = "rehearsal_story_002"
    assert landed == [f"{story}_-_wav2vec_2.npy"]
    assert os.listdir(save) == landed
    resumed = wav2vec.extract_stimulus_features(extractor, stim, save)
    want = sorted(f"rehearsal_story_00{i}_-_wav2vec_{layer}.npy"
                  for i in range(3) for layer in layers)
    assert sorted(map(os.path.basename, resumed)) == want
    whole = wav2vec.extract_stimulus_features(extractor, *dirs["whole"])
    assert sorted(map(os.path.basename, whole)) == want
    assert sorted(os.listdir(save)) == want
    for name in want:
        assert (open(os.path.join(save, name), "rb").read()
                == open(os.path.join(dirs["whole"][1], name), "rb").read()), name


def test_whole_rehearsal_at_smoke(smoke_run):
    _, rec = smoke_run
    assert rec["gen"]["stories"] == 3 and rec["model_dir"]["files"] == [
        "config.json", "pytorch_model.bin"]
    assert len(rec["resume_to_completion"]["files"]) == 3
    assert rec["resume_to_completion"]["audio_s_per_s_incl_startup"] > 0
    assert 0 < rec["bf16_delta"]["rel_to_mean_abs"] < 0.05
    # the CPU launches no kernel of the port
    for stage in ("first_pass_cut", "resume_to_completion", "bf16_delta"):
        assert not any(rec[stage]["kernel_launches"].values())


def test_rehearsal_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wr.main(["--root", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
