"""Torch port, the wav2vec2 extraction (``preprocess/wav2vec.py``) against the
JAX package's on the CPU: the chunked extraction at several lengths (the
reference's duplicated tail included) on a tiny model (JAX
``tests/test_wav2vec_extraction.py``'s, scaled to SR=160) with the same
weights on both sides, within JAX's model limits (atol 2e-4, rtol 1e-3);
``max_chunk_batch`` slicing; the main loop's files and values against JAX's
``main`` on one HF checkpoint directory (a 16 kHz model with XLSR-53's
strides at narrow widths); the resampler and ``load_audio`` against JAX's;
the bf16 forward at JAX's own limit; the flags without effect, and the shard
flags raising."""

import gzip
import os

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Config as JConfig
from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Model as JModel
from transformer_clip_eeg_tpu.models.wav2vec2 import convert_hf_wav2vec2 as j_convert
from transformer_clip_eeg_tpu.preprocess import wav2vec as jw
from transformer_clip_eeg_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    convert_hf_wav2vec2,
)
from transformer_clip_eeg_tpu_torch.preprocess import wav2vec as w

transformers = pytest.importorskip("transformers")

SR = 160  # a scaled-down "16 kHz": the tiny model's strides (5, 2, 2) make 8 frames/s
FRAMES_PER_S = 8
ATOL, RTOL = 2e-4, 1e-3  # JAX tests/test_wav2vec2.py:60
BF16_LIMIT = 0.05  # mean |bf16 - f32| / mean |f32|, JAX tests/test_wav2vec_extraction.py:245


def _hf(seed, **kw):
    base = dict(hidden_size=24, num_hidden_layers=3, num_attention_heads=4,
                intermediate_size=48, conv_dim=(12, 12, 12), conv_stride=(5, 2, 2),
                conv_kernel=(10, 3, 3), conv_bias=True, feat_extract_norm="layer",
                do_stable_layer_norm=True, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
                apply_spec_augment=False)
    torch.manual_seed(seed)
    return transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(**{**base, **kw})).eval()


@pytest.fixture(scope="module")
def tiny():
    hf = _hf(1)
    jmodel = JModel(JConfig.from_hf(hf.config))
    variables = j_convert(hf)
    port = Wav2Vec2Model(Wav2Vec2Config.from_hf(hf.config))
    port.load_state_dict(convert_hf_wav2vec2(hf))
    return jmodel, variables, port.eval()


def _extractors(tiny, layers, **kw):
    jmodel, variables, port = tiny
    return (jw.Wav2Vec2FeatureExtractor(jmodel, variables, layers, sr=SR,
                                        frames_per_s=FRAMES_PER_S, **kw),
            w.Wav2Vec2FeatureExtractor(port, layers, sr=SR, frames_per_s=FRAMES_PER_S, **kw))


@pytest.mark.parametrize("n_samples", [SR * 7 + 37, int(SR * 6.2), SR * 6 + 3, SR * 8,
                                       SR + 5], ids=["ragged", "quirk", "quirk_short",
                                                     "even", "one_tail"])
def test_chunked_extraction_matches_jax(tiny, n_samples):
    """Lengths whose remainder after whole segments lies in the overlap
    window append the reference's further tail chunks: the same frames on
    both sides."""
    audio = np.random.default_rng(0).standard_normal(n_samples).astype(np.float32)
    j_ext, ext = _extractors(tiny, (1, 3))
    want = j_ext.get_hidden_output(audio, overlap=2, segment_length=2)
    got = ext.get_hidden_output(audio, overlap=2, segment_length=2)
    for layer in (1, 3):
        assert got[layer].dtype == np.float32 and got[layer].shape == want[layer].shape
        np.testing.assert_allclose(got[layer], want[layer], atol=ATOL, rtol=RTOL)


def test_max_chunk_batch_slicing_exact(tiny):
    """A 10-chunk story in padded slabs of 4 equals the unbounded batch
    (JAX's test and limit)."""
    audio = np.random.default_rng(3).standard_normal(SR * 21 + 17).astype(np.float32)
    _, port = tiny[0], tiny[2]
    outs = [w.Wav2Vec2FeatureExtractor(port, (1, 3), sr=SR, frames_per_s=FRAMES_PER_S,
                                       max_chunk_batch=mb).get_hidden_output(
        audio, overlap=2, segment_length=2) for mb in (None, 4)]
    for layer in (1, 3):
        assert outs[1][layer].shape == outs[0][layer].shape
        np.testing.assert_allclose(outs[1][layer], outs[0][layer], atol=1e-6)


def test_bf16_forward_within_jax_limit(tiny):
    """``dtype=bfloat16``: float32 features, the mean error against the f32
    path under 5% of its mean magnitude."""
    _, _, port = tiny
    bf16 = Wav2Vec2Model(port.config, dtype=torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    audio = np.random.default_rng(5).standard_normal(SR * 7).astype(np.float32) * 0.1
    f32_out = w.Wav2Vec2FeatureExtractor(port, [2], sr=SR, frames_per_s=FRAMES_PER_S
                                         ).get_hidden_output(audio, 2, 4)[2]
    bf16_out = w.Wav2Vec2FeatureExtractor(bf16.eval(), [2], sr=SR, frames_per_s=FRAMES_PER_S
                                          ).get_hidden_output(audio, 2, 4)[2]
    assert bf16_out.dtype == np.float32 and bf16_out.shape == f32_out.shape
    err = np.abs(bf16_out - f32_out).mean() / np.abs(f32_out).mean()
    assert 0 < err < BF16_LIMIT, err


@pytest.mark.parametrize("sr_out,sr_in", [(16000, 48000), (16000, 44100), (16000, 16000),
                                          (48000, 16000)])
def test_resampler_equals_jax(sr_out, sr_in):
    x = np.random.default_rng(7).standard_normal(sr_in // 4).astype(np.float32)
    np.testing.assert_array_equal(w.kaiser_best_resample(x, sr_out, sr_in),
                                  jw.kaiser_best_resample(x, sr_out, sr_in))


def test_load_audio_equals_jax(tmp_path):
    """``.wav`` (int16 stereo at 32 kHz) and ``.npz`` (48 kHz) ingest."""
    from scipy.io import wavfile

    rng = np.random.default_rng(8)
    pcm = (rng.uniform(-0.5, 0.5, (32000, 2)) * 32767).astype(np.int16)
    wavfile.write(tmp_path / "tone.wav", 32000, pcm)
    np.savez(tmp_path / "story.npz", audio=rng.standard_normal(48000).astype(np.float32),
             fs=48000)
    for name in ("tone.wav", "story.npz"):
        got = w.load_audio(str(tmp_path / name))
        np.testing.assert_array_equal(got, jw.load_audio(str(tmp_path / name)))
        assert got.dtype == np.float32 and got.shape == (16000,)


# -- the main loop, both packages' CLIs on one HF checkpoint directory ---------

def _tree(root, tmp, rng):
    """Two stories at 48 kHz (one whose length leaves the duplicated tail),
    a ``noise_`` and a ``t_`` file that the loop skips."""
    stim = os.path.join(root, "stimuli", "eeg")
    os.makedirs(stim)
    for name, seconds in (("audiobook_1", 17.3), ("audiobook_2", 16.5),
                          ("noise_audiobook_1", 3.0), ("t_audiobook_1", 3.0)):
        raw = os.path.join(tmp, f"{name}.npz")
        np.savez(raw, audio=(0.1 * rng.standard_normal(int(48000 * seconds))).astype(
            np.float32), fs=48000)
        with open(raw, "rb") as f_in, gzip.open(os.path.join(stim, f"{name}.npz.gz"),
                                                "wb") as f_out:
            f_out.write(f_in.read())


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A 16 kHz model: XLSR-53's strides and kernels (50 frames/s) at narrow
    widths, saved as ``save_pretrained`` writes it."""
    d = str(tmp_path_factory.mktemp("hf_model"))
    _hf(4, hidden_size=16, intermediate_size=32, num_hidden_layers=2, conv_dim=(8,) * 7,
        conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_kernel=(10, 3, 3, 3, 3, 3, 2),
        vocab_size=5).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def mains(hf_dir, tmp_path_factory):
    """JAX's ``main`` and the port's on copies of one tree, ``--layers 1 2``."""
    out = {}
    for name in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"w2v_{name}"))
        _tree(root, str(tmp_path_factory.mktemp(f"raw_{name}")), np.random.default_rng(9))
        argv = ["--dataset_root", root, "--model_path", hf_dir, "--layers", "1", "2"]
        assert (jw.main(argv) if name == "jax" else w.main(argv, device="cpu")) == 0
        out[name] = (root, argv)
    return out


def _saved(root):
    d = os.path.join(root, "derivatives", "preprocessed_stimuli")
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_main_matches_jax(mains, capsys):
    """The same files (2 stories x 2 layers, noise_/t_ skipped), the same
    shapes ``[round(frames * 64 / 50), 16]``, values within the model's
    limits; a second run writes nothing."""
    want, got = _saved(mains["jax"][0]), _saved(mains["port"][0])
    assert list(got) == list(want) == [f"audiobook_{s}_-_wav2vec_{layer}.npy"
                                       for s in (1, 2) for layer in (1, 2)]
    for name in want:
        assert got[name].shape == want[name].shape and got[name].shape[1] == 16
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=RTOL, err_msg=name)
    capsys.readouterr()
    root, argv = mains["port"]
    before = {n: os.path.getmtime(os.path.join(root, "derivatives", "preprocessed_stimuli", n))
              for n in got}
    assert w.main(argv, device="cpu") == 0
    assert "Saved to" not in capsys.readouterr().out
    assert before == {n: os.path.getmtime(os.path.join(root, "derivatives",
                                                       "preprocessed_stimuli", n))
                      for n in got}


def test_flags_without_effect_and_shard_flags(mains, hf_dir, tmp_path):
    """``--split_programs`` / ``--scan_layers`` change nothing, bit for bit
    (they shape JAX's XLA programs); the shard flags (ported:
    ``tests/test_torch_port_wav2vec2_tp.py``) raise JAX's ``ValueError`` for
    a degree that does not divide the heads, and ``--n_data_shards 0`` raises
    one naming both flags when the devices over ``--n_model_shards`` are
    none (one host), before any rank starts."""
    root = str(tmp_path / "tree")
    _tree(root, str(tmp_path), np.random.default_rng(9))
    assert w.main(["--dataset_root", root, "--model_path", hf_dir, "--layers", "1", "2",
                   "--split_programs", "yes", "--scan_layers", "no"],
                  device="cpu") == 0
    want, got = _saved(mains["port"][0]), _saved(root)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for flags, match in ((["--n_model_shards", "3"],
                          "TP degree 3 must divide num_attention_heads 4"),
                         (["--n_model_shards", "2"],
                          "--n_data_shards 0 takes the devices over --n_model_shards 2")):
        with pytest.raises(ValueError, match=match):
            w.main(["--dataset_root", root, "--model_path", hf_dir, *flags], device="cpu")
