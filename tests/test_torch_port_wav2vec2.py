"""Torch port, the wav2vec2 encoder (``models/wav2vec2.py``) on the CPU: a
small HF config (as JAX ``tests/test_wav2vec_extraction.py:30``) with random
weights, the port against HF's ``Wav2Vec2Model`` (``transformers``, the
oracle here only) and against the JAX package's model on the same weights at
every tap 0..n, within JAX's limits (``tests/test_wav2vec2.py:60``: atol
2e-4, rtol 1e-3); ``num_output_frames``; both weight-norm spellings of the
positional conv; the HF directory reader on ``save_pretrained`` with
``safe_serialization`` True and False against HF's own load."""

import json

import jax
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Config as JConfig
from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Model as JModel
from transformer_clip_eeg_tpu.models.wav2vec2 import convert_hf_wav2vec2 as j_convert
from transformer_clip_eeg_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    convert_hf_wav2vec2,
    load_wav2vec2,
    read_hf_directory,
    read_safetensors,
    wav2vec2_state_dict_from_jax,
)

transformers = pytest.importorskip("transformers")

ATOL, RTOL = 2e-4, 1e-3  # JAX tests/test_wav2vec2.py:60


def _hf_config(**kw):
    return transformers.Wav2Vec2Config(
        hidden_size=24, num_hidden_layers=3, num_attention_heads=4, intermediate_size=48,
        conv_dim=(12, 12, 12), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3), conv_bias=True,
        feat_extract_norm="layer", do_stable_layer_norm=True, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False, **kw)


@pytest.fixture(scope="module")
def hf():
    torch.manual_seed(1)
    model = transformers.Wav2Vec2Model(_hf_config()).eval()
    with torch.no_grad():  # nonzero biases and norms, so every term shows
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def port(hf):
    model = Wav2Vec2Model(Wav2Vec2Config.from_hf(hf.config))
    model.load_state_dict(convert_hf_wav2vec2(hf))
    return model.eval()


def test_config_from_hf_object_and_dict(hf):
    cfg = Wav2Vec2Config.from_hf(hf.config)
    assert cfg == Wav2Vec2Config.from_hf(hf.config.to_dict())
    assert dict(vars(JConfig.from_hf(hf.config))) == dict(vars(cfg))
    assert Wav2Vec2Config() == Wav2Vec2Config.from_hf(transformers.Wav2Vec2Config(
        **{k: v for k, v in Wav2Vec2Config().to_hf_dict().items()
           if k not in ("model_type", "architectures")}))
    with pytest.raises(ValueError, match="feat_extract_norm"):
        Wav2Vec2Config.from_hf(dict(hf.config.to_dict(), feat_extract_norm="group"))


def test_every_tap_matches_hf_and_jax(hf, port):
    """HF's ``hidden_states[i]``, JAX's ``tap_layer=i`` on ``convert_hf_wav2vec2``
    of the same model, and the port (one pass for all taps and one per
    tap), for i = 0..n."""
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 800)).astype(np.float32)
    with torch.no_grad():
        hs = hf(torch.from_numpy(audio), output_hidden_states=True).hidden_states
        n = hf.config.num_hidden_layers
        together = port.hidden_states(torch.from_numpy(audio), range(n + 1))
    jmodel = JModel(JConfig.from_hf(hf.config))
    variables = j_convert(hf)
    for tap in range(n + 1):
        ref = hs[tap].numpy()
        jax_out = np.asarray(jmodel.apply(variables, audio, tap_layer=tap))
        with torch.no_grad():
            alone = port(torch.from_numpy(audio), tap_layer=tap).numpy()
        assert alone.dtype == np.float32 and alone.shape == ref.shape
        np.testing.assert_array_equal(together[tap].numpy(), alone)
        np.testing.assert_allclose(alone, ref, atol=ATOL, rtol=RTOL, err_msg=f"tap {tap}")
        np.testing.assert_allclose(alone, jax_out, atol=ATOL, rtol=RTOL, err_msg=f"tap {tap}")
    with torch.no_grad():
        last = port(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(last, hf(torch.from_numpy(audio)).last_hidden_state.detach(),
                               atol=ATOL, rtol=RTOL)


def test_jax_variables_carry_across(hf, port):
    """``wav2vec2_state_dict_from_jax`` of JAX's converted tree equals the
    port's own conversion of the HF model (the fold computed once each
    side, 1e-7)."""
    carried = wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, j_convert(hf)))
    mine = convert_hf_wav2vec2(hf)
    assert carried.keys() == mine.keys() == port.state_dict().keys()
    for k in mine:
        np.testing.assert_allclose(carried[k].numpy(), mine[k].numpy(), atol=1e-7, err_msg=k)


def test_num_output_frames(port):
    for n in (400, 640, 800, 1601):
        with torch.no_grad():
            out = port(torch.zeros(1, n), tap_layer=0)
        assert out.shape[1] == port.num_output_frames(n) == JModel(
            JConfig.from_hf(_hf_config())).num_output_frames(n)


def test_both_weight_norm_spellings(hf, port):
    """``parametrizations.weight.original0/1`` (today's transformers) and the
    older ``weight_g``/``weight_v`` fold to the same weight, and the
    ``wav2vec2.`` prefix, ``lm_head.*`` and ``masked_spec_embed`` go."""
    sd = hf.state_dict()
    key = "encoder.pos_conv_embed.conv.parametrizations.weight.original"
    assert key + "0" in sd and "masked_spec_embed" in sd
    old = {("wav2vec2." + k).replace("parametrizations.weight.original0", "weight_g")
           .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}
    old["lm_head.weight"] = torch.zeros(5, 24)
    a, b = convert_hf_wav2vec2(sd), convert_hf_wav2vec2(old)
    assert a.keys() == b.keys() == port.state_dict().keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    w = hf.encoder.pos_conv_embed.conv.weight.detach()  # HF's own fold
    np.testing.assert_allclose(a["encoder.pos_conv_embed.conv.weight"], w, atol=1e-6)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_hf_directory_reader(tmp_path, safe):
    """``save_pretrained`` of a ``Wav2Vec2ForCTC`` read by the port (no
    ``transformers``) against HF's own ``from_pretrained``: the same config,
    every tensor equal, the same features."""
    torch.manual_seed(2)
    hf = transformers.Wav2Vec2ForCTC(_hf_config(vocab_size=7)).eval()
    hf.save_pretrained(tmp_path, safe_serialization=safe)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    config, sd = read_hf_directory(str(tmp_path))
    back = transformers.Wav2Vec2ForCTC.from_pretrained(tmp_path).eval()
    assert config == Wav2Vec2Config.from_hf(back.config)
    want = convert_hf_wav2vec2(back)
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    if safe:
        raw = read_safetensors(str(tmp_path / "model.safetensors"))
        assert raw.keys() == back.state_dict().keys()
        for k, v in back.state_dict().items():
            assert torch.equal(raw[k], v), k
    model = load_wav2vec2(str(tmp_path), device="cpu")
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 700)).astype(
        np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(audio).numpy(),
                                   back.wav2vec2(audio).last_hidden_state.numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_safetensors_half_precision(tmp_path):
    """F16 and BF16 buffers, and an empty tensor, as the format lays them out."""
    tensors = {"a": torch.arange(6, dtype=torch.float16).reshape(2, 3),
               "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
               "c": torch.zeros(0, 4)}
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": {torch.float16: "F16", torch.bfloat16: "BF16",
                                  torch.float32: "F32"}[t.dtype],
                        "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    path = tmp_path / "x.safetensors"
    path.write_bytes(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    got = read_safetensors(str(path))
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
