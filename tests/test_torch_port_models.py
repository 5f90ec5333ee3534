"""Torch port, models and weight conversion: the flagship's encoders and the
whole model's embeddings against the JAX package (deterministic), atol 1e-4,
and the converter's completeness checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import registry as j_registry
from transformer_clip_eeg_tpu.models.heads import (
    flatten_maybe_transposed as j_flatten_maybe_transposed,
)
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch.models import encoders as te
from transformer_clip_eeg_tpu_torch.models.heads import flatten_maybe_transposed
from transformer_clip_eeg_tpu_torch.models import registry
from transformer_clip_eeg_tpu_torch.serve import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T, SP_D = 2, 32, 32
ATOL = 1e-4
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4,
             speech_dim_override=SP_D)


def _init(jmod, x):
    return jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))))


def _compare(jmod, tmod, x):
    variables = _init(jmod, x)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), True))
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_eeg_conformer_interleaved_matches_jax():
    x = np.random.default_rng(0).standard_normal((B, T, 64)).astype(np.float32)
    kw = dict(output_dim=4, dropout_rate=0.2, filters=(64,), kernels=(64,),
              time_dimension=T, depth=2)
    _compare(je.EEGConformerInterleaved(**kw), te.EEGConformerInterleaved(**kw), x)


@pytest.mark.parametrize("n_conv", [1, 2])
def test_eeg_conv_lstm_matches_jax(n_conv):
    x = np.random.default_rng(1).standard_normal((B, T, SP_D)).astype(np.float32)
    kw = dict(units_lstm=16, output_dim=8, dropout_rate=0.4, eeg_dim=SP_D,
              filters=(64,) * n_conv, kernels=(32,) * n_conv, time_dimension=T)
    _compare(je.EEGConvLSTM(**kw), te.EEGConvLSTM(**kw), x)


def test_basic_block_matches_jax():
    x = np.random.default_rng(2).standard_normal((B, T, 64)).astype(np.float32)
    _compare(je.BasicBlock(64, 32, time_dimension=T),
             te.BasicBlock(64, 64, 32, time_dimension=T), x)


@pytest.fixture(scope="module")
def flagship_small():
    """The flagship model at a small size in both packages, same weights."""
    jmodel = j_build(JConfig(**SMALL), bank_size=16)
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((B, T, 64)).astype(np.float32)
    speech = rng.standard_normal((B, T, SP_D)).astype(np.float32)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), eeg, speech, np.arange(1, B + 1, dtype=np.int32)
    )))
    tmodel = build_model_from_config(TrainConfig(**SMALL), 16, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    return jmodel, variables, tmodel, eeg, speech


@pytest.mark.parametrize("method", ["encode_eeg", "encode_speech"])
def test_whole_model_encoders_match_jax(flagship_small, method):
    jmodel, variables, tmodel, eeg, speech = flagship_small
    x = eeg if method == "encode_eeg" else speech
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=getattr(jmodel, method)))
    with torch.no_grad():
        got = getattr(tmodel, method)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, T, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_state_dict_carries_every_leaf(flagship_small):
    _, variables, tmodel, _, _ = flagship_small
    sd = state_dict_from_jax(variables, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_jax
    np.testing.assert_array_equal(
        sd["eegModel.conformer_1.block_0.attn.queries.weight"].numpy(),
        variables["params"]["eegModel"]["conformer_1"]["block_0"]["attn"]["queries"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["speechModel.speech_lstm1.weight_hh_l0_reverse"].numpy(),
        variables["params"]["speechModel"]["speech_lstm1"]["kernel_hh_reverse"].T,
    )
    np.testing.assert_array_equal(
        sd["eegModel.conv_0.conv.weight"].numpy(),
        variables["params"]["eegModel"]["conv_0"]["conv"]["kernel"].transpose(2, 1, 0),
    )
    np.testing.assert_array_equal(sd["eegMemoryBank.memory"].numpy(),
                                  variables["membank"]["eegMemoryBank"]["memory"])


def test_state_dict_raises_on_unused_missing_or_misshapen(flagship_small):
    _, variables, tmodel, _, _ = flagship_small
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((2, 2))}),
             "membank": variables["membank"]}
    with pytest.raises(ValueError, match="stray"):
        state_dict_from_jax(extra, tmodel)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "temperature_eeg"},
               "membank": variables["membank"]}
    with pytest.raises(ValueError, match="temperature_eeg"):
        state_dict_from_jax(missing, tmodel)
    bad = {"params": dict(variables["params"], temperature=np.zeros(3, np.float32)),
           "membank": variables["membank"]}
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(bad, tmodel)


def test_seeded_init_is_reproducible_and_torch_default():
    a = build_model_from_config(TrainConfig(**SMALL), 16, device="cpu", seed=5)
    b = build_model_from_config(TrainConfig(**SMALL), 16, device="cpu", seed=5)
    c = build_model_from_config(TrainConfig(**SMALL), 16, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["eegModel.final_layer.weight"], sc["eegModel.final_layer.weight"])
    w = sa["eegModel.conv_0.conv.weight"]  # fan_in 64 * 64
    assert float(w.abs().max()) <= 1 / 64
    mem = sa["eegMemoryBank.memory"]
    assert mem.shape == (17, T * 4) and 0 <= float(mem.min()) and float(mem.max()) <= 1
    assert float(sa["temperature"]) == pytest.approx(0.075)
    assert not a.training


@pytest.mark.parametrize("shape", [(2, 32, 4), (2, 4, 32)])
def test_flatten_maybe_transposed_matches_jax(shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_flatten_maybe_transposed(jnp.asarray(x)))
    np.testing.assert_array_equal(flatten_maybe_transposed(torch.from_numpy(x)).numpy(), want)


def _registry_call(registry, kind, name):
    """Ask ``registry`` (JAX's or the port's) for ``name`` of ``kind``."""
    if kind == "eeg":
        return registry.load_eeg_encoder(name, 128, 128, 1, T, 4, 1)
    if kind == "speech":
        return registry.load_speech_encoder(name, 128, 128, 1, T, 3, SP_D, 4)
    eeg = registry.load_eeg_encoder("EEGConformerInterleaved", 128, 128, 1, T, 4, 1)
    speech = registry.load_speech_encoder("convLSTM", 128, 128, 1, T, 3, SP_D, 4)
    return registry.build_model(name, eeg, speech, window_length=T, temperature=1.0,
                                latent_dim=4, bank_size=8)


@pytest.mark.parametrize("kind,name", [("eeg", "eegnet"), ("speech", "conformer"),
                                       ("speech", "no"), ("speech", "melnet"),
                                       ("arch", "clip_unknown")])
def test_registry_refuses_what_the_jax_registry_refuses(kind, name):
    """Unknown names, and the speech choices 'conformer' and 'no' that the
    JAX CLI offers but its registry refuses, raise JAX's ValueError."""
    with pytest.raises(ValueError) as theirs:
        _registry_call(j_registry, kind, name)
    with pytest.raises(ValueError) as mine:
        _registry_call(registry, kind, name)
    assert str(mine.value) == str(theirs.value)


def test_train_config_round_trips_with_the_jax_copy(tmp_path):
    """args.txt written by either package loads field for field in the other."""
    jcfg = JConfig(**SMALL, bank_size=21)
    jcfg.save(str(tmp_path / "jax_args.txt"))
    tcfg = TrainConfig.load(str(tmp_path / "jax_args.txt"))
    assert tcfg.to_dict() == jcfg.to_dict()
    assert (tcfg.window_length, tcfg.speech_dimension) == (T, SP_D)
    tcfg.save(str(tmp_path / "torch_args.txt"))
    assert JConfig.load(str(tmp_path / "torch_args.txt")).to_dict() == jcfg.to_dict()
    assert TrainConfig().to_dict() == JConfig().to_dict()
