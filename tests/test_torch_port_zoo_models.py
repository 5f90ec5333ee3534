"""Torch port, the model zoo's encoders and registry: every encoder and
VLAAI against its JAX twin on the same inputs and weights (moved by
utils/convert.py) in eval mode, atol 1e-4; every ``--eeg_encoder``,
``--speech_encoder`` and ``--model_arch`` of the JAX CLI builds with JAX's
leaf set and ``get_output_dim``, and a combination JAX cannot build fails
in the port too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu import cli as jcli
from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import vlaai as jv
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch.models import encoders as te
from transformer_clip_eeg_tpu_torch.models import heads as th
from transformer_clip_eeg_tpu_torch.models import vlaai as tv
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 4, 32
ATOL = 1e-4
SP_D = 12


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturbed_stats(variables, rng):
    """Running statistics worth testing (init leaves them 0 and 1)."""
    if "batch_stats" not in variables:
        return variables
    stats = jax.tree.map(
        lambda v: (np.abs(v + 0.5 * rng.standard_normal(v.shape)) + 0.1).astype(np.float32),
        variables["batch_stats"])
    return dict(variables, batch_stats=stats)


def _carry(jmod, tmod, *inputs, rngs=None):
    """Initialise ``jmod`` on ``inputs``, carry the variables into ``tmod``."""
    key = rngs or jax.random.PRNGKey(0)
    variables = jax.tree.map(np.asarray, dict(jmod.init(key, *map(jnp.asarray, inputs))))
    variables = _perturbed_stats(variables, np.random.default_rng(9))
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    return variables


# (name, JAX module, port module, input channels)
ENCODERS = {
    "EEGConformer": (lambda: je.EEGConformer(4, filters=(64,) * 2, kernels=(16,) * 2,
                                             time_dimension=T, depth=2),
                     lambda: te.EEGConformer(4, filters=(64,) * 2, kernels=(16,) * 2,
                                             time_dimension=T, depth=2), 64),
    "EEGConvLSTMNew": (lambda: je.EEGConvLSTMNew(8, filters=(64,) * 2, kernels=(16,) * 2,
                                                 time_dimension=T),
                       lambda: te.EEGConvLSTMNew(8, filters=(64,) * 2, kernels=(16,) * 2,
                                                 time_dimension=T), 64),
    "EEGModel": (lambda: je.EEGModel(units_lstm=8, activation="leaky_relu"),
                 lambda: te.EEGModel(units_lstm=8, activation="leaky_relu"), 64),
    "EEGExtended": (lambda: je.EEGExtended(units_lstm=8, activation="elu"),
                    lambda: te.EEGExtended(units_lstm=8, activation="elu"), 64),
    "EEGLstm": (lambda: je.EEGLstm(spatial_filters=8, units_lstm=8, speech_dim=SP_D),
                lambda: te.EEGLstm(spatial_filters=8, units_lstm=8, speech_dim=SP_D), SP_D),
    "MelModel": (lambda: je.MelModel(spatial_filters=8, units_lstm=8, activation="leaky_relu"),
                 lambda: te.MelModel(spatial_filters=8, units_lstm=8, activation="leaky_relu"),
                 28),
    "Wav2vecSmallModel": (lambda: je.Wav2vecSmallModel(spatial_filters=8, speech_dim=SP_D),
                          lambda: te.Wav2vecSmallModel(spatial_filters=8, speech_dim=SP_D),
                          SP_D),
    "SpeechSmallConv": (lambda: je.SpeechSmallConv(8, 16, speech_dim=SP_D, time_dimension=T),
                        lambda: te.SpeechSmallConv(8, 16, speech_dim=SP_D, time_dimension=T),
                        SP_D),
    "VLAAI": (lambda: jv.VLAAI(time_dimension=T), lambda: tv.VLAAI(time_dimension=T), 64),
    "VLAAI_3_blocks_no_skip": (lambda: jv.VLAAI(3, False, output_dim=16, time_dimension=T),
                               lambda: tv.VLAAI(3, False, output_dim=16, time_dimension=T), 64),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax_in_eval_mode(name):
    jfn, tfn, c = ENCODERS[name]
    jmod, tmod = jfn(), tfn()
    x = np.random.default_rng(1).standard_normal((B, T, c)).astype(np.float32)
    variables = _carry(jmod, tmod, x)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, *tmod.output_shape(T))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tmod.get_output_dim(T) == jmod.get_output_dim(T)


def test_wav2vec_small_model_keeps_the_reported_width_quirk():
    """It reports ``window * filters`` while its stride-3 conv emits a third of
    the window; the heads size themselves from the real shape."""
    enc = te.Wav2vecSmallModel(spatial_filters=128, speech_dim=1024)
    assert enc.get_output_dim(192) == 192 * 128
    assert enc.output_shape(192) == (64, 128)
    assert th.embedding_width(enc, 192) == 64 * 128


# -- the registry ---------------------------------------------------------------

SMALL = dict(window_length_s=1, fs=T, attention_depth=1, latent_dim=4, lstm_units=8)
EEG_CHOICES = jcli.build_arg_parser()._option_string_actions["--eeg_encoder"].choices
SPEECH_CHOICES = jcli.build_arg_parser()._option_string_actions["--speech_encoder"].choices
ARCH_CHOICES = jcli.build_arg_parser()._option_string_actions["--model_arch"].choices
JAX_REFUSES = ("conformer", "no")  # speech choices the JAX registry raises for


def _both_registries(**overrides):
    """The JAX model's variable leaves (zeros of ``jax.eval_shape``'s shapes:
    no compile) and the port's model for the same config."""
    kw = dict(SMALL, speech_dim_override=SP_D)
    kw.update(overrides)
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    jmodel = j_build(jcfg, bank_size=16)
    w = jcfg.window_length
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, w, 64)), jnp.zeros((1, w, tcfg.speech_dimension)),
        jnp.ones((1,), jnp.int32)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return jmodel, zeros, build_model_from_config(tcfg, 16, device="cpu", seed=0)


@pytest.mark.parametrize("kind,name", [("eeg", n) for n in EEG_CHOICES]
                         + [("speech", n) for n in SPEECH_CHOICES if n not in JAX_REFUSES]
                         + [("arch", n) for n in ARCH_CHOICES])
def test_registry_builds_every_cli_choice_with_jaxs_leaves(kind, name):
    """The converter's completeness check: every JAX leaf finds a port tensor
    of its shape and none is left over; the encoders report JAX's
    ``get_output_dim``; clip_sim takes any pair of encoders."""
    overrides = {"eeg": dict(eeg_encoder=name, model_arch="clip_sim"),
                 "speech": dict(speech_encoder=name, model_arch="clip_sim"),
                 "arch": dict(model_arch=name)}[kind]
    jmodel, zeros, tmodel = _both_registries(**overrides)
    sd = state_dict_from_jax(zeros, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(zeros))
    w = T
    assert tmodel.eegModel.get_output_dim(w) == jmodel.eegModel.get_output_dim(w)
    assert tmodel.speechModel.get_output_dim(w) == jmodel.speechModel.get_output_dim(w)


@pytest.mark.parametrize("eeg,speech,arch", [
    ("vlaai", "convLSTM", "clip_sim_no_latent_proj"),
    ("double_lstm", "Wav2vecSmallModel", "clip_mp"),
    ("lstm", "convLSTM", "no_contrastive_learning"),
    ("conformer", "double_lstm", "clip_kld"),
    ("double_lstm", "Wav2vecSmallModel", "clip_sim_no_latent_proj"),
], ids=["bank-width", "mp-widths", "bce-widths", "kld-widths", "wav2vec-quirk-bank"])
def test_a_combination_jax_cannot_build_fails_in_the_port_at_construction(eeg, speech, arch):
    """Where JAX's init fails (an InfoNCE or a bank row between embeddings of
    two widths), the port's construction raises a ValueError naming both."""
    with pytest.raises(Exception):
        _both_registries(eeg_encoder=eeg, speech_encoder=speech, model_arch=arch)
    kw = dict(SMALL, speech_dim_override=SP_D, eeg_encoder=eeg, speech_encoder=speech,
              model_arch=arch)
    with pytest.raises(ValueError, match="width"):
        build_model_from_config(TrainConfig(**kw), 16, device="cpu")
