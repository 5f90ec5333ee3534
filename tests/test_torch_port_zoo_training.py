"""Torch port, the model zoo in training: one train step of each zoo
configuration (Z1-Z6, PERF.md §4) at a small width against the JAX step's
losses, gradients, memory bank and batch statistics (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.steps import _split_outputs as j_split_outputs
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.steps import train_step
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T, SP_D = 4, 32, 12
# the zoo configurations held on the card by chip_smoke.py (PERF.md §4)
ZOO = {
    "Z1": dict(eeg_encoder="conformer", speech_encoder="convLSTM", model_arch="clip_sim"),
    "Z2": dict(eeg_encoder="convLSTM", speech_encoder="smallConv", model_arch="clip_mp"),
    "Z3": dict(eeg_encoder="convLSTMnew", speech_encoder="convLSTM", model_arch="clip_kld"),
    "Z4": dict(eeg_encoder="lstm", speech_encoder="lstm", stimulus_features="mel",
               model_arch="no_contrastive_learning"),
    "Z5": dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
               model_arch="clip_kld_latent_proj"),
    "Z6": dict(eeg_encoder="vlaai", speech_encoder="Wav2vecSmallModel", model_arch="clip_sim"),
}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(z):
    kw = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4, lstm_units=8,
              lambda_sim_loss=0.5, **ZOO[z])
    if kw.get("stimulus_features") != "mel":
        kw["speech_dim_override"] = SP_D
    return kw


class _NoDropout(jl.Dropout):
    """JAX's flax Dropout as the identity: its masks cannot be drawn in torch,
    and the batch norms need ``deterministic=False``."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture
def jax_without_dropout(monkeypatch):
    for module in (je, ja, jh):
        monkeypatch.setattr(module, "Dropout", _NoDropout)


def _port_without_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        if isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0


class _CapturingOptimizer:
    """Stands in for the optimizer: keeps the step's gradients."""

    def __init__(self, params):
        self.params, self.step, self.grads = list(params), 0, None

    def apply(self, grads):
        self.grads, self.step = grads, self.step + 1


@pytest.mark.parametrize("z", sorted(ZOO))
def test_one_train_step_matches_the_jax_step(z, jax_without_dropout):
    """The port's ``train_step`` against the JAX train step's loss function
    (``deterministic=False``: batch norms on batch statistics, bank EMA),
    dropout off on both sides: every loss, every parameter's gradient within
    1e-4 x max(1, max |g|), and the bank and running statistics it leaves."""
    kw = _small(z)
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(11)
    eeg = rng.standard_normal((B, T, 64)).astype(np.float32)
    speech = (1.5 + rng.standard_normal((B, T, tcfg.speech_dimension))).astype(np.float32)
    ids = np.array([3, 1, 7, 12], np.int32)
    jmodel = j_build(jcfg, bank_size=16)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, eeg, speech, ids)))
    tmodel = build_model_from_config(tcfg, 16, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    _port_without_dropout(tmodel)

    frozen = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        outs, mutated = jmodel.apply(dict(frozen, params=params), eeg, speech, ids,
                                     deterministic=False, mutable=["membank", "batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(1),
                                           "sample": jax.random.PRNGKey(2)})
        losses = j_split_outputs(jcfg.model_arch, outs)
        return losses["loss_total"], (losses, mutated)

    jgrads, (jlosses, mutated) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    opt = _CapturingOptimizer(tmodel.parameters())
    batch = {"eeg": torch.from_numpy(eeg), "speech": torch.from_numpy(speech),
             "ids": torch.from_numpy(ids.astype(np.int64))}
    losses = train_step(tmodel, opt, batch, seed=3, warmup=False, model_arch=tcfg.model_arch)

    assert set(losses) == set(jlosses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    after = dict(variables, **jax.tree.map(np.asarray, dict(mutated)))
    want = state_dict_from_jax(dict(after, params=jax.tree.map(np.asarray, jgrads)), tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    assert len(names) == len(opt.grads) == len(jax.tree_util.tree_leaves(jgrads))
    for name, g in zip(names, opt.grads):
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(1.0, float(w.abs().max())), (name, err)
    buffers = dict(tmodel.named_buffers())
    assert set(buffers) == {k for k in want if k not in names}
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
    if "batch_stats" in variables:  # the step moved the statistics
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(variables["batch_stats"]),
            jax.tree_util.tree_leaves(after["batch_stats"])))
