"""Torch port, the model zoo's heads: each head's loss tuple against its
JAX twin on the same weights, batch and ids, in eval mode (dropout off) at
atol 1e-4, the memory bank's update, and the KLD heads in training mode
too (batch norms on batch statistics; the JAX head's unused posterior
sample is not drawn)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu_torch.models import encoders as te
from transformer_clip_eeg_tpu_torch.models import heads as th
from transformer_clip_eeg_tpu_torch.ops.layers import init_parameters
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 4, 32
ATOL = 1e-4
SP_D = 12
IDS = np.array([3, 1, 7, 12], np.int64)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(jmod, tmod, *inputs, rngs):
    """Initialise ``jmod`` on ``inputs``, carry the variables into ``tmod``,
    with running statistics worth testing (init leaves them 0 and 1)."""
    variables = jax.tree.map(np.asarray, dict(jmod.init(rngs, *map(jnp.asarray, inputs))))
    if "batch_stats" in variables:
        rng = np.random.default_rng(9)
        variables["batch_stats"] = jax.tree.map(
            lambda v: (np.abs(v + 0.5 * rng.standard_normal(v.shape)) + 0.1).astype(np.float32),
            variables["batch_stats"])
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    return variables


def _encoders(kind):
    """Small encoder pairs (JAX, port) whose flattened widths agree: 'conv'
    has dropout (compared in eval mode), 'bn' none but batch norms (so the
    training-mode forward is deterministic)."""
    if kind == "conv":
        return ((je.EEGLstm(spatial_filters=8, units_lstm=4, speech_dim=64),
                 je.SpeechSmallConv(4, 4, speech_dim=SP_D, time_dimension=T)),
                (te.EEGLstm(spatial_filters=8, units_lstm=4, speech_dim=64),
                 te.SpeechSmallConv(4, 4, speech_dim=SP_D, time_dimension=T)))
    return ((je.EEGLstm(spatial_filters=8, units_lstm=4, speech_dim=64),
             je.EEGLstm(spatial_filters=6, units_lstm=4, speech_dim=SP_D)),
            (te.EEGLstm(spatial_filters=8, units_lstm=4, speech_dim=64),
             te.EEGLstm(spatial_filters=6, units_lstm=4, speech_dim=SP_D)))


HEADS = {
    "CLIP": (jh.CLIP, th.CLIP, dict(temperature=0.3)),
    "CLIPSim": (jh.CLIPSim, th.CLIPSim, dict(bank_size=16, latent_dim=5, temperature=0.2,
                                             window_length=T, lambda_average=0.7)),
    "CLIPSimNoLatentProj": (jh.CLIPSimNoLatentProj, th.CLIPSimNoLatentProj,
                            dict(bank_size=16, latent_dim=4 * T, window_length=T,
                                 lambda_average=0.5)),
    "BaseMatchMismatch": (jh.BaseMatchMismatch, th.BaseMatchMismatch,
                          dict(window_length=T)),
    "CLIPNoContrastiveLearning": (jh.CLIPNoContrastiveLearning, th.CLIPNoContrastiveLearning,
                                  dict(window_length=T)),
    "CLIPSimMultiplePositives": (jh.CLIPSimMultiplePositives, th.CLIPSimMultiplePositives,
                                 dict(temperature=0.4, window_length=T, lambda_average=0.6)),
    "CLIPSimMultiplePositivesAdapted": (jh.CLIPSimMultiplePositivesAdapted,
                                        th.CLIPSimMultiplePositivesAdapted,
                                        dict(temperature=0.4, window_length=T,
                                             lambda_clip=0.8)),
    "CLIPKLDNoLatentProj": (jh.CLIPKLDNoLatentProj, th.CLIPKLDNoLatentProj,
                            dict(latent_dimension=4 * T, number_of_classes=16, window_length=T,
                                 lambda_lower_bound=0.3)),
    "CLIPKLDWithLatentProj": (jh.CLIPKLDWithLatentProj, th.CLIPKLDWithLatentProj,
                              dict(latent_dimension=6, number_of_classes=16, window_length=T,
                                   lambda_lower_bound=0.3)),
    "CLIPKLDWithLatentProj_non_linear": (jh.CLIPKLDWithLatentProj, th.CLIPKLDWithLatentProj,
                                         dict(latent_dimension=6, number_of_classes=16,
                                              window_length=T, lambda_lower_bound=0.3,
                                              projection_head="non-linear")),
}
KLD = ("CLIPKLDNoLatentProj", "CLIPKLDWithLatentProj")


def _head_pair(name, kind):
    jcls, tcls, kw = HEADS[name]
    (jeeg, jsp), (teeg, tsp) = _encoders(kind)
    rng = np.random.default_rng(2)
    eeg = rng.standard_normal((B, T, 64)).astype(np.float32)
    speech = rng.standard_normal((B, T, SP_D)).astype(np.float32)
    jmod, tmod = jcls(jeeg, jsp, **kw), tcls(teeg, tsp, **kw)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    variables = _carry(jmod, tmod, eeg, speech, IDS.astype(np.int32), rngs=keys)
    batch = [torch.from_numpy(a) for a in (eeg, speech, IDS)]
    return jmod, tmod, variables, (eeg, speech, IDS.astype(np.int32)), batch


def _flat(outs):
    return [float(np.asarray(v.detach() if isinstance(v, torch.Tensor) else v))
            for v in (outs if isinstance(outs, tuple) else (outs,))]


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_losses_match_jax_in_eval_mode(name):
    jmod, tmod, variables, jbatch, batch = _head_pair(name, "conv")
    mutable = [c for c in ("membank",) if c in variables]
    outs, mutated = jmod.apply(jax.tree.map(jnp.asarray, variables), *jbatch,
                               deterministic=True, mutable=mutable)
    with torch.no_grad():
        got = tmod.eval()(*batch)
    np.testing.assert_allclose(_flat(got), _flat(outs), atol=ATOL, rtol=1e-5)
    if mutable:
        np.testing.assert_allclose(tmod.eegMemoryBank.memory.numpy(),
                                   np.asarray(mutated["membank"]["eegMemoryBank"]["memory"]),
                                   atol=1e-6)


@pytest.mark.parametrize("name", KLD)
def test_kld_head_losses_match_jax_in_training_mode(name):
    """JAX draws a posterior sample it never uses; the port draws none, so the
    training-mode losses (batch norms on batch statistics) agree too."""
    jmod, tmod, variables, jbatch, batch = _head_pair(name, "bn")
    outs, mutated = jmod.apply(jax.tree.map(jnp.asarray, variables), *jbatch,
                               deterministic=False, mutable=["batch_stats"],
                               rngs={"sample": jax.random.PRNGKey(5),
                                     "dropout": jax.random.PRNGKey(6)})
    got = tmod.train()(*batch)
    np.testing.assert_allclose(_flat(got), _flat(outs), atol=ATOL, rtol=1e-5)
    stats = state_dict_from_jax(dict(variables, batch_stats=jax.tree.map(
        np.asarray, mutated["batch_stats"])), tmod)
    for key in stats:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(tmod.state_dict()[key].numpy(), stats[key].numpy(),
                                       atol=1e-6, err_msg=key)


def test_kld_lookup_is_seeded_standard_normal_and_draws_nothing_per_call():
    (_, _), (teeg, tsp) = _encoders("bn")
    head = th.CLIPKLDNoLatentProj(teeg, tsp, latent_dimension=4 * T, number_of_classes=500,
                                  window_length=T)
    init_parameters(head, torch.Generator().manual_seed(3))
    lookup = head.mu_eeg_lookup.detach()
    assert lookup.shape == (501, 64)
    assert abs(float(lookup.mean())) < 0.05 and abs(float(lookup.std()) - 1) < 0.05
    rng = np.random.default_rng(4)
    batch = (torch.from_numpy(rng.standard_normal((B, T, 64)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((B, T, SP_D)).astype(np.float32)),
             torch.from_numpy(IDS))
    with torch.no_grad():
        state = torch.get_rng_state()
        first = _flat(head.eval()(*batch))
        assert torch.equal(state, torch.get_rng_state())
        assert _flat(head(*batch)) == first
