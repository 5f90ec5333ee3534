"""Torch port, the model zoo's layers and losses: BatchNorm1d (eval and
training, with its running statistics), Conv2dValidTime, the strided and
valid Conv1d, the activations and every loss function of models/heads.py
against their JAX twins on the same inputs and weights, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu_torch.models import heads as th
from transformer_clip_eeg_tpu_torch.ops import layers as tl
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 3, 32
ATOL = 1e-4


def _x(shape, seed, loc=0.0, scale=1.0):
    return (loc + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _batchnorm_pair(c, rng):
    """A JAX BatchNorm1d's variables with perturbed affine and statistics,
    and the port's layer holding them."""
    jmod = jl.BatchNorm1d()
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 2, c)))))
    perturb = lambda v, s: (v + s * rng.standard_normal(v.shape)).astype(np.float32)  # noqa: E731
    variables = {
        "params": {"scale": perturb(variables["params"]["scale"], 0.3),
                   "bias": perturb(variables["params"]["bias"], 0.3)},
        "batch_stats": {"mean": perturb(variables["batch_stats"]["mean"], 0.5),
                        "var": np.abs(perturb(variables["batch_stats"]["var"], 0.5)) + 0.1},
    }
    tmod = tl.BatchNorm1d(c)
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    return jmod, variables, tmod


def test_batchnorm_eval_uses_the_running_statistics():
    rng = np.random.default_rng(0)
    jmod, variables, tmod = _batchnorm_pair(7, rng)
    x = _x((B, T, 7), 1, loc=2.0, scale=3.0)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), use_running_average=True))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_batchnorm_training_matches_the_mutated_batch_stats():
    """Training mode normalises with the biased batch variance and moves the
    running statistics (unbiased variance, momentum 0.1) as JAX's mutated
    ``batch_stats``; the gradient flows through the batch statistics."""
    rng = np.random.default_rng(2)
    jmod, variables, tmod = _batchnorm_pair(5, rng)
    x = _x((B, T, 5), 3, loc=-1.0, scale=2.0)
    want, mutated = jmod.apply(variables, jnp.asarray(x), use_running_average=False,
                               mutable=["batch_stats"])
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod.train()(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), atol=1e-6)
    g = _x((B, T, 5), 4)
    jgrad = jax.grad(lambda v: jnp.sum(jmod.apply(
        variables, v, use_running_average=False, mutable=["batch_stats"])[0] * g))(
        jnp.asarray(x))
    (tgrad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=ATOL)
    assert set(tmod.state_dict()) == {"weight", "bias", "running_mean", "running_var"}


@pytest.mark.parametrize("filters,k,stride", [(16, 9, 3), (4, 5, 1), (3, 4, 2)])
def test_conv2d_valid_time_matches_jax(filters, k, stride):
    x = _x((B, T, 6), 5)
    jmod = jl.Conv2dValidTime(filters, k, stride)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = tl.Conv2dValidTime(filters, k, stride)
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    t_out = tl.Conv2dValidTime.output_length(T, k, stride)
    assert got.shape == want.shape == (B, t_out, filters * 6)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k,stride,padding", [(3, 3, "valid"), (5, 2, "valid"),
                                              (4, 2, "same"), (1, 1, "valid")])
def test_conv1d_stride_and_valid_padding_match_jax(k, stride, padding):
    x = _x((B, T, 10), 6)
    jmod = jl.Conv1d(7, k, stride=stride, padding=padding)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = tl.Conv1d(10, 7, k, stride=stride, padding=padding)
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv1d_refuses_an_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        tl.Conv1d(4, 4, 3, padding="causal")


@pytest.mark.parametrize("name", sorted(jl.ACTIVATIONS))
def test_activations_match_jax(name):
    assert set(tl.ACTIVATIONS) == set(jl.ACTIVATIONS)
    x = _x((4, 9), 7, scale=3.0)
    np.testing.assert_allclose(tl.ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
                               np.asarray(jl.ACTIVATIONS[name](jnp.asarray(x))), atol=1e-6)


def _loss_cases():
    """Each loss function with arguments made from a seed: numpy arrays for
    both packages, integer targets as int64 for the port."""
    rng = np.random.default_rng(8)
    n = 5
    logits = (3 * rng.standard_normal((n, n))).astype(np.float32)
    probs = rng.dirichlet(np.ones(n), size=n).astype(np.float32)
    binary = rng.integers(0, 2, (2, n)).astype(np.float32)
    targets = rng.permutation(n)
    mp = rng.standard_normal((n, 3, n)).astype(np.float32)
    logp = np.log(probs)
    mu, logvar = (rng.standard_normal((n, 4)).astype(np.float32) for _ in range(2))
    mu2 = rng.standard_normal((n, 4)).astype(np.float32)
    return {
        "cross_entropy": (logits, targets),
        "soft_cross_entropy": (logits, probs),
        "bce_with_logits": (logits[:2], binary),
        "nll_loss": (logp, targets),
        "simloss": (mp, targets),
        "log_softmax_mp": (mp,),
        "multiple_positives_loss": (mp, targets),
        "log_gauss": (mu, mu2, logvar),
        "log_gauss_scalar": (mu2, 0.0, np.log(1.0 ** 2)),
        "kld": (mu, logvar, mu2, logvar[::-1].copy()),
        "kld_scalar_prior": (mu, logvar, mu2, np.log(0.5 ** 2)),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_functions_match_jax(case):
    args = _loss_cases()[case]
    name = case.replace("_scalar_prior", "").replace("_scalar", "")

    def to_torch(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)
        return float(a)

    want = np.asarray(getattr(jh, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                          for a in args]))
    got = getattr(th, name)(*[to_torch(a) for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
