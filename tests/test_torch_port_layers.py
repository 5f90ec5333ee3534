"""Torch port, ops/layers.py: each layer against its JAX twin on the same
inputs and weights (moved by utils/convert.py), atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu_torch.ops import layers as tl
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 3, 32
ATOL = 1e-5


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def _perturb_norm(variables, rng):
    """LayerNorm params init to ones/zeros; give them values worth testing."""
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    params["scale"] = (1 + 0.3 * rng.standard_normal(params["scale"].shape)).astype(np.float32)
    params["bias"] = (0.3 * rng.standard_normal(params["bias"].shape)).astype(np.float32)
    return {"params": params}


def _run_pair(jmod, tmod, x, variables=None):
    if variables is None:
        variables = _numpy_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize(
    "c_in,c_out,k",
    [(64, 64, 64), (64, 64, 32), (32, 64, 1), (16, 8, 5), (1024, 64, 1)],
    ids=["k64", "k32", "k1", "k5-odd", "k1-wav2vec"],
)
def test_conv1d_same_padding_matches_jax(c_in, c_out, k):
    x = np.random.default_rng(0).standard_normal((B, T, c_in)).astype(np.float32)
    got, want = _run_pair(jl.Conv1d(c_out, k), tl.Conv1d(c_in, c_out, k), x)
    assert got.shape == want.shape == (B, T, c_out)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layernorm_tc_matches_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((B, T, 64)) + 1).astype(np.float32)
    jmod = jl.LayerNormTC(T, 64)
    variables = _perturb_norm(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    got, want = _run_pair(jmod, tl.LayerNormTC(T, 64), x, variables)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((B, T, 64)) - 1).astype(np.float32)
    jmod = jl.LayerNorm()
    variables = _perturb_norm(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    got, want = _run_pair(jmod, tl.LayerNorm(64), x, variables)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dense_matches_jax():
    x = np.random.default_rng(4).standard_normal((B, T, 64)).astype(np.float32)
    got, want = _run_pair(jl.Dense(8), tl.Dense(64, 8), x)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gelu_exact_matches_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jl.gelu_exact(jnp.asarray(x)))
    got = tl.gelu_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(5).standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0  # the eps floor: a zero row stays zero
    want = np.asarray(jl.l2_normalize(jnp.asarray(x), 1))
    got = tl.l2_normalize(torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[2] == 0.0)


def test_torch_uniform_init_bound_and_seed():
    w = torch.empty(64, 256)
    tl.torch_uniform_init(w, 256, torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= 1 / 16
    w2 = torch.empty(64, 256)
    tl.torch_uniform_init(w2, 256, torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)


def test_dropout_eval_is_identity_and_training_is_seeded():
    drop = tl.Dropout(0.4)
    x = torch.ones(2000)
    assert drop.eval()(x) is x
    drop.train()
    drop.dropout_seed = 1
    a = drop(x)
    b = drop(x)
    assert torch.equal(a, b)
    drop.dropout_seed = 2
    assert not torch.equal(drop(x), a)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.05
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.6, rtol=1e-6)
