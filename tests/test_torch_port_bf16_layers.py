"""Torch port, the bf16 compute mode below the block: each layer of
``ops/layers.py``, the LSTM (kernels #3/#4 at its boundary) and the conv
BasicBlock, fused (kernels #5/#6) and unfused, on a bf16 input against the
JAX package's modules on the same bf16 input and weights (CPU).

Every layer follows its input's dtype at JAX's rounding points (JAX
``ops/layers.py``): the output is bf16, the parameters' gradients float32,
the norms' statistics and the running statistics float32.  The LSTM is held
against JAX's ``use_pallas=True`` in interpret mode (the TPU kernel's
function: a float32 recurrence on upcast operands), not its CPU default, the
bf16 ``lax.scan``, which is another function.  The fused conv block is held
against JAX ``use_pallas=True`` (interpret), the unfused one against JAX's
XLA path.

Limits (the bf16 mode's agreed tolerances): bf16 outputs and dx within 8e-3 of
max |JAX| (two bf16 units); each float32 parameter gradient within 1e-2 of
its largest value of the float64 evaluation of the same module on the same
bf16 input; the running statistics, f32 sums of the same bf16 values on both
sides, within 1e-5 (tightened from the step's 1e-2).  Against JAX the
parameter gradients are held within 3e-2: a parameter cast to bf16 gets a
bf16 gradient summed over the rows, and XLA's CPU backend keeps that sum's
accumulator in bf16, which drifts 1.0-1.9e-2 from the float64 sum over the
57-72 rows here (measured), where the port sums in float32 (2-5e-3 from it).
Weight gradients of products, which XLA sums in float32, agree to 2.5e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models.encoders import BasicBlock as JBasicBlock
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.ops.lstm import LSTM as JLSTM
from transformer_clip_eeg_tpu_torch.models.encoders import BasicBlock
from transformer_clip_eeg_tpu_torch.ops import layers as tl
from transformer_clip_eeg_tpu_torch.ops.lstm import LSTM
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 3, 24
OUT_TOL = 8e-3
GRAD_TOL = 1e-2
JAX_GRAD_TOL = 3e-2  # XLA's CPU sums a bf16 gradient in bf16 (module docstring)
STATS_TOL = 1e-5


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np32(got), _np32(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _bf16_np(shape, seed, scale=1.0, shift=0.0):
    """Normal values rounded to bf16 once, as float32 numpy (both sides)."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape) + shift).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _torch_bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _perturb(params, rng, names=("scale", "bias")):
    """Norm parameters (ones and zeros at init) given values worth testing."""
    for n in names:
        base = 1.0 if n == "scale" else 0.0
        params[n] = (base + 0.3 * rng.standard_normal(params[n].shape)).astype(np.float32)
    return params


def _hold_vjp(jmod, tmod, x, g, variables, jkw=None, tkw=None, mutable=()):
    """Forward and VJP of a JAX module and its port on a bf16 ``x``: the
    outputs and dx (bf16 on both sides) within OUT_TOL, each parameter's
    gradient (float32 on both sides) within JAX_GRAD_TOL of JAX's and within
    GRAD_TOL of the float64 evaluation of the port's module.  Returns JAX's
    mutated collections and the port's module."""
    jkw, tkw = jkw or {}, tkw or {}
    others = {k: v for k, v in variables.items() if k != "params"}

    def fwd(params, xx):
        out = jmod.apply({"params": params, **others}, xx, mutable=list(mutable) or False,
                         **jkw)
        return out if mutable else (out, {})

    out, vjp, mutated = jax.vjp(fwd, variables["params"], jnp.asarray(x, jnp.bfloat16),
                                has_aux=True)
    jgp, jgx = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == jnp.bfloat16 and jgx.dtype == jnp.bfloat16

    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    xt = _torch_bf16(x).requires_grad_()
    got = tmod(xt, **tkw)
    assert got.dtype == torch.bfloat16
    params = list(tmod.named_parameters())
    grads = torch.autograd.grad(got, [xt] + [p for _, p in params], _torch_bf16(g))
    assert grads[0].dtype == torch.bfloat16
    assert all(gr.dtype == torch.float32 for gr in grads[1:])
    assert _rel(got.detach(), out) <= OUT_TOL
    assert _rel(grads[0], jgx) <= OUT_TOL
    want = state_dict_from_jax({**jax.tree.map(np.asarray, dict(others)),
                                "params": jax.tree.map(np.asarray, jgp)}, tmod)
    t64 = copy.deepcopy(tmod).double()
    x64 = torch.tensor(np.asarray(x, np.float64)).requires_grad_()
    exact = torch.autograd.grad(t64(x64, **tkw), [x64, *t64.parameters()],
                                torch.tensor(np.asarray(g, np.float64)))
    for (name, _), mine, ref in zip(params, grads[1:], exact[1:]):
        assert _rel(mine, ref) <= GRAD_TOL, name
        assert _rel(mine, want[name]) <= JAX_GRAD_TOL, name
    return mutated, tmod


@pytest.mark.parametrize("case", ["dense", "conv_k8", "conv_k5", "conv_k1", "conv_valid_s3",
                                  "conv2d_valid_time"])
def test_products_follow_a_bf16_input_as_jax(case):
    """Dense, the same-padded and the valid strided Conv1d and the temporal
    Conv2d: weights cast to bf16, the product rounded, then the bias added
    in bf16 (JAX ``ops/layers.py:105-108, 151-160, 193-199``)."""
    c_in = 12
    mods = {
        "dense": (jl.Dense(8), tl.Dense(c_in, 8)),
        "conv_k8": (jl.Conv1d(10, 8), tl.Conv1d(c_in, 10, 8)),
        "conv_k5": (jl.Conv1d(10, 5), tl.Conv1d(c_in, 10, 5)),
        "conv_k1": (jl.Conv1d(10, 1), tl.Conv1d(c_in, 10, 1)),
        "conv_valid_s3": (jl.Conv1d(10, 3, stride=3, padding="valid"),
                          tl.Conv1d(c_in, 10, 3, stride=3, padding="valid")),
        "conv2d_valid_time": (jl.Conv2dValidTime(4, 5, 3), tl.Conv2dValidTime(4, 5, 3)),
    }
    jmod, tmod = mods[case]
    x = _bf16_np((B, T, c_in), seed=1)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    out_shape = jax.eval_shape(lambda xx: jmod.apply(variables, xx), jnp.asarray(x)).shape
    g = _bf16_np(out_shape, seed=2)
    _hold_vjp(jmod, tmod, x, g, variables)


@pytest.mark.parametrize("case", ["layernorm", "layernorm_tc"])
def test_layernorms_take_f32_statistics_and_a_bf16_affine(case):
    """The LayerNorms: statistics in float32, the normalised value rounded
    to bf16, scale and bias applied in bf16 (JAX ``:229-230, 257-258``)."""
    rng = np.random.default_rng(3)
    x = _bf16_np((B, T, 16), seed=4, scale=2.0, shift=1.0)
    jmod, tmod = ((jl.LayerNorm(), tl.LayerNorm(16)) if case == "layernorm"
                  else (jl.LayerNormTC(T, 16), tl.LayerNormTC(T, 16)))
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    variables["params"] = _perturb(dict(variables["params"]), rng)
    _hold_vjp(jmod, tmod, x, _bf16_np(x.shape, seed=5), variables)


@pytest.mark.parametrize("training", [True, False], ids=["batch_stats", "running_stats"])
def test_batchnorm_keeps_f32_statistics(training):
    """BatchNorm1d on a bf16 input: the batch statistics and the running
    statistics in float32 (updated in training as JAX updates them), the
    normalised value rounded to bf16, the affine in bf16 (JAX ``:293-303``)."""
    rng = np.random.default_rng(6)
    x = _bf16_np((B, T, 16), seed=7, scale=3.0, shift=-2.0)
    jmod = jl.BatchNorm1d()
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    variables["params"] = _perturb(dict(variables["params"]), rng)
    variables["batch_stats"] = {"mean": (0.5 * rng.standard_normal(16)).astype(np.float32),
                                "var": (1 + rng.uniform(0, 1, 16)).astype(np.float32)}
    tmod = tl.BatchNorm1d(16)
    tmod.train(training)
    mutated, tmod = _hold_vjp(jmod, tmod, x, _bf16_np(x.shape, seed=8), variables,
                              jkw=dict(use_running_average=not training),
                              mutable=("batch_stats",) if training else ())
    assert tmod.running_mean.dtype == tmod.running_var.dtype == torch.float32
    want = mutated["batch_stats"] if training else variables["batch_stats"]
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(want["mean"]),
                               atol=STATS_TOL, rtol=STATS_TOL)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(want["var"]),
                               atol=STATS_TOL, rtol=STATS_TOL)


def test_dropout_divides_in_bf16():
    """Dropout on a bf16 input keeps JAX's formula, ``where(keep, x /
    keep_prob, 0)`` with the division in bf16, on the port's own mask (the
    masks are the port's counter hash, not JAX's draws)."""
    x = _bf16_np((B, T, 16), seed=9)
    drop = tl.Dropout(0.3).train()
    drop.dropout_seed = 17
    got = drop(_torch_bf16(x))
    assert got.dtype == torch.bfloat16
    keep = (drop(torch.ones(B, T, 16)) != 0).numpy()
    want = jnp.where(jnp.asarray(keep), jnp.asarray(x, jnp.bfloat16) / (1.0 - 0.3),
                     jnp.zeros((), jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert 0 < (~keep).sum() < keep.size


@pytest.mark.parametrize("bidirectional", [True, False], ids=["D2", "D1"])
def test_lstm_in_bf16_matches_jax_use_pallas(bidirectional):
    """The LSTM on a bf16 input against JAX's ``LSTM(use_pallas=True)``
    (interpret mode): the input projection in bf16, ``whh`` cast to bf16,
    the recurrence in float32, ``hs`` and dx in bf16, and ``whh``'s gradient
    an f32 tensor of bf16 values (JAX's ``dwhh`` in ``whh``'s dtype)."""
    x = _bf16_np((B, 19, 6), seed=10)
    jmod = JLSTM(hidden_size=8, bidirectional=bidirectional, use_pallas=True)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    g = _bf16_np((B, 19, 16 if bidirectional else 8), seed=11)
    _, tmod = _hold_vjp(jmod, LSTM(6, 8, bidirectional=bidirectional), x, g, variables)
    xt = _torch_bf16(x)
    tmod.zero_grad()
    (tmod(xt).float() * torch.tensor(g)).sum().backward()
    for name, p in tmod.named_parameters():
        if name.startswith("weight_hh"):
            assert p.grad.dtype == torch.float32
            assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), name


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_conv_basic_block_in_bf16_matches_jax(fused):
    """The conv BasicBlock on a bf16 input, in eval: fused (the weights stay
    float32, x is upcast, out and dx come back in bf16) against JAX
    ``use_pallas=True``; unfused (the conv weights cast to bf16) against
    JAX's XLA path."""
    c, k = 16, 7
    x = _bf16_np((B, T, c), seed=12)
    rng = np.random.default_rng(13)
    jmod = JBasicBlock(out_channels=c, kernel_size=k, dropout_rate=0.2, time_dimension=T,
                       use_pallas=fused)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    params = dict(variables["params"])
    params["normalization"] = _perturb(dict(params["normalization"]), rng)
    variables["params"] = params
    tmod = BasicBlock(c, c, k, T, 0.2, fused=fused).eval()
    _hold_vjp(jmod, tmod, x, _bf16_np(x.shape, seed=14), variables, jkw=dict(
        deterministic=True))
