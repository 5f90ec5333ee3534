"""Torch port, the baseline networks (``models/baselines.py``) against the JAX
package's on the CPU: ``ClassificationHead``, ``FCNN``, ``CNN`` and
``ConvBlock`` at their JAX default widths on the same numpy-seeded inputs
and weights carried from JAX (``utils/convert.state_dict_from_jax``), in
eval mode (running statistics) and in training mode (batch statistics, the
running statistics they leave, every parameter's gradient), dropout off on
both sides (flax's masks cannot be drawn in torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from transformer_clip_eeg_tpu.models import baselines as jb
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu_torch.models import baselines
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

OUT_TOL = 1e-5   # of max(1, max |JAX|): f32 sums in another order
# of max(1, the model's largest gradient): a conv bias ahead of a batch norm
# in training mode has an exact gradient of 0, which both sides give as the
# noise of cancelling f32 sums
GRAD_TOL = 1e-4
B = 16


class _NoDropout(jl.Dropout):
    """flax's Dropout as the identity."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture(autouse=True)
def _jax_without_dropout(monkeypatch):
    monkeypatch.setattr(jb, "Dropout", _NoDropout)


def _cases():
    rng = np.random.default_rng(0)
    return {
        "ClassificationHead": (jb.ClassificationHead(), baselines.ClassificationHead(2440),
                               rng.standard_normal((B, 40, 61)).astype(np.float32)),
        "FCNN": (jb.FCNN(), baselines.FCNN(),
                 rng.standard_normal((B, 50, 63)).astype(np.float32)),
        "CNN": (jb.CNN(), baselines.CNN(),
                (1.0 + rng.standard_normal((B, 63, 50))).astype(np.float32)),
        "ConvBlock": (jb.ConvBlock(4, 8, (3, 2), padding="same", activation="elu"),
                      baselines.ConvBlock(4, 8, (3, 2), padding="same", activation="elu"),
                      (0.5 + rng.standard_normal((B, 4, 9, 12))).astype(np.float32)),
    }


def _apply(jmodel, variables, x, train):
    kw = {"use_running_average": not train} if isinstance(jmodel, jb.ConvBlock) \
        else {"deterministic": not train}
    if not train:
        return jmodel.apply(variables, x, **kw), variables.get("batch_stats", {})
    out, mutated = jmodel.apply(variables, x, mutable=["batch_stats"], **kw)
    return out, mutated.get("batch_stats", {})


def _close(got, want, tol, what):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(_cases()))
def test_baseline_matches_jax(name, train):
    jmodel, tmodel, x = _cases()[name]
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(0), x)))
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    for m in tmodel.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    tmodel.train(train)

    def loss(params):
        out, stats = _apply(jmodel, dict(variables, params=params), x, train)
        first = out[1] if isinstance(out, tuple) else out
        return jnp.sum(jnp.sin(first)), (out, stats)

    jgrads, (jout, jstats) = jax.grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    out = tmodel(torch.from_numpy(x))
    first = out[1] if isinstance(out, tuple) else out
    torch.sin(first).sum().backward()
    if isinstance(out, tuple):
        np.testing.assert_array_equal(out[0].detach().numpy(), np.asarray(jout[0]))
    _close(first, jout[1] if isinstance(jout, tuple) else jout, OUT_TOL, "out")

    after = state_dict_from_jax(
        dict(variables, batch_stats=jax.tree.map(np.asarray, dict(jstats))), tmodel) \
        if "batch_stats" in variables else {}
    buffers = dict(tmodel.named_buffers())
    assert set(buffers) == {k for k in after if "running" in k}
    for k, v in buffers.items():
        _close(v, after[k].numpy(), OUT_TOL, k)
    if train and buffers:  # the training step moved the running statistics
        assert any(not torch.equal(v, state_dict_from_jax(variables, tmodel)[k])
                   for k, v in buffers.items())
    grads = state_dict_from_jax(dict(variables, params=jax.tree.map(np.asarray, jgrads)),
                                tmodel)
    scale = max(1.0, max(float(g.abs().max()) for g in grads.values()))
    for n, p in tmodel.named_parameters():
        err = float((p.grad - grads[n]).abs().max())
        assert err <= GRAD_TOL * scale, (n, err)


def test_squeeze_layer_matches_jax():
    x = np.zeros((3, 1, 5), np.float32)
    for axis in (1, 2):
        got = baselines.SqueezeLayer(axis)(torch.from_numpy(x))
        assert tuple(got.shape) == jb.SqueezeLayer(axis).apply({}, x).shape


def test_fcnn_ladder_widths_match_jax():
    """The ladder's widths for several depths, read from JAX's params."""
    for hidden in (1, 2, 3):
        x = np.zeros((2, 10, 7), np.float32)
        jv = jb.FCNN(num_hidden=hidden, input_length=10, num_input_channels=7).init(
            jax.random.PRNGKey(0), x)
        t = baselines.FCNN(num_hidden=hidden, input_length=10, num_input_channels=7)
        want = [np.asarray(jv["params"][f"fc_{i}"]["kernel"]).shape[::-1]
                for i in range(hidden + 1)]
        assert [tuple(getattr(t, f"fc_{i}").weight.shape) for i in range(hidden + 1)] == want
