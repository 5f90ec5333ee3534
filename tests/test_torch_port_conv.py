"""Torch port, the conv block (``ops/fused_conv.py``): its plain path against
JAX's interpret-mode ``fused_basic_block`` (forward with the masks bit for
bit, and the VJP), the conv alone against the JAX kernel's direct taps, the
port's ``BasicBlock(fused=True)`` against JAX's ``BasicBlock(use_pallas=True)``
with the weights carried across by ``state_dict_from_jax``, the routing
rule, and the dropout stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu.models.encoders import BasicBlock as JBasicBlock
from transformer_clip_eeg_tpu.ops.pallas_block import _dropout_mask
from transformer_clip_eeg_tpu.ops.pallas_conv import _conv_taps_direct, _pick_tile, _same_pad
from transformer_clip_eeg_tpu.ops.pallas_conv import fused_basic_block as j_fused
from transformer_clip_eeg_tpu_torch.models import encoders
from transformer_clip_eeg_tpu_torch.models.encoders import BasicBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import MAX_KERNEL_T, SMEM_OPTIN_BYTES
from transformer_clip_eeg_tpu_torch.ops.fused_conv import (
    conv1d_same,
    conv_mask,
    fused_basic_block,
    fused_basic_block_reference,
    fused_conv_backward,
    kernel_smem_bytes,
    max_kernel_t,
)
from transformer_clip_eeg_tpu_torch.ops.layers import init_parameters
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

T, C = 32, 16
DROP = 0.3
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
VJP_TOL = 1e-4  # of max(1, max |JAX gradient|), per gradient
# (B, K): batch tiles 4, 2 and 1; an even K (asymmetric pad), an odd K, even again
CASES = [(4, 12), (6, 7), (5, 8)]
CASE_IDS = ["B4K12", "B6K7", "B5K8"]


def _case(b, k, seed):
    """x, the JAX kernel's w [K, C_in, C_out], b, scale, bias [T, C] (the
    LayerNorm affine perturbed) and an upstream gradient, from numpy."""
    rng = np.random.default_rng(seed)
    lim = 1.0 / np.sqrt(C * k)
    x = rng.standard_normal((b, T, C)).astype(np.float32)
    w = rng.uniform(-lim, lim, (k, C, C)).astype(np.float32)
    bb = rng.uniform(-lim, lim, C).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal((T, C))).astype(np.float32)
    bias = (0.2 * rng.standard_normal((T, C))).astype(np.float32)
    g = rng.standard_normal((b, T, C)).astype(np.float32)
    return x, w, bb, scale, bias, g


def _torch_args(x, w, bb, scale, bias):
    """The port's arguments: w in torch's Conv1d layout [C_out, C_in, K]."""
    return [torch.from_numpy(np.ascontiguousarray(v))
            for v in (x, w.transpose(2, 1, 0), bb, scale, bias)]


def _jax_block(k, seed, training):
    return lambda x, w, bb, scale, bias: j_fused(
        x, w, bb, scale, bias, jnp.asarray(float(seed), jnp.float32), k, DROP, training, True)


def _err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("b", [4, 6, 5])
def test_conv_mask_matches_jax_interpret_bits(b):
    """``conv_mask`` draws the JAX kernel's interpret-mode mask, tile by tile:
    key ``int32((seed + tile) * 7577)``, mask id 0, index row-major in the
    tile's (tb, T, C).  The seed makes ``(seed + tile) * 7577`` wrap int32."""
    seed, tb = 9_999_991, _pick_tile(b)
    got = conv_mask(seed, b, T, C, DROP).numpy()
    for i in range(b // tb):
        seed_base = (jnp.asarray(seed, jnp.int32) + i) * np.int32(7577)
        want = np.asarray(_dropout_mask(seed_base, 0, (tb, T, C), DROP, use_prng=False))
        np.testing.assert_array_equal(got[i * tb:(i + 1) * tb], want)
    assert 0.1 < (got == 0).mean() < 0.5


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("b,k", CASES, ids=CASE_IDS)
def test_forward_matches_jax_interpret(b, k, training):
    """The port's block = JAX's interpret-mode kernel; in training the same
    seed (below 2**24, so the JAX wrapper's f32 holds it exactly) draws the
    same mask."""
    x, w, bb, scale, bias, _ = _case(b, k, seed=10 * b + k)
    seed = 1_000_003 + b
    want = _jax_block(k, seed, training)(*map(jnp.asarray, (x, w, bb, scale, bias)))
    got = fused_basic_block(*_torch_args(x, w, bb, scale, bias), seed, k, DROP, training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if training:  # the mask did drop elements: eval differs
        ev = fused_basic_block(*_torch_args(x, w, bb, scale, bias), seed, k, DROP, False)
        assert not torch.allclose(ev, got)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("b,k", CASES, ids=CASE_IDS)
def test_vjp_matches_jax(b, k, training):
    """Autograd through the CPU path (``FusedBasicBlockFunction``, whose
    backward is autograd through the twin) against ``jax.vjp`` of the
    interpret-mode kernel: dx, dw, db, dscale, dbias."""
    x, w, bb, scale, bias, g = _case(b, k, seed=100 + 10 * b + k)
    seed = 2_000_017 + b
    out, vjp = jax.vjp(_jax_block(k, seed, training),
                       *map(jnp.asarray, (x, w, bb, scale, bias)))
    jdx, jdw, jdb, jdscale, jdbias = vjp(jnp.asarray(g))
    leaves = [v.requires_grad_() for v in _torch_args(x, w, bb, scale, bias)]
    got = fused_basic_block(*leaves, seed, k, DROP, training)
    assert got.grad_fn is not None
    dx, dw, db, dscale, dbias = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD_TOL)
    for name, mine, theirs in (("dx", dx, jdx), ("dw", dw.permute(2, 1, 0), jdw),
                               ("db", db, jdb), ("dscale", dscale, jdscale),
                               ("dbias", dbias, jdbias)):
        assert _err(mine.numpy(), theirs) <= VJP_TOL, (name, _err(mine.numpy(), theirs))


@pytest.mark.parametrize("k", [12, 7, 1])
def test_conv1d_same_matches_jax_direct_taps(k):
    """The conv alone (kernel #7's plain path) against the JAX kernel's
    direct-taps convolution (``_conv_taps_direct``, the bench script's
    "direct" algorithm) on the same 'same' padding; and against torch's own
    ``padding='same'``."""
    x, w, *_ = _case(3, k, seed=k)
    lo, hi = _same_pad(k)
    u = jnp.pad(jnp.asarray(x), ((0, 0), (lo, hi), (0, 0)))
    want = np.asarray(_conv_taps_direct(u, jnp.asarray(w).reshape(k * C, C), T, C, k))
    xt, wt = _torch_args(x, w, w[0, 0], w[0], w[0])[:2]
    got = conv1d_same(xt, wt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    same = F.conv1d(xt.transpose(1, 2), wt, padding="same").transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), same.numpy(), atol=1e-5)


def _jax_module_case(k, seed):
    """x, g and a JAX ``BasicBlock(use_pallas=True)``'s variables with the
    LayerNorm affine perturbed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, T, C)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jblock = JBasicBlock(out_channels=C, kernel_size=k, dropout_rate=0.2, time_dimension=T,
                         use_pallas=True)
    params = jax.tree.map(np.asarray, dict(jblock.init(jax.random.PRNGKey(seed),
                                                       jnp.asarray(x))["params"]))
    params["normalization"] = {
        "scale": (1 + 0.2 * rng.standard_normal((T, C))).astype(np.float32),
        "bias": (0.2 * rng.standard_normal((T, C))).astype(np.float32)}
    return x, g, jblock, {"params": params}


@pytest.mark.parametrize("k", [12, 7])
def test_fused_module_matches_jax_use_pallas(k):
    """``BasicBlock(fused=True)`` loads a JAX ``BasicBlock(use_pallas=True)``
    tree through ``state_dict_from_jax`` (strictly: name for name) and
    matches it, output and gradients of x and every parameter, in eval."""
    x, g, jblock, variables = _jax_module_case(k, seed=k)

    def loss(params, xx):
        return jnp.sum(jblock.apply({"params": params}, xx, True) * jnp.asarray(g))

    want = np.asarray(jblock.apply(variables, jnp.asarray(x), True))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))

    block = BasicBlock(C, C, k, T, 0.2, fused=True).eval()
    block.load_state_dict(state_dict_from_jax(variables, block))
    assert block.state_dict().keys() == BasicBlock(C, C, k, T, 0.2).state_dict().keys()
    xt = torch.from_numpy(x).requires_grad_()
    got = block(xt)
    assert got.grad_fn is not None
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    pairs = [("x", xt.grad, jgx),
             ("conv.weight", block.conv.weight.grad.permute(2, 1, 0), jgp["conv"]["kernel"]),
             ("conv.bias", block.conv.bias.grad, jgp["conv"]["bias"]),
             ("normalization.weight", block.normalization.weight.grad,
              jgp["normalization"]["scale"]),
             ("normalization.bias", block.normalization.bias.grad,
              jgp["normalization"]["bias"])]
    for name, mine, theirs in pairs:
        assert _err(mine.numpy(), theirs) <= VJP_TOL, (name, _err(mine.numpy(), theirs))


def _spy(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return fused_basic_block(*args, **kw)

    monkeypatch.setattr(encoders, "fused_basic_block", spy)
    return calls


@pytest.mark.parametrize("in_c,out_c,dilation,fused_path", [
    (C, C, 1, True), (C, 2 * C, 1, False), (2 * C, C, 1, False), (C, C, 2, False)],
    ids=["square", "widening", "narrowing", "dilated"])
def test_routing_follows_the_jax_rule(monkeypatch, in_c, out_c, dilation, fused_path):
    """``fused=True`` takes the fused block only for a square, undilated
    block (JAX's ``test_non_square_falls_back``); any other block runs the
    unfused layers, with the same result as ``fused=False``."""
    calls = _spy(monkeypatch)
    gen = torch.Generator().manual_seed(3)
    fused = BasicBlock(in_c, out_c, 8, T, 0.2, dilation=dilation, fused=True).eval()
    init_parameters(fused, gen)
    plain = BasicBlock(in_c, out_c, 8, T, 0.2, dilation=dilation).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, T, in_c, generator=gen)
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert got.shape == (2, T, out_c)
    assert len(calls) == int(fused_path)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_fused_dropout_is_deterministic_per_seed():
    """The fused block draws its mask from its Dropout's ``dropout_seed``
    (set per layer by ``set_dropout_seeds``): the same seed gives the same
    output, another seed another one, and eval mode none; gradients stay
    finite."""
    gen = torch.Generator().manual_seed(4)
    block = BasicBlock(C, C, 8, T, 0.4, fused=True)
    init_parameters(block, gen)
    x = torch.randn(4, T, C, generator=gen)
    with torch.no_grad():
        block.train()
        block.dropout.dropout_seed = 11
        a, b = block(x), block(x)
        block.dropout.dropout_seed = 12
        c = block(x)
        d = block.eval()(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, d)
    w = block.conv.weight
    want = fused_basic_block_reference(x, w, block.conv.bias, block.normalization.weight,
                                       block.normalization.bias, 11, 8, 0.4, True)
    torch.testing.assert_close(a, want.detach(), atol=0, rtol=0)
    block.train()
    block.dropout.dropout_seed = 13
    block(x.requires_grad_()).square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in block.parameters())


def test_cpu_paths_leave_the_conv_counters_alone():
    """On the CPU every path is the plain twin: no conv kernel is counted."""
    counters = (fused_basic_block, fused_conv_backward, conv1d_same)
    before = [f.launches for f in counters]
    block = BasicBlock(C, C, 8, T, 0.2, fused=True).train()
    init_parameters(block, torch.Generator().manual_seed(5))
    x = torch.randn(2, T, C, requires_grad=True)
    block(x).sum().backward()
    conv1d_same(x.detach(), block.conv.weight.detach())
    assert x.grad is not None
    assert [f.launches for f in counters] == before


def test_kernel_window_limit():
    """The forward kernel keeps a padded sample and its conv output in shared
    memory: at K=64 it holds T <= 345, the encoders' default 320 rows
    included; the transformer block, which keeps no whole sample there, takes
    longer windows than that (T <= 1,699)."""
    assert MAX_KERNEL_T > max_kernel_t(64) == 345 >= 320
    assert kernel_smem_bytes(345, 64) <= SMEM_OPTIN_BYTES < kernel_smem_bytes(346, 64)
    assert max_kernel_t(32) > max_kernel_t(64)
    assert max_kernel_t(64, fused=False) > max_kernel_t(64)


def test_kernel_size_must_match_the_weight():
    x, w, bb, scale, bias, _ = _case(2, 8, seed=0)
    with pytest.raises(ValueError, match="kernel_size=7"):
        fused_basic_block(*_torch_args(x, w, bb, scale, bias), 0, 7, 0.0, False)
