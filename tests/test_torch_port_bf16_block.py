"""Torch port, the bf16 mode of the fused block (kernels #1 and #2), on the CPU.

A bfloat16 ``x`` selects the block's bf16 mode, as a bf16 activation selects
``mm_dtype='bfloat16'`` in the JAX block: every product of the forward and
the backward on operands rounded to bf16 with float32 sums, the rest in
float32.  Here the port's twins, which the kernels' bf16 instantiations are
held to on the card (``chip_smoke.py``), are held against JAX's
interpret-mode ``fused_transformer_block(..., mm_dtype='bfloat16')``:

* forward and VJP (dx and the 16 parameter gradients), dropout off and on,
  and the output dtypes (bf16 out and dx, float32 parameter gradients);
* the plain statements of the kernels' walk (the two-pass online softmax,
  what the forward saves, the backward formula by formula) against the twin;
* the bf16 selector of ``TransformerEncoderBlock`` and the wrappers' checks.

Limits (the bf16 mode's agreed tolerances): both sides round the same operands to
bf16 and sum in float32 in another order, so an intermediate flips by one
bf16 unit (2^-8 relative) where the two sums straddle a rounding boundary.
Block out and dx within 8e-3 of max |JAX| (two bf16 units); each parameter
gradient within 1e-2 of its largest value, but for the key bias's: that one
is zero in exact arithmetic (a softmax does not move when one vector is added
to every key), so both sides hold only rounding noise (JAX's own bf16 and f32
values differ by thousands of times its largest value), and it is held within
1e-2 of the query bias's largest value, the scale of the sum it is noise in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    N_SAVED,
    DropoutConfig,
    FusedBlockFunction,
    attention_online_reference,
    bf16_round,
    block_masks,
    fused_block_backward_reference,
    fused_block_saved_reference,
    fused_transformer_block,
    fused_transformer_block_reference,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

E, HEADS = 64, 8
OUT_TOL = 8e-3    # bf16 outputs: two bf16 units of max |ref|
GRAD_TOL = 1e-2   # float32 parameter gradients of one module, of each one's largest value
TWIN_TOL = 8e-3   # the kernels' plain walk against the twin: the same roundings, regrouped


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _block_case(b, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, E)).astype(np.float32)
    variables = JBlock(E, num_heads=HEADS, use_pallas=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    for ln in ("ln1", "ln2"):
        params[ln] = {"scale": (1 + 0.2 * rng.standard_normal(E)).astype(np.float32),
                      "bias": (0.2 * rng.standard_normal(E)).astype(np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)
    # the inputs are bf16 in the bf16 mode: round them once, for both sides
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return x, g, {"params": params}


DBK, DBQ = 6, 5  # the key and query biases' places in the 16-tuple


def _hold_dparams(mine, theirs):
    """The port's 16 parameter gradients (torch layouts) against JAX's
    (``[in, out]`` weights) at GRAD_TOL; the key bias's against the query
    bias's scale (module docstring)."""
    mine = [m.numpy() for m in mine]
    mine = [m.T if m.ndim == 2 else m for m in mine]
    theirs = [np.asarray(t, np.float32) for t in theirs]
    for i, (m, t) in enumerate(zip(mine, theirs)):
        scale = np.abs(theirs[DBQ if i == DBK else i]).max()
        assert np.abs(m - t).max() <= GRAD_TOL * scale, f"dparam {i}"


def _jax_tuple(p):
    a, f = p["attn"], p["ffn"]
    return tuple(jnp.asarray(v) for v in (
        p["ln1"]["scale"], p["ln1"]["bias"],
        a["queries"]["kernel"], a["keys"]["kernel"], a["values"]["kernel"],
        a["queries"]["bias"], a["keys"]["bias"], a["values"]["bias"],
        a["projection"]["kernel"], a["projection"]["bias"],
        p["ln2"]["scale"], p["ln2"]["bias"],
        f["fc1"]["kernel"], f["fc1"]["bias"], f["fc2"]["kernel"], f["fc2"]["bias"],
    ))


def _torch_params(variables):
    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    return [p.detach() for p in block.fused_params()]


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("b,t", [(2, 48), (3, 40)], ids=["b2_t48", "b3_t40"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_bf16_block_matches_jax_interpret_forward_and_vjp(b, t, training):
    """The port's block on a bf16 x against JAX's interpret-mode kernel with
    ``mm_dtype='bfloat16'``: out and dx (bf16) within OUT_TOL, the 16
    parameter gradients (float32) within GRAD_TOL, dropout off and on (rates
    0.5/0.5, one seed, so the same masks); B=3 takes a batch tile of 1."""
    x, g, variables = _block_case(b, t, seed=21 + t)
    seed = 4_321
    jx = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(
        lambda xx, pp: j_fused(xx, pp, jnp.asarray(float(seed), jnp.float32), 0.5, 0.5,
                               HEADS, E ** 0.5, training, True, "bfloat16"),
        jx, _jax_tuple(variables["params"]))
    jdx, jdparams = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == jnp.bfloat16 and jdx.dtype == jnp.bfloat16
    leaves = [_bf16(x).requires_grad_()] + [
        p.requires_grad_() for p in _torch_params(variables)]
    got = fused_transformer_block(leaves[0], leaves[1:], HEADS, E ** 0.5, training=training,
                                  seed=seed, drop_p=0.5, ffn_drop_p=0.5)
    assert got.dtype == torch.bfloat16
    grads = torch.autograd.grad(got, leaves, _bf16(g))
    assert grads[0].dtype == torch.bfloat16
    assert all(d.dtype == torch.float32 for d in grads[1:])
    assert _rel(got.detach().float().numpy(), out) <= OUT_TOL
    assert _rel(grads[0].float().numpy(), jdx) <= OUT_TOL
    _hold_dparams(grads[1:], jdparams)


def test_bf16_block_is_not_the_f32_block():
    """The mode changes the function: on one (bf16-representable) input the
    bf16 twin's output is further from the f32 twin's than the rounding of
    the output alone (1/2 unit, 2e-3 of max) would put it, and within 5e-2."""
    x, _, variables = _block_case(2, 48, seed=5)
    params = _torch_params(variables)
    f32 = fused_transformer_block_reference(torch.tensor(x), params, HEADS, E ** 0.5)
    bf = fused_transformer_block_reference(_bf16(x), params, HEADS, E ** 0.5)
    assert f32.dtype == torch.float32 and bf.dtype == torch.bfloat16
    gap = _rel(bf.float().numpy(), f32.numpy())
    assert 2e-3 < gap < 5e-2


@pytest.mark.parametrize("drop_p", [0.0, 0.5], ids=["eval", "dropout"])
@pytest.mark.parametrize("t", [33, 48])
def test_two_pass_online_softmax_is_the_twins_attention(t, drop_p):
    """Kernel #1's bf16 attention stated in plain torch (two passes over key
    tiles of 16: max and sum, then the normalised, dropped-out probabilities
    rounded to bf16 and multiplied into v) against the twin's softmax with
    the same roundings; the log-sum-exp is the clean softmax's."""
    rng = np.random.default_rng(t)
    b = 2
    q, k, v = (bf16_round(torch.from_numpy(rng.standard_normal((b, t, E)).astype(np.float32)))
               for _ in range(3))
    q = bf16_round(q * 3.0)
    mask = None
    if drop_p:
        mask = block_masks(b, t, E, 4 * E, HEADS, DropoutConfig(True, 9 + t, drop_p, 0.0))[0]
    ctx, lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask, bf16=True)
    d = E // HEADS
    qh, kh, vh = (a.reshape(b, t, HEADS, d).transpose(1, 2) for a in (q, k, v))
    s = qh @ kh.transpose(2, 3) / E ** 0.5
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p * mask
    want = bf16_round((bf16_round(p) @ vh).transpose(1, 2).reshape(b, t, E))
    assert _rel(ctx.numpy(), want.numpy()) <= TWIN_TOL
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=1e-5)
    # q, k, v and the context the bf16 forward keeps are bf16 values
    assert torch.equal(ctx, bf16_round(ctx))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_bf16_saved_and_backward_statements_match_the_twin(training):
    """What the bf16 training forward saves (q, k, v and the context as bf16
    values, x1 and the log-sum-exp) against the twin's intermediates, and the
    backward's formula (kernel #2's bf16 instantiation) against JAX's VJP."""
    x, g, variables = _block_case(2, 40, seed=8)
    params = _torch_params(variables)
    drop = DropoutConfig(training, 77, 0.5, 0.5)
    xb = _bf16(x)
    saved = fused_block_saved_reference(xb, params, HEADS, E ** 0.5, drop)
    assert saved.dtype == torch.float32
    n = x.size
    planes = saved[:N_SAVED * n].reshape(N_SAVED, *x.shape)
    for i in range(4):
        assert torch.equal(planes[i], bf16_round(planes[i])), f"plane {i}"
    out = fused_transformer_block_reference(xb, params, HEADS, E ** 0.5, *drop)
    # out = x1 + the FFN branch: x1 is the residual stream the backward reads
    assert _rel(planes[4].numpy(), out.float().numpy()) < 1.0
    dx, dparams = fused_block_backward_reference(xb, params, _bf16(g), HEADS, E ** 0.5, drop)
    assert dx.dtype == torch.bfloat16 and all(d.dtype == torch.float32 for d in dparams)
    seed = jnp.asarray(77.0, jnp.float32)
    _, vjp = jax.vjp(
        lambda xx, pp: j_fused(xx, pp, seed, 0.5, 0.5, HEADS, E ** 0.5, training, True,
                               "bfloat16"),
        jnp.asarray(x, jnp.bfloat16), _jax_tuple(variables["params"]))
    jdx, jdparams = vjp(jnp.asarray(g, jnp.bfloat16))
    assert _rel(dx.float().numpy(), jdx) <= OUT_TOL
    _hold_dparams(dparams, jdparams)


def test_encoder_block_selects_the_mode_by_the_inputs_dtype():
    """``TransformerEncoderBlock`` takes no flag: a bf16 input gives a bf16
    output through the bf16 mode, a float32 input the float32 block."""
    x, _, variables = _block_case(2, 48, seed=3)
    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    block.eval()
    with torch.no_grad():
        y32 = block(torch.tensor(x))
        y16 = block(_bf16(x))
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    want = fused_transformer_block_reference(_bf16(x), list(block.fused_params()), HEADS,
                                             E ** 0.5)
    assert torch.equal(y16, want)


def test_cpu_backward_in_bf16_is_the_plain_statement():
    """On the CPU the bf16 gradient is ``fused_block_backward_reference`` (the
    JAX VJP's rounding points), not autograd through the twin's casts."""
    x, g, variables = _block_case(2, 32, seed=4)
    params = [p.requires_grad_() for p in _torch_params(variables)]
    xb = _bf16(x).requires_grad_()
    drop = DropoutConfig(False, 0, 0.5, 0.5)
    out = FusedBlockFunction.apply(xb, HEADS, E ** 0.5, drop, *params)
    grads = torch.autograd.grad(out, [xb, *params], _bf16(g))
    dx, dparams = fused_block_backward_reference(xb.detach(), [p.detach() for p in params],
                                                 _bf16(g), HEADS, E ** 0.5, drop)
    assert torch.equal(grads[0], dx)
    for mine, want in zip(grads[1:], dparams):
        assert torch.equal(mine, want)
