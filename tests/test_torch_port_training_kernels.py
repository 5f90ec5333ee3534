"""Torch port, the training side of the kernel modules: the dropout mask
function against the JAX block kernel's interpret-mode masks (bit for bit),
the block in training mode against JAX's ``fused_transformer_block(...,
training=True, interpret=True)`` forward and VJP, and the LSTM recurrence's
gradient against ``jax.vjp`` of the interpret-mode Pallas recurrence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.pallas_block import _dropout_mask
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused
from transformer_clip_eeg_tpu.ops.pallas_lstm import lstm_scan_pallas_packed
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.dropout import (
    dropout_mask,
    fold_seed,
    set_dropout_seeds,
)
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    fused_block_backward,
    fused_transformer_block,
    pick_tile,
)
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (
    lstm_scan_backward,
    lstm_scan_packed,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

T, E, HEADS = 32, 16, 4
BLOCK_TOL = dict(atol=5e-5, rtol=1e-4)
LSTM_ATOL = 1e-5


@pytest.mark.parametrize("seed_base,mask_id,shape,p", [
    (0, 0, (3, 5, 7), 0.5),
    (12345 * 8191, 4, (40, 16), 0.5),
    (-2_000_000_000, 7, (2, 9, 9), 0.2),  # an int32 seed_base that wrapped
    (2 ** 31 - 1, 1, (64, 3), 0.9),
])
def test_dropout_mask_matches_jax_interpret_bits(seed_base, mask_id, shape, p):
    want = np.asarray(_dropout_mask(jnp.asarray(seed_base, jnp.int32), mask_id, shape, p,
                                    use_prng=False))
    got = dropout_mask(seed_base + mask_id, shape, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).mean() < 1


def test_layer_seeds_are_per_layer_and_reproducible():
    net = torch.nn.Sequential(Dropout(0.5), TransformerEncoderBlock(16, 4), Dropout(0.5))
    set_dropout_seeds(net, 9)
    seeds = [net[0].dropout_seed, net[1].dropout_seed, net[2].dropout_seed]
    assert len(set(seeds)) == 3
    assert seeds == [fold_seed(9, n) for n in range(3)]
    set_dropout_seeds(net, 10)
    assert net[0].dropout_seed != seeds[0]
    assert all(0 <= s < 2 ** 31 for s in seeds)


def _block_case(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, E)).astype(np.float32)
    variables = JBlock(E, num_heads=HEADS, use_pallas=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    for ln in ("ln1", "ln2"):
        params[ln] = {"scale": (1 + 0.2 * rng.standard_normal(E)).astype(np.float32),
                      "bias": (0.2 * rng.standard_normal(E)).astype(np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g, {"params": params}


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


@pytest.mark.parametrize("b", [8, 6], ids=["tile8", "tile2"])
def test_block_training_matches_jax_interpret_forward_and_vjp(b):
    """The same seed draws the same masks: the port's block in training mode
    is JAX's interpret-mode kernel, forward and VJP (dx and the 16 dparams,
    weights transposed to the port's layout).  B=8 and B=6 run both
    ``_pick_tile`` branches (tiles 8 and 2)."""
    assert pick_tile(b) == {8: 8, 6: 2}[b]
    x, g, variables = _block_case(b, seed=b)
    seed = 40_000 + b
    jparams = _jax_tuple(variables["params"])
    out, vjp = jax.vjp(
        lambda xx, pp: j_fused(xx, pp, jnp.asarray(float(seed), jnp.float32), 0.5, 0.5,
                               HEADS, E ** 0.5, True, True),
        jnp.asarray(x), jparams)
    jdx, jdparams = vjp(jnp.asarray(g))

    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    leaves = [torch.from_numpy(x).requires_grad_()] + list(block.fused_params())
    got = fused_transformer_block(leaves[0], leaves[1:], HEADS, E ** 0.5, training=True,
                                  seed=seed, drop_p=0.5, ffn_drop_p=0.5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **BLOCK_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), **BLOCK_TOL)
    for i, (mine, theirs) in enumerate(zip(grads[1:], jdparams)):
        mine = mine.numpy()
        np.testing.assert_allclose(mine.T if mine.ndim == 2 else mine, np.asarray(theirs),
                                   err_msg=f"dparam {i}", **BLOCK_TOL)


def test_block_module_training_uses_its_seed():
    x, _, variables = _block_case(4, seed=1)
    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        block.train()
        block.dropout_seed = 3
        a, b = block(xt), block(xt)
        block.dropout_seed = 4
        c = block(xt)
        d = block.eval()(xt)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, d)


@pytest.mark.parametrize("hidden", [8, 4])
def test_lstm_gradient_matches_jax_vjp(hidden):
    """Autograd through the recurrence's CPU path (autograd through
    ``lstm_scan_reference``) against
    ``jax.vjp`` of the interpret-mode Pallas recurrence, two directions."""
    rng = np.random.default_rng(hidden)
    xw = (0.5 * rng.standard_normal((13, 2, 3, 4 * hidden))).astype(np.float32)
    whh = (0.3 * rng.standard_normal((2, hidden, 4 * hidden))).astype(np.float32)
    g = rng.standard_normal((13, 2, 3, hidden)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, w: lstm_scan_pallas_packed(a, w, hidden, True),
                       jnp.asarray(xw), jnp.asarray(whh))
    jdxw, jdwhh = vjp(jnp.asarray(g))
    a = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(whh).requires_grad_()
    h = lstm_scan_packed(a, w)
    dxw, dwhh = torch.autograd.grad(h, (a, w), torch.from_numpy(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(out), atol=LSTM_ATOL)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(jdxw), atol=LSTM_ATOL)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(jdwhh), atol=LSTM_ATOL)


def test_lstm_scan_packed_gives_h_a_gradient_and_refuses_c_under_autograd():
    """One entry point for both modes: under autograd ``h`` carries a
    gradient (``LSTMScanFunction`` on the card, the twin on the CPU); ``c``
    has none on the card, so asking for
    it there raises instead of returning a tensor cut off from the graph."""
    xw = torch.randn(5, 2, 2, 16, requires_grad=True)
    whh = torch.zeros(2, 4, 16)
    assert lstm_scan_packed(xw, whh).grad_fn is not None
    with pytest.raises(ValueError, match="return_c"):
        lstm_scan_packed(xw, whh, return_c=True)
    with torch.no_grad():
        h, c = lstm_scan_packed(xw, whh, return_c=True)
    assert h.grad_fn is None and c.shape == h.shape


def test_cpu_backward_leaves_the_kernel_counters_alone():
    """On the CPU the backward is autograd through the twins: neither backward
    kernel is counted, nor the forward kernels."""
    counters = (fused_transformer_block, fused_block_backward, lstm_scan_packed,
                lstm_scan_backward)
    before = [f.launches for f in counters]
    x, g, variables = _block_case(2, seed=2)
    block = TransformerEncoderBlock(E, num_heads=HEADS).train()
    block.load_state_dict(state_dict_from_jax(variables, block))
    xt = torch.from_numpy(x).requires_grad_()
    (block(xt) * torch.from_numpy(g)).sum().backward()
    xw = torch.zeros(5, 2, 2, 16, requires_grad=True)
    lstm_scan_packed(xw, torch.zeros(2, 4, 16, requires_grad=True)).sum().backward()
    assert xt.grad is not None and xw.grad is not None
    assert [f.launches for f in counters] == before
