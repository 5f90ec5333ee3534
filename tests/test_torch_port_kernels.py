"""Torch port, kernel modules: the plain twins of the CUDA kernels against
the JAX Pallas kernels (interpret mode) and the JAX XLA paths, and the
wrappers' CPU behaviour (plain path, launch counters untouched)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.lstm import LSTM as JLSTM
from transformer_clip_eeg_tpu.ops.lstm import _lstm_scan
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused
from transformer_clip_eeg_tpu.ops.pallas_lstm import (
    lstm_scan_pallas,
    lstm_scan_pallas_packed,
)
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    MAX_KERNEL_T,
    SMEM_OPTIN_BYTES,
    _check_cuda_inputs,
    attention_backward_smem_bytes,
    attention_smem_bytes,
    fused_transformer_block,
    fused_transformer_block_reference,
    saved_numel,
)
from transformer_clip_eeg_tpu_torch.ops.lstm import LSTM
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (
    lstm_scan_packed,
    lstm_scan_reference,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T = 2, 32
BLOCK_TOL = dict(atol=5e-5, rtol=1e-4)
LSTM_ATOL = 1e-6


def _block_case(e, heads, seed=0):
    """x and a JAX block's variables with perturbed LayerNorm params."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, e)).astype(np.float32)
    variables = JBlock(e, num_heads=heads, use_pallas=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x)
    )
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    for ln in ("ln1", "ln2"):
        params[ln] = {
            "scale": (1 + 0.2 * rng.standard_normal(e)).astype(np.float32),
            "bias": (0.2 * rng.standard_normal(e)).astype(np.float32),
        }
    return x, {"params": params}


def _jax_tuple(p):
    """The JAX kernel's 16-tuple ([in, out] weights)."""
    a, f = p["attn"], p["ffn"]
    return tuple(jnp.asarray(v) for v in (
        p["ln1"]["scale"], p["ln1"]["bias"],
        a["queries"]["kernel"], a["keys"]["kernel"], a["values"]["kernel"],
        a["queries"]["bias"], a["keys"]["bias"], a["values"]["bias"],
        a["projection"]["kernel"], a["projection"]["bias"],
        p["ln2"]["scale"], p["ln2"]["bias"],
        f["fc1"]["kernel"], f["fc1"]["bias"], f["fc2"]["kernel"], f["fc2"]["bias"],
    ))


def _torch_block(e, heads, variables):
    block = TransformerEncoderBlock(e, num_heads=heads).eval()
    block.load_state_dict(state_dict_from_jax(variables, block))
    return block


@pytest.mark.parametrize("e,heads", [(16, 4), (64, 8)], ids=["E16H4", "E64H8"])
def test_block_reference_matches_pallas_interpret(e, heads):
    x, variables = _block_case(e, heads)
    want = np.asarray(j_fused(
        jnp.asarray(x), _jax_tuple(variables["params"]), jnp.zeros((), jnp.float32),
        0.5, 0.5, heads, e ** 0.5, False, True,
    ))
    block = _torch_block(e, heads, variables)
    with torch.no_grad():
        got = fused_transformer_block_reference(
            torch.from_numpy(x), block.fused_params(), heads, e ** 0.5
        ).numpy()
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


@pytest.mark.parametrize("e,heads", [(16, 4), (64, 8)], ids=["E16H4", "E64H8"])
def test_block_reference_matches_xla_block(e, heads):
    x, variables = _block_case(e, heads, seed=1)
    want = np.asarray(JBlock(e, num_heads=heads, use_pallas=False).apply(
        variables, jnp.asarray(x), True
    ))
    block = _torch_block(e, heads, variables)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        plain = fused_transformer_block_reference(xt, block.fused_params(), heads, e ** 0.5)
        eager = block(xt)  # the module's own eager path on a CPU tensor
    np.testing.assert_allclose(plain.numpy(), want, **BLOCK_TOL)
    np.testing.assert_allclose(eager.numpy(), want, **BLOCK_TOL)


def test_block_scale_is_full_embedding_width():
    """The emb_size**0.5 quirk: a head-width scale gives another answer."""
    x, variables = _block_case(64, 8, seed=2)
    block = _torch_block(64, 8, variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = fused_transformer_block_reference(xt, block.fused_params(), 8, 8.0)
        head = fused_transformer_block_reference(xt, block.fused_params(), 8, 8 ** 0.5)
        np.testing.assert_allclose(block(xt).numpy(), full.numpy(), atol=1e-6)
    assert float((full - head).abs().max()) > 1e-3


def _lstm_case(t, d, b, hidden, seed):
    rng = np.random.default_rng(seed)
    xw = (rng.standard_normal((t, d, b, 4 * hidden)) * 0.5).astype(np.float32)
    whh = (rng.standard_normal((d, hidden, 4 * hidden)) * 0.3).astype(np.float32)
    return xw, whh


@pytest.mark.parametrize("t", [16, 19])
def test_lstm_reference_matches_pallas_interpret(t):
    xw, whh = _lstm_case(t, 1, 4, 8, seed=0)
    want = np.asarray(lstm_scan_pallas(jnp.asarray(xw[:, 0]), jnp.asarray(whh[0]), 8, True))
    got = lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(whh))
    np.testing.assert_allclose(got[:, 0].numpy(), want, atol=LSTM_ATOL)
    scan = np.asarray(_lstm_scan(jnp.asarray(xw[:, 0]), jnp.asarray(whh[0]), 8))
    np.testing.assert_allclose(got[:, 0].numpy(), scan, atol=LSTM_ATOL)


@pytest.mark.parametrize("hidden", [8, 4])
def test_lstm_reference_matches_pallas_packed(hidden):
    xw, whh = _lstm_case(19, 2, 3, hidden, seed=1)
    want = np.asarray(lstm_scan_pallas_packed(jnp.asarray(xw), jnp.asarray(whh), hidden, True))
    got = lstm_scan_packed(torch.from_numpy(xw), torch.from_numpy(whh))
    assert got.shape == (19, 2, 3, hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=LSTM_ATOL)


def test_lstm_reference_returns_cell_state():
    xw, whh = _lstm_case(12, 2, 3, 4, seed=2)
    h, c = lstm_scan_reference(torch.from_numpy(xw), torch.from_numpy(whh), return_c=True)
    # h = o * tanh(c), with o recomputed from the previous h
    h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
    pre = torch.from_numpy(xw) + torch.matmul(h_prev, torch.from_numpy(whh))
    o = torch.sigmoid(pre[..., 12:])
    torch.testing.assert_close(h, o * torch.tanh(c), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_module_matches_jax(bidirectional):
    x = np.random.default_rng(3).standard_normal((3, 19, 6)).astype(np.float32)
    jmod = JLSTM(hidden_size=8, bidirectional=bidirectional, use_pallas=False)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = LSTM(6, 8, bidirectional=bidirectional)
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 19, 16 if bidirectional else 8)
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL)


def test_cpu_tensors_leave_launch_counters_at_zero():
    fused_transformer_block.launches = 0
    lstm_scan_packed.launches = 0
    x, variables = _block_case(64, 8, seed=3)
    block = _torch_block(64, 8, variables)
    with torch.no_grad():
        fused_transformer_block(torch.from_numpy(x), block.fused_params(), 8, 8.0)
        block(torch.from_numpy(x))
        xw, whh = _lstm_case(8, 2, 2, 4, seed=4)
        lstm_scan_packed(torch.from_numpy(xw), torch.from_numpy(whh))
        LSTM(5, 4, bidirectional=True)(torch.zeros(2, 8, 5))
    assert fused_transformer_block.launches == 0
    assert lstm_scan_packed.launches == 0


def test_fused_block_has_no_training_mode():
    """Without a drop rate the block has no training mode of its own:
    ``training=True`` draws no mask and is the eval block (the JAX kernel's
    ``_mask_cfg``).  Only a non-zero rate makes it drop."""
    x, variables = _block_case(16, 4, seed=4)
    block = _torch_block(16, 4, variables)
    xt, params = torch.from_numpy(x), block.fused_params()
    with torch.no_grad():
        ev = fused_transformer_block(xt, params, 4, 4.0)
        tr0 = fused_transformer_block(xt, params, 4, 4.0, training=True, seed=3)
        tr = fused_transformer_block(xt, params, 4, 4.0, training=True, seed=3,
                                     drop_p=0.5, ffn_drop_p=0.5)
    assert torch.equal(ev, tr0)
    assert float((ev - tr).abs().max()) > 1e-2


def test_block_kernel_window_limit():
    """No kernel keeps a whole sample in shared memory: the forward's attention
    takes one head's K and V (64 bytes a row), the backward's one head's query
    records and dQ beside a block per warp, which sets the limit, 1,699 rows.
    T=256 and T=320 (4 s and 5 s windows) pass; a longer window than the limit
    raises a ValueError that names it.  ``saved`` keeps its five planes, then
    the log-sum-exp."""
    assert attention_smem_bytes(192) == 12_288 and attention_smem_bytes(320) == 20_480
    assert attention_smem_bytes(193) == attention_smem_bytes(208)  # whole key tiles of 16
    assert attention_backward_smem_bytes(MAX_KERNEL_T) <= SMEM_OPTIN_BYTES
    assert attention_backward_smem_bytes(MAX_KERNEL_T + 1) > SMEM_OPTIN_BYTES
    assert attention_smem_bytes(MAX_KERNEL_T) <= SMEM_OPTIN_BYTES
    assert MAX_KERNEL_T == 1699
    assert saved_numel(128, 192, 64, 8) == 5 * 128 * 192 * 64 + 128 * 8 * 192
    params = [p.contiguous() for p in _torch_block(64, 8, _block_case(64, 8)[1]).fused_params()]
    for t in (1, 192, 218, 219, 256, 320, 640, MAX_KERNEL_T):
        _check_cuda_inputs(torch.zeros(1, t, 64), params, 8)
    with pytest.raises(ValueError, match=f"T <= {MAX_KERNEL_T}; T=1700"):
        _check_cuda_inputs(torch.zeros(1, 1700, 64), params, 8)


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither CPU nor CUDA (here: meta tensors): raise, never fall back."""
    x = torch.empty(2, 8, 64, device="meta")
    params = [torch.empty(1, device="meta")] * 16
    with pytest.raises(ValueError, match="device"):
        fused_transformer_block(x, params, 8, 8.0)
    with pytest.raises(ValueError, match="device"):
        lstm_scan_packed(torch.empty(8, 2, 2, 16, device="meta"),
                         torch.empty(2, 4, 16, device="meta"))
