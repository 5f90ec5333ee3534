"""Torch port, the redesigned forward of the fused block (kernel #1), on the CPU:

* the twin against JAX's interpret-mode ``fused_transformer_block`` and its
  VJP at a 4 s window (T=256), dropout on and off, and the masks bit for bit;
* the kernel's attention, an online softmax in base 2 over key tiles of 16,
  stated in plain torch (``attention_online_reference``) against the twin's
  softmax and against what the attention backward expects of the log-sum-exp;
* what the training forward saves (``fused_block_saved_reference``) in the
  layout the backward reads;
* the launch constants of ``csrc/fused_block.cu`` and the fragment layout and
  operand split of ``csrc/rowtile.cuh`` (split TF32 on the tensor cores), read
  from the sources and held to the card's limits and the Python side;
* the whole model at ``window_length_s=4`` against the JAX model.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.pallas_block import _dropout_mask
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch.ops import fused_block as port_block
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    ATTN_KEY_TILE,
    KERNEL_E,
    KERNEL_F,
    KERNEL_H,
    MAX_KERNEL_T,
    N_SAVED,
    SMEM_OPTIN_BYTES,
    DropoutConfig,
    attention_backward_reference,
    attention_online_reference,
    attention_smem_bytes,
    block_masks,
    fused_block_saved_reference,
    fused_transformer_block,
    fused_transformer_block_reference,
    pick_tile,
    saved_numel,
)
from transformer_clip_eeg_tpu_torch.serve import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

E, HEADS = 64, 8
JAX_TOL = 1e-4     # of max(1, max |JAX's value|): f32 sums of 64-256 terms in another order
ONLINE_TOL = 1e-5  # the same softmax, regrouped by key tile and in base 2
MODEL_ATOL = 1e-4  # as tests/test_torch_port_models.py
CSRC = Path(port_block.__file__).resolve().parent.parent / "csrc"
SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM; a CTA also reserves 1 KB
SM_REGISTERS = 65_536


def _err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


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


def _torch_params(variables):
    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    return [p.detach() for p in block.fused_params()]


# ---- the twin at a 4 s window against JAX's interpret mode ------------------------

@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_block_at_t256_matches_jax_interpret_forward_and_vjp(training):
    """B=2, T=256 (``--window_length_s 4``), E=64, 8 heads: the port's block is
    JAX's interpret-mode kernel, forward and VJP (dx and the 16 dparams), with
    dropout off and on (rates 0.5/0.5, the same seed, so the same masks)."""
    x, g, variables = _block_case(2, 256, seed=11)
    seed = 70_001
    out, vjp = jax.vjp(
        lambda xx, pp: j_fused(xx, pp, jnp.asarray(float(seed), jnp.float32), 0.5, 0.5,
                               HEADS, E ** 0.5, training, True),
        jnp.asarray(x), _jax_tuple(variables["params"]))
    jdx, jdparams = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        p.requires_grad_() for p in _torch_params(variables)]
    got = fused_transformer_block(leaves[0], leaves[1:], HEADS, E ** 0.5, training=training,
                                  seed=seed, drop_p=0.5, ffn_drop_p=0.5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert _err(got.detach().numpy(), out) <= JAX_TOL
    assert _err(grads[0].numpy(), jdx) <= JAX_TOL
    for i, (mine, theirs) in enumerate(zip(grads[1:], jdparams)):
        mine = mine.numpy()
        assert _err(mine.T if mine.ndim == 2 else mine, theirs) <= JAX_TOL, f"dparam {i}"


def test_block_masks_at_t256_equal_jax_interpret_bits():
    """The four masks of a batch tile at T=256, bit for bit: the attention
    mask of pair (t, j) is element (local T + t) T + j under key seed_base +
    h, the row masks are indexed (local T + t) width + column."""
    b, t, seed = 2, 256, 70_001
    tb = pick_tile(b)
    assert tb == 2
    drop = DropoutConfig(True, seed, 0.5, 0.25)
    attn, ao, fi, fo = block_masks(b, t, E, KERNEL_F, HEADS, drop)
    seed_base = jnp.asarray(np.int32((seed * 8191) % 2 ** 32 if (seed * 8191) % 2 ** 32 < 2 ** 31
                                     else (seed * 8191) % 2 ** 32 - 2 ** 32), jnp.int32)

    def jmask(mask_id, shape, p):
        return np.asarray(_dropout_mask(seed_base, mask_id, shape, p, use_prng=False))

    for h in (0, 3, HEADS - 1):
        np.testing.assert_array_equal(attn[:, h].numpy(), jmask(h, (tb, t, t), 0.5))
    np.testing.assert_array_equal(ao.numpy().reshape(tb * t, E), jmask(HEADS, (tb * t, E), 0.5))
    np.testing.assert_array_equal(fi.numpy().reshape(tb * t, KERNEL_F),
                                  jmask(HEADS + 1, (tb * t, KERNEL_F), 0.25))
    np.testing.assert_array_equal(fo.numpy().reshape(tb * t, E),
                                  jmask(HEADS + 2, (tb * t, E), 0.5))


# ---- the attention's online softmax -------------------------------------------------

def _attention_case(t, seed, drop_p):
    rng = np.random.default_rng(seed)
    b = 2
    q, k, v, dctx = (torch.from_numpy(rng.standard_normal((b, t, E)).astype(np.float32))
                     for _ in range(4))
    q = q * 3.0  # scores wide enough that the running max moves between tiles
    mask = None
    if drop_p:
        mask = block_masks(b, t, E, KERNEL_F, HEADS, DropoutConfig(True, 5 + t, drop_p, 0.0))[0]
    return q, k, v, dctx, mask


def _twin_attention(q, k, v, mask):
    b, t, _ = q.shape
    d = E // HEADS
    qh, kh, vh = (a.reshape(b, t, HEADS, d).transpose(1, 2) for a in (q, k, v))
    s = qh @ kh.transpose(2, 3) / E ** 0.5
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p * mask
    return (p @ vh).transpose(1, 2).reshape(b, t, E), torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("drop_p", [0.0, 0.5], ids=["eval", "dropout"])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 192, 256])
def test_online_softmax_matches_the_twins_attention(t, drop_p):
    """Key tiles of 16 with a running max and sum give the twin's softmax,
    context and log-sum-exp, ragged last tile included (T = 1, 31, 33): the
    sum normalises the clean probabilities, the context takes the dropped-out
    ones."""
    q, k, v, _, mask = _attention_case(t, seed=t, drop_p=drop_p)
    ctx, lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask)
    want_ctx, want_lse = _twin_attention(q, k, v, mask)
    assert ctx.shape == (2, t, E) and lse.shape == (2, HEADS, t)
    assert _err(ctx, want_ctx) <= ONLINE_TOL
    assert _err(lse, want_lse) <= ONLINE_TOL
    other, other_lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask, tile=32)
    assert _err(other, ctx) <= ONLINE_TOL and _err(other_lse, lse) <= ONLINE_TOL


@pytest.mark.parametrize("t", [33, 256])
def test_online_softmax_gives_the_backward_its_lse_and_context(t):
    """``attention_backward_reference`` rebuilds P from lse and takes
    ``rowsum(dP P) = dctx . ctx``: with the online softmax's lse and dropped-out
    context it gives autograd's dq, dk and dv through the twin's attention."""
    q, k, v, dctx, mask = _attention_case(t, seed=100 + t, drop_p=0.5)
    ctx, lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask)
    got = attention_backward_reference(q, k, v, ctx, lse, dctx, HEADS, E ** 0.5, mask)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(_twin_attention(*leaves, mask)[0], leaves, dctx)
    for name, mine, theirs in zip(("dq", "dk", "dv"), got, want):
        assert _err(mine, theirs) <= ONLINE_TOL, name


def test_saved_reference_is_the_backwards_layout():
    """Five [B, T, E] planes (q, k, v, the dropped-out context, x1), then lse
    [B, H, T]: x1's LayerNorm and FFN give the twin's output, and the
    attention planes are the online softmax's."""
    b, t = 3, 40
    x, _, variables = _block_case(b, t, seed=21)
    params = _torch_params(variables)
    drop = DropoutConfig(True, 77, 0.5, 0.5)
    xt = torch.from_numpy(x)
    saved = fused_block_saved_reference(xt, params, HEADS, E ** 0.5, drop)
    assert saved.shape == (saved_numel(b, t, E, HEADS),) and N_SAVED == 5
    q, k, v, ctx, x1 = saved[:5 * xt.numel()].reshape(5, b, t, E)
    lse = saved[5 * xt.numel():].reshape(b, HEADS, t)
    m_attn, _, m_fi, m_fo = block_masks(b, t, E, KERNEL_F, HEADS, drop)
    on_ctx, on_lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, m_attn)
    assert _err(on_ctx, ctx) <= ONLINE_TOL and _err(on_lse, lse) <= ONLINE_TOL
    g2, be2, w1, bb1, w2, bb2 = params[10:]
    y2 = torch.nn.functional.layer_norm(x1, (E,), g2, be2, 1e-5)
    f2 = torch.nn.functional.linear(
        torch.nn.functional.gelu(torch.nn.functional.linear(y2, w1, bb1)) * m_fi, w2, bb2)
    want = fused_transformer_block_reference(xt, params, HEADS, E ** 0.5, *drop)
    assert _err(x1 + f2 * m_fo, want) <= ONLINE_TOL


# ---- the launch constants of the sources ----------------------------------------------

def _constants(name: str, env=None) -> dict:
    """The ``constexpr int NAME = <integer expression>;`` lines of a source,
    evaluated in order on top of ``env``."""
    env = dict(env or {})
    text = (CSRC / name).read_text().replace("rowtile::", "")
    for key, expr in re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", text):
        try:
            env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
        except (NameError, SyntaxError):
            pass
    return env


def _forward_constants() -> dict:
    return _constants("fused_block.cu", _constants("rowtile.cuh", _constants("block_common.cuh")))


def test_forward_launch_constants_fit_the_card():
    """``csrc/fused_block.cu``: the row kernels' CTAs stay on their SMs and walk
    tiles of rows.  LN1+QKV: 32 rows a tile, 192 threads (a warp per 32 x 32
    of q, k or v), the three weight matrices staged once and two row buffers,
    three CTAs an SM.  The FFN kernel: 64 rows a tile, 512 threads, W1 and W2
    staged once, one CTA an SM inside 227 KB.  Every row in shared memory is
    padded by 4 floats; nothing there grows with T outside the attention."""
    c = _forward_constants()
    assert (c["E"], c["H"], c["F"], c["D"]) == (KERNEL_E, KERNEL_H, KERNEL_F, 8)
    assert (c["QRT"], c["RT"], c["QKV_NT"], c["FFN_NT"]) == (32, 64, 192, 512)
    assert c["QKV_NT"] // 32 == 3 * 64 // 32 and c["FFN_NT"] // 32 == (64 // 32) * (256 // 32)
    assert c["LDW"] == 68 and c["LDW2"] == 260 and c["PAD"] == 4
    qkv_bytes, ffn_bytes = 4 * c["QKV_SMEM_FLOATS"], 4 * c["FFN_SMEM_FLOATS"]
    assert qkv_bytes == 4 * (3 * 64 + 2 * 32) * 68 == 69_632
    assert ffn_bytes == 4 * (256 * 68 + 64 * 260 + 64 * 68 + 64 * 260) == 220_160
    assert ffn_bytes <= SMEM_OPTIN_BYTES
    assert c["QKV_CTAS_PER_SM"] == 3 and 3 * (qkv_bytes + 1024) <= SM_SMEM_BYTES
    text = (CSRC / "fused_block.cu").read_text()
    assert "__launch_bounds__(QKV_NT, QKV_CTAS_PER_SM)" in text
    assert "__launch_bounds__(FFN_NT, 1)" in text
    assert SM_REGISTERS // (3 * c["QKV_NT"]) >= 112 and SM_REGISTERS // c["FFN_NT"] >= 128
    assert max(c["QKV_NT"], c["FFN_NT"], c["ATT_NT"]) <= 1024
    # the flagship's 24,576 rows: two tiles for each of LN1+QKV's 396 CTAs, three for
    # each of the FFN kernel's 132
    rows = 128 * 192
    assert 1.9 < (rows / c["QRT"]) / (3 * 132) <= 2 and 2.9 < (rows / c["RT"]) / 132 <= 3


@pytest.mark.parametrize("t", [192, 256, 320, MAX_KERNEL_T])
def test_forward_attention_constants_match_the_python_side(t):
    c = _forward_constants()
    assert c["KT"] == ATTN_KEY_TILE == 16 and c["ATT_NT"] == 256
    padded = -(-t // c["KT"]) * c["KT"]
    assert attention_smem_bytes(t) == 2 * padded * c["D"] * 4 <= SMEM_OPTIN_BYTES
    text = (CSRC / "fused_block.cu").read_text()
    assert re.search(r"return 2 \* \(size_t\)\(\(T \+ KT - 1\) / KT \* KT\) \* D \* sizeof\(float\);",
                     text)
    assert c["NQ"] == 2 and re.search(
        r"const int nt = 32 \* \(\(T \+ 32 \* NQ - 1\) / \(32 \* NQ\)\);", text)
    threads = min(32 * -(-t // 64), c["ATT_NT"])
    assert threads % 32 == 0 and (2 * threads >= t or threads == c["ATT_NT"])
    if t == 192:  # 1,024 CTAs of 3 warps: eight of them fit an SM's shared memory with room
        assert threads == 96 and 8 * (attention_smem_bytes(t) + 1024) <= SM_SMEM_BYTES


def test_row_tile_fragments_are_conflict_free_and_cover_a_block():
    """``csrc/rowtile.cuh``: split TF32 on ``mma.sync`` m16n8k8, three products a
    block.  Lane 4 g + t reads rows g and g + 8 at columns t and t + 4 of its
    block: with rows of K + 4 floats (K = 64 or 256) the 32 lanes hit 32
    different banks; the four sums a lane holds tile the 16 x 8 block once."""
    text = (CSRC / "rowtile.cuh").read_text()
    pad = _constants("rowtile.cuh")["PAD"]
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert text.count("mma_tf32(acc[mi][ni],") == 3  # lo*hi, hi*lo, hi*hi
    assert "hi = __float_as_uint(x) & 0xffffe000u;" in text  # 10 explicit mantissa bits kept
    assert "return 16 * mi + (lane >> 2) + 8 * half;" in text
    assert "return 8 * ni + 2 * (lane & 3);" in text
    for k in (64, 256):
        for row_off, col_off in ((0, 0), (8, 0), (0, 4), (8, 4)):
            banks = {((lane >> 2) + row_off) * (k + pad) % 32 + (lane & 3) + col_off
                     for lane in range(32)}
            assert len({b % 32 for b in banks}) == 32
    cells = sorted((((lane >> 2) + 8 * half), 2 * (lane & 3) + c)
                   for lane in range(32) for half in range(2) for c in range(2))
    assert cells == [(r, n) for r in range(16) for n in range(8)]
    # the split is exact and what the tensor core drops of lo is below 2^-20 of x
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = x - hi
    assert np.array_equal(hi + lo, x)
    lo_tc = (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    assert float((np.abs(hi + lo_tc - x) / np.abs(x)).max()) < 2.0 ** -20
    assert float((np.abs(lo) / np.abs(x)).max()) < 2.0 ** -10


@pytest.mark.parametrize("name", ["fused_block.cu", "rowtile.cuh", "cp_async.cuh"])
def test_no_atomics_in_the_forward_sources(name):
    assert not re.search(r"atomic[A-Z]|\bred\.|\batom\.", (CSRC / name).read_text())


# ---- the whole model at a 4 s window ---------------------------------------------------

@pytest.mark.parametrize("method", ["encode_eeg", "encode_speech"])
def test_whole_model_at_window_length_4s_matches_jax(method):
    """``window_length_s=4`` at 64 Hz (T=256, the window the old kernel
    refused), two blocks deep, dropout off: the port's encoders against the
    JAX model holding the same weights."""
    small = dict(window_length_s=4, attention_depth=2, latent_dim=4, speech_dim_override=32)
    jcfg, tcfg = JConfig(**small), TrainConfig(**small)
    assert tcfg.window_length == jcfg.window_length == 256
    jmodel = j_build(jcfg, bank_size=16)
    rng = np.random.default_rng(6)
    eeg = rng.standard_normal((2, 256, 64)).astype(np.float32)
    speech = rng.standard_normal((2, 256, 32)).astype(np.float32)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), eeg, speech, np.arange(1, 3, dtype=np.int32))))
    tmodel = build_model_from_config(tcfg, 16, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    x = eeg if method == "encode_eeg" else speech
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=getattr(jmodel, method)))
    with torch.no_grad():
        got = getattr(tmodel, method)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 256, 4)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
