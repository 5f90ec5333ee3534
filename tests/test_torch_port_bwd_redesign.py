"""Torch port, the identities the redesigned backward kernels (#2, the fused
block's, and #6, the conv block's) rest on, in plain torch on the CPU:

* the attention backward computed once per (query, key) pair, from
  ``delta = rowsum(dctx * ctx)`` and ``P = exp(S - lse)``
  (``attention_backward_reference``), and the whole block's backward written
  formula by formula (``fused_block_backward_reference``), against autograd
  through the twin and against JAX's interpret-mode ``_fused_block_bwd`` VJP;
* the conv block's dW as one (tap, channel) x channel product over sliding
  rows (``conv_dw_reference``) and its whole backward
  (``fused_conv_backward_reference``), against autograd through the twin and
  against JAX's interpret-mode ``fused_basic_block`` VJP;
* the launch constants of ``csrc/wgrad.cuh`` and of the kernels built on it,
  read from the sources and held to the card's limits and to the Python side.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused_block
from transformer_clip_eeg_tpu.ops.pallas_conv import fused_basic_block as j_fused_conv
from transformer_clip_eeg_tpu_torch.ops import fused_block as port_block
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    KERNEL_E,
    KERNEL_F,
    KERNEL_H,
    MAX_KERNEL_T,
    N_SAVED,
    SMEM_OPTIN_BYTES,
    DropoutConfig,
    attention_backward_reference,
    block_masks,
    fused_block_backward_reference,
    fused_transformer_block_reference,
    saved_numel,
)
from transformer_clip_eeg_tpu_torch.ops.fused_conv import (
    MAX_KERNEL_K,
    conv_dw_reference,
    fused_basic_block_reference,
    fused_conv_backward_reference,
    max_kernel_t,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

T, E, HEADS = 32, 16, 4
TWIN_TOL = 1e-5  # of max(1, max |autograd's gradient|): the same f32 sums, regrouped
JAX_TOL = 1e-4   # of max(1, max |JAX's gradient|), as the VJP tests of the kernels' twins
CSRC = Path(port_block.__file__).resolve().parent.parent / "csrc"
SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM; a CTA also reserves 1 KB


def _err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


# ---- kernel #2 ----------------------------------------------------------------

def _block_case(b, seed):
    """x, an upstream gradient and a JAX block's variables (LayerNorms
    perturbed), from numpy."""
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


def _port_params(variables):
    block = TransformerEncoderBlock(E, num_heads=HEADS)
    block.load_state_dict(state_dict_from_jax(variables, block))
    return [p.detach() for p in block.fused_params()]


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


DROPS = [DropoutConfig(), DropoutConfig(True, 31337, 0.5, 0.5), DropoutConfig(True, 7, 0.3, 0.0)]
DROP_IDS = ["eval", "drop0.5", "attn-only0.3"]


@pytest.mark.parametrize("drop", DROPS, ids=DROP_IDS)
@pytest.mark.parametrize("b", [4, 6, 5], ids=["tile4", "tile2", "tile1"])
def test_attention_backward_single_pass_matches_autograd(b, drop):
    """dq, dk, dv from ``delta = rowsum(dctx * ctx)`` and ``P = exp(S - lse)``
    equal autograd through the softmax attention with the same mask."""
    rng = np.random.default_rng(100 + b)
    q, k, v, dctx = (torch.from_numpy(rng.standard_normal((b, T, E)).astype(np.float32))
                     for _ in range(4))
    mask = block_masks(b, T, E, 4 * E, HEADS, drop)[0]
    d = E // HEADS
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    qh, kh, vh = (a.reshape(b, T, HEADS, d).transpose(1, 2) for a in leaves)
    s = qh @ kh.transpose(2, 3) * (1.0 / E ** 0.5)
    p = torch.softmax(s, dim=-1)
    ctx = ((p if mask is None else p * mask) @ vh).transpose(1, 2).reshape(b, T, E)
    want = torch.autograd.grad(ctx, leaves, dctx)
    lse = torch.logsumexp(s.detach(), dim=-1)
    got = attention_backward_reference(q, k, v, ctx.detach(), lse, dctx, HEADS, E ** 0.5, mask)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (b, T, E)
        assert _err(a, w) <= TWIN_TOL, (name, _err(a, w))


@pytest.mark.parametrize("drop", DROPS, ids=DROP_IDS)
@pytest.mark.parametrize("b", [8, 6, 3], ids=["tile8", "tile2", "tile1"])
def test_block_backward_formulas_match_autograd_through_the_twin(b, drop):
    """The backward as kernel #2 computes it (one pass over the attention
    pairs, column sums for the biases, A^T B for the weights) against autograd
    through ``fused_transformer_block_reference``: dx and the 16 dparams."""
    x, g, variables = _block_case(b, seed=20 + b)
    params = _port_params(variables)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    leaves = [xt.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    out = fused_transformer_block_reference(leaves[0], leaves[1:], HEADS, E ** 0.5, *drop)
    want = torch.autograd.grad(out, leaves, gt)
    dx, dparams = fused_block_backward_reference(xt, params, gt, HEADS, E ** 0.5, drop)
    for i, (a, w) in enumerate(zip((dx, *dparams), want)):
        assert a.shape == w.shape
        assert _err(a, w) <= TWIN_TOL, (i, _err(a, w))


@pytest.mark.parametrize("b", [8, 6], ids=["tile8", "tile2"])
def test_block_backward_formulas_match_jax_interpret_vjp(b):
    """The same formulas, dropout on, against the VJP of JAX's interpret-mode
    kernel (``_fused_block_bwd``): the same seed draws the same masks."""
    x, g, variables = _block_case(b, seed=40 + b)
    seed = 50_000 + b
    _, vjp = jax.vjp(
        lambda xx, pp: j_fused_block(xx, pp, jnp.asarray(float(seed), jnp.float32), 0.5, 0.5,
                                     HEADS, E ** 0.5, True, True),
        jnp.asarray(x), _jax_tuple(variables["params"]))
    jdx, jdparams = vjp(jnp.asarray(g))
    dx, dparams = fused_block_backward_reference(
        torch.from_numpy(x), _port_params(variables), torch.from_numpy(g), HEADS, E ** 0.5,
        DropoutConfig(True, seed, 0.5, 0.5))
    assert _err(dx, jdx) <= JAX_TOL
    for i, (mine, theirs) in enumerate(zip(dparams, jdparams)):
        mine = mine.numpy()
        err = _err(mine.T if mine.ndim == 2 else mine, theirs)
        assert err <= JAX_TOL, (i, err)


def test_saved_tensor_holds_five_planes_and_the_log_sum_exp():
    b, t = 3, 50
    assert N_SAVED == 5
    assert saved_numel(b, t, KERNEL_E, KERNEL_H) == 5 * b * t * KERNEL_E + b * KERNEL_H * t
    # the log-sum-exp starts on a 16-byte boundary for any B and T
    assert (N_SAVED * b * t * KERNEL_E) % 4 == 0


# ---- kernel #6 ----------------------------------------------------------------

C = 16
CONV_DROP = DropoutConfig(True, 4321, 0.3)


def _conv_case(b, t, k, seed):
    rng = np.random.default_rng(seed)
    lim = 1.0 / np.sqrt(C * k)
    x = rng.standard_normal((b, t, C)).astype(np.float32)
    w = rng.uniform(-lim, lim, (k, C, C)).astype(np.float32)  # JAX's [K, C_in, C_out]
    bb = rng.uniform(-lim, lim, C).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal((t, C))).astype(np.float32)
    bias = (0.2 * rng.standard_normal((t, C))).astype(np.float32)
    g = rng.standard_normal((b, t, C)).astype(np.float32)
    return x, w, bb, scale, bias, g


def _conv_torch(x, w, bb, scale, bias, g):
    """The port's arguments: w in torch's Conv1d layout [C_out, C_in, K]."""
    return [torch.from_numpy(np.ascontiguousarray(v))
            for v in (x, w.transpose(2, 1, 0), bb, scale, bias, g)]


@pytest.mark.parametrize("k", [1, 2, 31, 32, 64])
def test_conv_dw_as_one_sliding_product_matches_autograd(k):
    """dW = A^T dconv with A's rows the (tap, channel) windows of the padded
    x, against autograd's gradient of the convolution's weight, for odd and
    even K (the two paddings differ) up to the kernels' K=64."""
    rng = np.random.default_rng(k)
    b, t = 3, 40
    x = torch.from_numpy(rng.standard_normal((b, t, C)).astype(np.float32))
    dconv = torch.from_numpy(rng.standard_normal((b, t, C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((C, C, k)).astype(np.float32)).requires_grad_()
    lo = (k - 1) // 2
    conv = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.transpose(1, 2), (lo, k - 1 - lo)), w).transpose(1, 2)
    (want,) = torch.autograd.grad(conv, w, dconv)
    got = conv_dw_reference(x, dconv, k)
    assert got.shape == (C, C, k)
    assert _err(got, want) <= TWIN_TOL


@pytest.mark.parametrize("drop", [DropoutConfig(), CONV_DROP], ids=["eval", "dropout"])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 64])
def test_conv_backward_formulas_match_autograd_through_the_twin(k, drop):
    """The backward as kernel #6 computes it (the elementwise chain, per-sample
    sums, the sliding product, dx by the flipped kernel) against autograd
    through ``fused_basic_block_reference``: dx, dw, db, dscale, dbias."""
    args = _conv_torch(*_conv_case(5, 40, k, seed=200 + k))
    g = args.pop()
    leaves = [v.clone().requires_grad_() for v in args]
    out = fused_basic_block_reference(*leaves, drop.seed, k, drop.drop_p, drop.training)
    want = torch.autograd.grad(out, leaves, g)
    got = fused_conv_backward_reference(*args, g, drop)
    for name, a, w in zip(("dx", "dw", "db", "dscale", "dbias"), got, want):
        assert a.shape == w.shape
        assert _err(a, w) <= TWIN_TOL, (name, _err(a, w))


@pytest.mark.parametrize("b,k", [(4, 12), (6, 7)], ids=["B4K12", "B6K7"])
def test_conv_backward_formulas_match_jax_interpret_vjp(b, k):
    """The same formulas, dropout on, against the VJP of JAX's interpret-mode
    ``fused_basic_block`` (``_fbb_bwd``)."""
    x, w, bb, scale, bias, g = _conv_case(b, T, k, seed=300 + k)
    seed = 3_000_017 + b
    _, vjp = jax.vjp(
        lambda *a: j_fused_conv(*a, jnp.asarray(float(seed), jnp.float32), k, 0.3, True, True),
        *map(jnp.asarray, (x, w, bb, scale, bias)))
    jdx, jdw, jdb, jdscale, jdbias = vjp(jnp.asarray(g))
    args = _conv_torch(x, w, bb, scale, bias, g)
    dx, dw, db, dscale, dbias = fused_conv_backward_reference(
        *args, DropoutConfig(True, seed, 0.3))
    for name, mine, theirs in (("dx", dx, jdx), ("dw", dw.permute(2, 1, 0), jdw),
                               ("db", db, jdb), ("dscale", dscale, jdscale),
                               ("dbias", dbias, jdbias)):
        assert _err(mine.numpy(), theirs) <= JAX_TOL, (name, _err(mine.numpy(), theirs))


# ---- the launch constants of the sources ----------------------------------------

def _constants(name: str) -> dict:
    """The ``constexpr int NAME = <integer expression>;`` lines of a source,
    evaluated in order (earlier names, + - * /, no casts)."""
    env = {}
    text = (CSRC / name).read_text()
    for key, expr in re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", text):
        try:
            env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
        except (NameError, SyntaxError):
            pass  # names of another header
    return env


def test_wgrad_tile_constants_fit_the_card():
    """The tile of ``csrc/wgrad.cuh``: 4 groups of 64 threads with 8 x 8 sums
    each over a 64 x 64 tile, a ring of at least two stages of 16-byte
    copies, the groups' tiles inside the ring, and two CTAs on one SM."""
    c = _constants("wgrad.cuh")
    assert (c["TILE"], c["NT"], c["KG"]) == (64, 256, 4)
    assert c["NT"] == c["KG"] * (c["TILE"] // 8) ** 2
    assert c["STAGES"] >= 2 and c["KT"] % c["KG"] == 0
    assert c["KT"] * c["TILE"] // 4 == 2 * c["NT"]  # two 16-byte copies per operand a thread
    assert c["SMEM_BYTES"] == c["STAGES"] * 2 * c["KT"] * c["TILE"] * 4
    assert c["KG"] * c["TILE"] * c["TILE"] * 4 <= c["SMEM_BYTES"] <= SMEM_OPTIN_BYTES
    assert 2 * (c["SMEM_BYTES"] + 1024) <= SM_SMEM_BYTES
    assert c["KC"] % c["KT"] == 0
    assert c["NT"] == c["SUM_COLS"] * c["SUM_WAYS"]


def test_wgrad_fills_the_card_at_the_flagship_shape():
    """A 64 x 64 product over the block's 24,576 rows alone is at least a
    quarter wave of resident CTAs, and kernel #2's six products, one launch,
    are more than two waves of 2 CTAs on each of 132 SMs."""
    c = _constants("wgrad.cuh")
    rows = 128 * 192
    chunks = -(-rows // c["KC"])
    tiles = 2 * (KERNEL_F // c["TILE"]) + 4  # dW2 and dW1, then four E x E
    assert chunks >= 64
    assert chunks * tiles >= 2 * 2 * 132
    assert c["MAX_JOBS"] >= 6 and c["MAX_SUMS"] >= 6 + 10  # #2's products and sums


def test_block_backward_constants_match_the_python_side():
    """``csrc/fused_block_bwd.cu`` at the widths ``ops/fused_block.py`` checks:
    a query's record is q, dctx, lse and delta in whole float4s; the attention
    backward's shared memory (the records, dQ, and a dS block and a key tile
    per warp, one warp per tile of 32 keys) does not tighten the forward's
    window limit, at four CTAs an SM at T=192."""
    common = _constants("block_common.cuh")
    assert (common["E"], common["H"], common["F"]) == (KERNEL_E, KERNEL_H, KERNEL_F)
    text = (CSRC / "fused_block_bwd.cu").read_text()
    c = _constants("fused_block_bwd.cu")
    d = KERNEL_E // KERNEL_H
    assert re.search(r"constexpr int QS = 2 \* D \+ 4;", text)
    assert re.search(r"constexpr int DSS = KEYS \+ 1;", text)
    assert re.search(r"constexpr int WARP_FLOATS = KEYS \* DSS \+ KEYS \* D \+ 4;", text)
    assert (c["KEYS"], c["NT"]) == (32, 256)  # one key a lane, at most 8 warps
    assert re.search(r"return \(size_t\)T \* QS \+ \(size_t\)T \* D \+ "
                     r"\(size_t\)\(attn_threads\(T\) / 32\) \* WARP_FLOATS;", text)

    def attn_smem(t):
        keys = c["KEYS"]
        warps = min(-(-t // keys), c["NT"] // 32)
        return 4 * (t * (2 * d + 4) + t * d + warps * (keys * (keys + 1) + keys * d + 4))

    assert attn_smem(MAX_KERNEL_T) <= SMEM_OPTIN_BYTES
    assert 4 * (attn_smem(192) + 1024) <= SM_SMEM_BYTES
    # the row kernels' column sums: four E-wide and one F-wide, then five E-wide
    assert re.search(r"constexpr int FFN_SUMS = 4 \* E \+ F;", text)
    assert re.search(r"constexpr int QKV_SUMS = 5 \* E;", text)
    assert text.count("plan.add_product(") == 6


def test_conv_backward_constants_fit_the_card_and_the_wrappers_limits():
    """``csrc/fused_conv_bwd.cu``: 4 taps a CTA (one per group of 64 threads),
    stages of 32 dconv rows and the 35 x rows they meet, the ring at two CTAs
    an SM; every K the wrapper admits and the longest window at K=64 need no
    more than the stage holds (a stage never spans samples)."""
    c = _constants("wgrad.cuh")
    text = (CSRC / "fused_conv_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    kt, taps, stages = const("DW_KT"), const("DW_TAPS"), const("DW_STAGES")
    assert taps * 64 == c["NT"] and stages >= 2
    smem = stages * (kt + kt + taps - 1) * 64 * 4
    assert re.search(r"DW_SMEM_BYTES = DW_STAGES \* DW_STAGE_FLOATS \* 4;", text)
    assert const("DW_CTAS_PER_SM") * (smem + 1024) <= SM_SMEM_BYTES
    assert MAX_KERNEL_K == _constants("conv_common.cuh")["MAX_K"] == 64
    assert max_kernel_t(MAX_KERNEL_K) == 345
    assert "upad" not in text


@pytest.mark.parametrize("name", ["wgrad.cuh", "fused_block_bwd.cu", "fused_conv_bwd.cu"])
def test_no_atomics_in_the_fixed_order_sources(name):
    assert not re.search(r"atomic[A-Z]|\bred\.|\batom\.", (CSRC / name).read_text())
