"""Torch port, the bf16 mode's attentions on the tensor cores (kernels #1 and
#2 under ``--compute_dtype bfloat16``), on the CPU:

* the bf16 twin's two-pass attention at the kernel's key step (32 keys; a
  warp's 16 queries change no number, each row is walked alone), built into
  the block, against JAX's interpret-mode ``fused_transformer_block(...,
  mm_dtype='bfloat16')`` at ragged windows, dropout off and on;
* the launch plan of the bf16 attentions (:func:`bf16_attention_plan`)
  against the constants and formulas of ``csrc/fused_block.cu`` and
  ``csrc/fused_block_bwd.cu`` up to the longest window, and its refusal past
  it;
* the fragment layouts the kernels rest on, stated in numpy from PTX's
  definitions of ``mma.sync`` and ``movmatrix``: two adjacent m16n8k8
  accumulators are one m16n8k16 A operand, and the backward's dQ operand is
  dS^T's four 8 x 8 blocks transposed;
* the shared-memory rows of the bf16 kernels: ``ldmatrix`` reads and the
  weight-gradient product's fragment loads free of bank conflicts.

Limits: block out within 8e-3 of max |JAX| (two bf16 units: both sides round
the same operands and sum in float32 in another order); the walk's context
within 8e-3 of the twin's and its log-sum-exp within 1e-5 (f32 sums
regrouped).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu.ops.attention import TransformerEncoderBlock as JBlock
from transformer_clip_eeg_tpu.ops.pallas_block import fused_transformer_block as j_fused
from transformer_clip_eeg_tpu_torch.ops import fused_block as port_block
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    BF16_ATTN_WARPS,
    BF16_KEY_TILE,
    BF16_QUERY_TILE,
    KERNEL_E,
    KERNEL_H,
    MAX_KERNEL_T,
    N_SAVED,
    SMEM_OPTIN_BYTES,
    DropoutConfig,
    attention_backward_smem_bytes,
    attention_online_reference,
    attention_smem_bytes,
    bf16_attention_plan,
    bf16_round,
    block_masks,
    fused_block_saved_reference,
    fused_transformer_block_reference,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

E, HEADS = 64, 8
OUT_TOL = 8e-3   # bf16 outputs: two bf16 units of max |ref|
TWIN_TOL = 8e-3  # the walk's context against the twin's: the same roundings, regrouped
LSE_TOL = 1e-5   # the log-sum-exp: f32 sums regrouped
CSRC = Path(port_block.__file__).resolve().parent.parent / "csrc"


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
    # the input is bf16 in the bf16 mode: round it once, for both sides
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, {"params": params}


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


def _block_through_the_walk(xb, params, drop):
    """The bf16 block with its attention replaced by the kernel's walk
    (``attention_online_reference(..., tile=BF16_KEY_TILE, bf16=True)``) on
    the q, k and v the bf16 forward saves; the rest as the twin computes it.
    Returns (out, the walk's ctx and lse, the twin's saved ctx and lse)."""
    (_, _, _, _, _, _, _, _, wo, bo, g2, be2, w1, bb1, w2, bb2) = params
    b, t, e = xb.shape
    r = bf16_round
    saved = fused_block_saved_reference(xb, params, HEADS, E ** 0.5, drop)
    q, k, v, ctx_twin, _ = saved[:N_SAVED * xb.numel()].reshape(N_SAVED, b, t, e)
    lse_twin = saved[N_SAVED * xb.numel():].reshape(b, HEADS, t)
    m_attn, m_ao, m_fi, m_fo = block_masks(b, t, e, w1.shape[0], HEADS, drop)
    ctx, lse = attention_online_reference(q, k, v, HEADS, E ** 0.5, m_attn,
                                          tile=BF16_KEY_TILE, bf16=True)
    a = F.linear(ctx, r(wo), bo)
    if m_ao is not None:
        a = a * m_ao
    x1 = xb.float() + a
    gl = F.gelu(F.linear(r(F.layer_norm(x1, (e,), g2, be2, 1e-5)), r(w1), bb1))
    if m_fi is not None:
        gl = gl * m_fi
    f2 = F.linear(r(gl), r(w2), bb2)
    if m_fo is not None:
        f2 = f2 * m_fo
    return (x1 + f2).to(torch.bfloat16), (ctx, lse), (ctx_twin, lse_twin)


# (B, T): a partial query tile and key step; a window of 200 (6 key steps and
# a quarter, 12 query tiles and a half, batch 1); 48 fills its query tiles
# but not its last key step
WALK_CASES = [(2, 33), (1, 200), (2, 48)]


@pytest.mark.parametrize("b,t", WALK_CASES, ids=[f"B{b}T{t}" for b, t in WALK_CASES])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_two_pass_walk_at_the_kernels_key_step_gives_jaxs_bf16_block(b, t, training):
    """The bf16 attention as ``attn_fwd_bf16_kernel`` walks it (pass 1 over
    steps of 32 keys for each row's max and sum, pass 2 for the context from
    the normalised, dropped-out probabilities rounded to bf16), inside the
    bf16 block, against JAX's interpret-mode kernel with
    ``mm_dtype='bfloat16'``; the walk's context and log-sum-exp against what
    the twin saves."""
    x, variables = _block_case(b, t, seed=300 + t)
    seed = 2_024
    drop = DropoutConfig(training, seed, 0.5, 0.5)
    want = j_fused(jnp.asarray(x, jnp.bfloat16), _jax_tuple(variables["params"]),
                   jnp.asarray(float(seed), jnp.float32), 0.5, 0.5, HEADS, E ** 0.5,
                   training, True, "bfloat16")
    assert want.dtype == jnp.bfloat16
    out, (ctx, lse), (ctx_twin, lse_twin) = _block_through_the_walk(
        torch.tensor(x).to(torch.bfloat16), _torch_params(variables), drop)
    assert _rel(out.float().numpy(), np.asarray(want, np.float32)) <= OUT_TOL
    assert _rel(ctx.numpy(), ctx_twin.numpy()) <= TWIN_TOL
    assert torch.equal(ctx, bf16_round(ctx))
    torch.testing.assert_close(lse, lse_twin, atol=LSE_TOL, rtol=LSE_TOL)


def test_the_walk_does_not_depend_on_the_key_step():
    """Pass 1 regroups only f32 sums: the kernel's step of 32 keys and the
    twin's default of 16 give the same context within the limits (the
    probabilities agree to f32 rounding, so their bf16 roundings flip rarely)."""
    rng = np.random.default_rng(7)
    b, t = 2, 77
    q, k, v = (bf16_round(torch.from_numpy(rng.standard_normal((b, t, E)).astype(np.float32)))
               for _ in range(3))
    mask = block_masks(b, t, E, 4 * E, HEADS, DropoutConfig(True, 3, 0.5, 0.0))[0]
    ctx32, lse32 = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask,
                                              tile=BF16_KEY_TILE, bf16=True)
    ctx16, lse16 = attention_online_reference(q, k, v, HEADS, E ** 0.5, mask, bf16=True)
    assert _rel(ctx32.numpy(), ctx16.numpy()) <= TWIN_TOL
    torch.testing.assert_close(lse32, lse16, atol=LSE_TOL, rtol=LSE_TOL)


# ---- the launch plan against the sources ------------------------------------------

def _constants(*names) -> dict:
    """The ``constexpr int NAME = <integer expression>;`` lines of the
    sources, evaluated in order (namespaces stripped)."""
    env = {}
    for name in names:
        text = (CSRC / name).read_text().replace("rowtile::", "")
        for key, expr in re.findall(r"constexpr (?:int|size_t) (\w+) = ([^;]+);", text):
            try:
                env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
            except (NameError, SyntaxError):
                pass
    return env


def _function(name: str, source: str) -> str:
    """The body of the host function ``name`` in ``source``."""
    text = (CSRC / source).read_text()
    start = text.index(f"{name}(int T) {{")
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("t", [1, 16, 33, 48, 192, 200, 256, 320, 1000, MAX_KERNEL_T])
def test_bf16_attention_plan_is_the_kernels(t):
    """Threads and shared memory of both bf16 attentions: the tiles, the
    warp caps and the formulas of the sources, whole warps, at most 8 of
    them, every query tile and key covered, inside 227 KB."""
    fwd = _constants("block_common.cuh", "rowtile.cuh", "fused_block.cu")
    bwd = _constants("block_common.cuh", "rowtile.cuh", "fused_block_bwd.cu")
    assert (fwd["BQT"], fwd["BKT"], fwd["BATT_WARPS"]) == (
        BF16_QUERY_TILE, BF16_KEY_TILE, BF16_ATTN_WARPS) == (16, 32, 8)
    assert bwd["BK"] == BF16_KEY_TILE and bwd["NT"] // 32 == BF16_ATTN_WARPS
    assert "const int rounds = (tiles + BATT_WARPS - 1) / BATT_WARPS;" in _function(
        "attn_bf16_threads", "fused_block.cu")
    assert "return 2 * (size_t)((T + BKT - 1) / BKT * BKT) * D * sizeof(rowtile::bf16_t);" in \
        _function("attn_bf16_smem_bytes", "fused_block.cu")
    assert "return (size_t)((T + BK - 1) / BK * BK) * (D * 4 + 8 + 2 * D * 2);" in _function(
        "attn_bf16_smem_bytes", "fused_block_bwd.cu")
    plan = bf16_attention_plan(t)
    d = KERNEL_E // KERNEL_H
    padded = -(-t // 32) * 32
    tiles = -(-t // 16)
    warps = plan.fwd_threads // 32
    assert plan.fwd_threads % 32 == 0 and 1 <= warps <= 8
    assert warps * -(-tiles // warps) >= tiles and warps * (-(-tiles // 8)) >= tiles
    assert plan.fwd_smem_bytes == 2 * padded * d * 2 == attention_smem_bytes(t, bf16=True)
    assert plan.bwd_threads == 32 * min(padded // 32, 8)
    assert plan.bwd_smem_bytes == padded * (4 * d + 8 + 4 * d)
    assert max(plan.fwd_smem_bytes, plan.bwd_smem_bytes) <= SMEM_OPTIN_BYTES
    # the bf16 backward's records are smaller than the f32 one's: the window
    # limit stays the f32 backward's
    assert plan.bwd_smem_bytes < attention_backward_smem_bytes(t)


@pytest.mark.parametrize("t", [0, MAX_KERNEL_T + 1, 4096])
def test_bf16_attention_plan_refuses_other_windows(t):
    with pytest.raises(ValueError, match=f"1 to {MAX_KERNEL_T} rows, got T={t}"):
        bf16_attention_plan(t)


# ---- the fragment layouts (PTX ISA, mma.sync and movmatrix) ------------------------

def _c_frag(m16n8):
    """The accumulator of an m16n8 product as the lanes hold it: lane 4 g + t
    has rows g, g + 8 at columns 2 t, 2 t + 1: [32][4]."""
    return np.array([[m16n8[g + 8 * (c >> 1), 2 * t + (c & 1)] for c in range(4)]
                     for g in range(8) for t in range(4)])


def _a16_frag(m16k16):
    """The A operand of m16n8k16 as the lanes hold it: a0..a3 at (g, 2t),
    (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8), two values each: [32][4][2]."""
    return np.array([[[m16k16[g + 8 * (i & 1), 2 * t + 8 * (i >> 1) + j] for j in range(2)]
                      for i in range(4)] for g in range(8) for t in range(4)])


def _pack(c, i, j):
    """The register holding accumulator values i, j of each lane."""
    return np.stack([c[:, i], c[:, j]], axis=-1)


def _movm_trans(reg):
    """movmatrix.trans: the 8 x 8 matrix whose row g, columns 2t, 2t + 1 lane
    4 g + t holds, transposed, in the same layout: [32][2]."""
    mat = np.empty((8, 8))
    for lane in range(32):
        mat[lane >> 2, 2 * (lane & 3):2 * (lane & 3) + 2] = reg[lane]
    return np.array([[mat.T[lane >> 2, 2 * (lane & 3) + j] for j in range(2)]
                     for lane in range(32)])


def test_two_8_key_accumulators_are_one_16_key_operand():
    """The forward's pass 2 and the backward pack p (and dS^T) straight from
    the accumulators of two 8-wide blocks: pa[2 nbi + hh] = (c[2 hh],
    c[2 hh + 1]) of block nbi is the m16n8k16 A operand of the 16 x 16
    matrix the two blocks make."""
    full = np.arange(256.0).reshape(16, 16)
    c = [_c_frag(full[:, 8 * nb:8 * nb + 8]) for nb in range(2)]
    packed = np.stack([_pack(c[nbi], 2 * hh, 2 * hh + 1)
                       for nbi in range(2) for hh in range(2)], axis=1)
    assert np.array_equal(packed, _a16_frag(full))


def test_dq_operand_is_ds_transposed_block_by_block():
    """attn_bwd_bf16_kernel holds dS^T (16 keys x 16 queries) as the A operand
    da[0..3] of dK = dS^T Q; dQ = dS K takes {movm(da[0]), movm(da[2]),
    movm(da[1]), movm(da[3])} as its A operand, which must be dS's."""
    ds_t = np.arange(256.0).reshape(16, 16)  # [key][query]
    da = _a16_frag(ds_t)
    text = (CSRC / "fused_block_bwd.cu").read_text()
    order = [int(i) for i in re.findall(r"movm_trans\(da\[mt\]\[(\d)\]\)", text)]
    assert order == [0, 2, 1, 3]
    got = np.stack([_movm_trans(da[:, i]) for i in order], axis=1)
    assert np.array_equal(got, _a16_frag(ds_t.T))


# ---- shared-memory layouts of the bf16 kernels --------------------------------------

@pytest.mark.parametrize("row", ["LDE", "LDF", "LD3"])
def test_bf16_rows_put_a_matrix_in_eight_bank_groups(row):
    """``ldmatrix`` reads 8 rows of 16 bytes for each 8 x 8 matrix: with rows
    of E, F or 3E bf16 values padded by BPAD (16 bytes) the 8 rows of a
    matrix start in 8 different 16-byte groups of the 128-byte bank line, so
    no read conflicts (unpadded, 128 or 512 bytes a row would put them all
    in one)."""
    c = _constants("block_common.cuh", "rowtile.cuh", "fused_block_bwd.cu")
    assert c["BPAD"] == 8
    ld_bytes = 2 * c[row]
    assert ld_bytes % 16 == 0
    assert len({(r * ld_bytes // 16) % 8 for r in range(8)}) == 8
    assert len({(r * (ld_bytes - 16) // 16) % 8 for r in range(8)}) < 8


def test_bf16_weight_gradient_fragments_hit_32_banks():
    """``products_bf16_kernel`` stages wgrad's slices in rows of TILE + 4
    floats and packs a fragment register from rows k = 2t and 2t + 1 (+ 8)
    at column g (+ 8) of its warp's slice: each such load of the 32 lanes
    hits 32 different banks; its tiling covers wgrad's 64 x 64 tile with the
    kernel's 8 warps, one 16 x 32 block each, in the shared memory wgrad's
    ring takes, padded."""
    w = _constants("wgrad.cuh")
    c = _constants("block_common.cuh", "rowtile.cuh", "fused_block_bwd.cu")
    text = (CSRC / "fused_block_bwd.cu").read_text()
    assert "constexpr int WLD = wgrad::TILE + 4;" in text
    ld = w["TILE"] + 4
    for row_off, col_off in ((0, 0), (1, 0), (0, 8), (8, 0), (9, 8)):
        banks = {((2 * (lane & 3) + row_off) * ld + (lane >> 2) + col_off) % 32
                 for lane in range(32)}
        assert len(banks) == 32
    assert (w["TILE"] // 16) * (w["TILE"] // 32) == c["NW"] == 8
    assert (ld * 4) % 16 == 0  # the 16-byte cp.async destinations stay aligned
    assert w["STAGES"] * 2 * w["KT"] * ld * 4 <= SMEM_OPTIN_BYTES // 2
