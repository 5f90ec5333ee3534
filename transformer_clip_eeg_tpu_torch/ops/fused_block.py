"""Fused pre-LN transformer block, forward and backward: the CUDA kernels and
their plain twin.

Counterpart of ``transformer_clip_eeg_tpu/ops/pallas_block.py``
(``fused_transformer_block`` and its ``custom_vjp``).  The forward is
``csrc/fused_block.cu`` (kernel #1: three launches, LN1 and Q/K/V over tiles
of 32 rows, the attention per (sample, head) with an online softmax over key
tiles, then out-projection, LN2 and the FFN over tiles of 64 rows; the row
products run on the tensor cores in split TF32, f32-grade), the
backward ``csrc/fused_block_bwd.cu`` (kernel #2); each source's header says
what bounds it and how it is laid out.  :func:`fused_transformer_block` goes
through :class:`FusedBlockFunction` whenever a gradient is wanted: for a CUDA
tensor its forward launches #1 and its backward #2; for a CPU tensor its
forward is :func:`fused_transformer_block_reference` and its backward is
autograd through that twin.  There is no other path.

On the card the block takes float32, E=64 with 8 heads, F=256 and any window
of ``T <= MAX_KERNEL_T`` rows (26 s at 64 Hz): no kernel holds a whole sample
in shared memory, and the limit that is left is one head's records in the
f32 attention backward (the bf16 one's are smaller: :func:`bf16_attention_plan`).

The bf16 mode (``--compute_dtype bfloat16``; the JAX kernel's
``mm_dtype='bfloat16'``) is selected by a bfloat16 ``x`` and by nothing
else.  Every product of the forward and the backward then takes operands
rounded to bf16 (round to nearest even) and sums in float32; everything else
(the LayerNorms, the softmax, GELU, the masks, the residual adds) stays
float32, the attention probabilities are rounded only as an operand of
``p v`` (normalised and dropped out first), ``out`` and ``dx`` come back in
bf16 and the 16 parameter gradients in float32.  The parameters stay
float32.  On the card the kernels' bf16 instantiations run, every product
on the tensor cores (bf16 ``mma.sync``: #1's row products and attention,
#2's row kernels and attention); on the CPU the twins below take the same
mode from ``x``'s dtype, and the CPU backward in
bf16 is :func:`fused_block_backward_reference` (autograd through the twin
would round the gradients where the casts are, not where JAX's VJP rounds
its operands).

``params`` is the JAX kernel's 16-tuple in the same order, with every
weight in torch's ``[out, in]`` layout (as ``nn.Linear.weight`` holds it)::

    g1 [E], be1 [E],                      LN1 scale/bias
    wq [E,E], wk [E,E], wv [E,E],         Q/K/V weights
    bq [E], bk [E], bv [E],               Q/K/V biases
    wo [E,E], bo [E],                     attention output projection
    g2 [E], be2 [E],                      LN2 scale/bias
    w1 [F,E], bb1 [F], w2 [E,F], bb2 [E]  FFN

Dropout (training mode) follows the JAX kernel exactly: four masks drawn
from :mod:`~transformer_clip_eeg_tpu_torch.ops.dropout` with the key
``seed_base + mask_id``, ``seed_base = int32((seed + b // tb) * 8191)`` for
sample ``b`` in batch tile ``tb = pick_tile(B)``, and the row-major index
inside that tile's mask shape:

* ids ``0..H-1``: each head's probabilities after the softmax, ``(tb, T, T)``;
* id ``H``: the attention output after ``Wo`` + ``bo``, ``(tb·T, E)``;
* id ``H+1``: the FFN inner after GELU, ``(tb·T, F)``, at ``ffn_drop_p``;
* id ``H+2``: the FFN output after ``W2`` + ``bb2``, ``(tb·T, E)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu_torch.ops.dropout import (
    M32,
    hash_bits32,
    keep_scale,
    linear_index,
    mask_from_bits,
    threshold,
)
from transformer_clip_eeg_tpu_torch.ops.layers import upcast

N_PARAMS = 16
# the one shape the kernels are compiled for: the flagship's E=64, 8 heads, F=4E
KERNEL_E, KERNEL_H, KERNEL_F = 64, 8, 256
# the most dynamic shared memory a CTA may opt into on sm_90 (227 KB)
SMEM_OPTIN_BYTES = 227 * 1024
# the training forward saves q, k, v, the attention context and x1 for the
# backward: five [B, T, E] planes, then each softmax row's log-sum-exp [B, H, T]
N_SAVED = 5


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (nearest even, as ``astype`` and the kernels'
    ``cvt.rn`` round) and held in ``a``'s dtype."""
    return a.to(torch.bfloat16).to(a.dtype)


def _operands(bf16: bool):
    """What a product's operand goes through: :func:`bf16_round` in the
    bf16 mode, else nothing."""
    return bf16_round if bf16 else (lambda a: a)


def saved_numel(b: int, t: int, e: int, num_heads: int) -> int:
    """Floats the training forward saves for the backward (one flat tensor:
    ``[N_SAVED, B, T, E]`` then ``[B, H, T]``)."""
    return N_SAVED * b * t * e + b * num_heads * t


# the forward's attention walks the keys in tiles of this many (KT in
# csrc/fused_block.cu), the backward's in tiles of 32, one warp each, 8 at most
ATTN_KEY_TILE = 16


def attention_smem_bytes(t: int, bf16: bool = False) -> int:
    """Shared memory of the forward's attention CTA for a window of ``t``
    rows (``attn_smem_bytes`` in ``csrc/fused_block.cu``): one head's K and V,
    8 floats a row each, padded to whole key tiles; ``bf16``: the bf16
    attention's (:func:`bf16_attention_plan`)."""
    if bf16:
        return bf16_attention_plan(t).fwd_smem_bytes
    d = KERNEL_E // KERNEL_H
    return 4 * 2 * d * (-(-t // ATTN_KEY_TILE) * ATTN_KEY_TILE)


# the attention backward's shared memory: floats a query (a 20-float record
# and dQ) and floats a warp (a 32 x 33 dS block, 32 keys, 4 of padding)
_BWD_QUERY_FLOATS = 3 * (KERNEL_E // KERNEL_H) + 4
_BWD_WARP_FLOATS = 32 * 33 + 32 * (KERNEL_E // KERNEL_H) + 4


def attention_backward_smem_bytes(t: int) -> int:
    """Shared memory of the backward's attention CTA (``attn_smem_floats`` in
    ``csrc/fused_block_bwd.cu``): one head's queries and a block for each of
    its warps, one per tile of 32 keys and 8 at most."""
    return 4 * (t * _BWD_QUERY_FLOATS + min(-(-t // 32), 8) * _BWD_WARP_FLOATS)


# the longest window the kernels take: the row kernels' shared memory does not
# grow with T, the forward's attention keeps 64 bytes a row, the backward's 112
# bytes a row beside 41 KB: 1,699 rows (26.5 s at 64 Hz)
MAX_KERNEL_T = (SMEM_OPTIN_BYTES - 4 * 8 * _BWD_WARP_FLOATS) // (4 * _BWD_QUERY_FLOATS)

# The bf16 mode's attentions run on the tensor cores (``attn_fwd_bf16_kernel``,
# ``attn_bwd_bf16_kernel``): the forward's warps take tiles of 16 queries and
# walk the keys 32 at a time, at most 8 warps; the backward's warps own 32
# keys each, as the f32 backward's, and walk the queries 32 at a time.
BF16_QUERY_TILE, BF16_KEY_TILE, BF16_ATTN_WARPS = 16, 32, 8


class Bf16AttentionPlan(NamedTuple):
    """Threads and shared-memory bytes of the bf16 attentions' CTAs, one a
    (sample, head)."""

    fwd_threads: int
    fwd_smem_bytes: int
    bwd_threads: int
    bwd_smem_bytes: int


def bf16_attention_plan(t: int) -> Bf16AttentionPlan:
    """The launch of the bf16 attentions for a window of ``t`` rows, as the
    kernels compute it (``attn_bf16_threads`` and ``attn_bf16_smem_bytes`` in
    ``csrc/fused_block.cu``, ``attn_threads`` and ``attn_bf16_smem_bytes`` in
    ``csrc/fused_block_bwd.cu``): the forward's warps split the query tiles
    evenly over the fewest rounds, K and V wait as bf16 rows padded to whole
    key tiles; the backward keeps each query's f32 dQ, its (lse, delta) and
    its q and dctx as bf16.  The window is the block's, 1 to
    ``MAX_KERNEL_T`` rows; past it this raises."""
    if not 0 < t <= MAX_KERNEL_T:
        raise ValueError(f"the CUDA block takes windows of 1 to {MAX_KERNEL_T} rows, got T={t}")
    d = KERNEL_E // KERNEL_H
    tiles = -(-t // BF16_QUERY_TILE)
    rounds = -(-tiles // BF16_ATTN_WARPS)
    padded = -(-t // BF16_KEY_TILE) * BF16_KEY_TILE
    return Bf16AttentionPlan(
        fwd_threads=32 * -(-tiles // rounds), fwd_smem_bytes=2 * padded * d * 2,
        bwd_threads=32 * min(padded // BF16_KEY_TILE, 8),
        bwd_smem_bytes=padded * (4 * d + 8 + 2 * 2 * d))


class DropoutConfig(NamedTuple):
    """What a fused kernel needs to draw its masks: ``training`` off (or both
    rates 0) means no masks at all, as ``_mask_cfg`` in the JAX block kernel.
    The conv block (``ops/fused_conv.py``) has one mask, at ``drop_p``."""

    training: bool = False
    seed: int = 0
    drop_p: float = 0.0
    ffn_drop_p: float = 0.0

    @property
    def active(self) -> bool:
        return self.training and (self.drop_p > 0.0 or self.ffn_drop_p > 0.0)


def pick_tile(b: int) -> int:
    """The JAX kernel's batch tile (``_pick_tile``): the first of 8, 4, 2 that
    divides ``b``, else 1.  Only the mask indexing depends on it here."""
    for tb in (8, 4, 2):
        if b % tb == 0:
            return tb
    return 1


def shard_seed(seed: int, b: int, row_offset: int = 0,
               global_batch: Optional[int] = None) -> int:
    """The seed whose masks for a batch of ``b`` rows are those of rows
    ``[row_offset, row_offset + b)`` of a batch of ``global_batch`` under
    ``seed`` (a data-parallel rank's rows).  Sample ``s`` is keyed by
    ``seed + s // tb`` and its index inside the tile, so with the same tile
    ``tb`` and ``row_offset`` a multiple of it, ``seed + row_offset // tb``
    gives the rank's rows their global masks, in this twin and the kernels
    alike; other shards raise ``ValueError``."""
    if global_batch is None or (row_offset == 0 and global_batch == b):
        return seed
    tb = pick_tile(global_batch)
    if pick_tile(b) != tb or row_offset % tb:
        raise ValueError(
            f"rows [{row_offset}, {row_offset + b}) of a batch of {global_batch} cannot take "
            f"their global dropout masks: the batch tile of {b} rows is {pick_tile(b)} and "
            f"of {global_batch} rows {tb}; choose a batch whose shards keep its tile")
    return seed + row_offset // tb


def block_masks(b: int, t: int, e: int, f: int, num_heads: int,
                drop: DropoutConfig, device=None):
    """The block's four dropout multipliers for a batch of ``b`` samples:
    attention ``[b, H, T, T]``, attention output ``[b, T, E]``, FFN inner
    ``[b, T, F]``, FFN output ``[b, T, E]``; a mask whose rate is 0 is
    ``None``, and all four are ``None`` outside training."""
    if not drop.active:
        return None, None, None, None
    tb = pick_tile(b)
    sample = torch.arange(b, dtype=torch.int64, device=device)
    local = sample % tb
    seed_base = ((int(drop.seed) & M32) + sample // tb) * 8191  # mod 2**32 below
    h = num_heads

    def rows(mask_id, width, p):
        key = (seed_base + mask_id)[:, None, None]
        idx = local[:, None, None] * (t * width) + linear_index((t, width), device)
        return mask_from_bits(hash_bits32(key, idx), p)

    attn = ao = fi = fo = None
    if drop.drop_p > 0.0:
        key = seed_base[:, None, None, None] + torch.arange(
            h, dtype=torch.int64, device=device)[None, :, None, None]
        idx = local[:, None, None, None] * (t * t) + linear_index((t, t), device)
        attn = mask_from_bits(hash_bits32(key, idx), drop.drop_p)
        ao = rows(h, e, drop.drop_p)
        fo = rows(h + 2, e, drop.drop_p)
    if drop.ffn_drop_p > 0.0:
        fi = rows(h + 1, f, drop.ffn_drop_p)
    return attn, ao, fi, fo


def fused_transformer_block_reference(
    x: torch.Tensor, params: Sequence[torch.Tensor], num_heads: int, scale: float,
    training: bool = False, seed: int = 0, drop_p: float = 0.0, ffn_drop_p: float = 0.0,
) -> torch.Tensor:
    """The block in eager torch: ``x [B, T, E]`` → ``[B, T, E]``, with the
    JAX kernel's dropout masks in training mode (the arguments of
    :func:`fused_transformer_block`); a bf16 ``x`` takes the bf16 mode."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo,
     g2, be2, w1, bb1, w2, bb2) = params
    b, t, e = x.shape
    d = e // num_heads
    r = _operands(x.dtype == torch.bfloat16)
    xf = upcast(x)
    drop = DropoutConfig(bool(training), int(seed), float(drop_p), float(ffn_drop_p))
    m_attn, m_ao, m_fi, m_fo = block_masks(b, t, e, w1.shape[0], num_heads, drop,
                                           x.device)
    y1 = r(F.layer_norm(xf, (e,), g1, be1, 1e-5))
    q = F.linear(y1, r(wq), bq).reshape(b, t, num_heads, d)
    k = F.linear(y1, r(wk), bk).reshape(b, t, num_heads, d)
    v = F.linear(y1, r(wv), bv).reshape(b, t, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", r(q), r(k)) * (1.0 / scale)
    p = torch.softmax(s, dim=-1)
    if m_attn is not None:
        p = p * m_attn
    ctx = torch.einsum("bhqk,bkhd->bqhd", r(p), r(v)).reshape(b, t, e)
    a = F.linear(r(ctx), r(wo), bo)
    if m_ao is not None:
        a = a * m_ao
    x1 = xf + a
    y2 = F.layer_norm(x1, (e,), g2, be2, 1e-5)
    gl = F.gelu(F.linear(r(y2), r(w1), bb1))
    if m_fi is not None:
        gl = gl * m_fi
    f2 = F.linear(r(gl), r(w2), bb2)
    if m_fo is not None:
        f2 = f2 * m_fo
    return (x1 + f2).to(x.dtype)


def attention_online_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    mask: Optional[torch.Tensor] = None, tile: int = ATTN_KEY_TILE, bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #1's attention in eager torch, step by step as
    ``attn_fwd_kernel`` walks it: ``(ctx [B, T, E], lse [B, H, T])`` from
    ``q``, ``k``, ``v`` ``[B, T, E]``.  An online softmax in base 2 over key
    tiles of ``tile``: ``log2(e) / scale`` is folded into q, the running max
    ``m`` moves once a tile and rescales the running sum ``l`` and context,
    ``l`` takes the clean probabilities and the context the ones multiplied
    by ``mask`` (the attention mask of :func:`block_masks`), the context is
    divided by ``l`` at the end and ``lse = m ln 2 + log l``.

    ``bf16`` is the kernel's bf16 mode: q, k and v are rounded to bf16 (q
    before the scale is folded in), and the probabilities are rounded only
    after they are normalised and dropped out, as JAX rounds them.  So the
    walk takes two passes: the first only for ``m`` and ``l``, the second
    for the context, ``bf16(mask 2^(s - m) / l) v``, rounded to bf16 (the
    forward keeps q, k, v and the context as bf16 values)."""
    b, t, e = q.shape
    d = e // num_heads
    r = _operands(bf16)

    def heads(a):
        return r(a).reshape(b, t, num_heads, d).transpose(1, 2)  # [B, H, T, d]

    qh, kh, vh = heads(q) * (math.log2(math.e) / scale), heads(k), heads(v)
    m = q.new_full((b, num_heads, t), -math.inf)
    l = q.new_zeros((b, num_heads, t))
    acc = q.new_zeros((b, num_heads, t, d))
    for j0 in range(0, t, tile):
        s = qh @ kh[:, :, j0:j0 + tile].transpose(2, 3)  # a ragged last tile is just shorter
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if not bf16:
            if mask is not None:
                p = p * mask[:, :, :, j0:j0 + tile]
            acc = acc * alpha[..., None] + p @ vh[:, :, j0:j0 + tile]
        m = m_new
    if bf16:
        for j0 in range(0, t, tile):
            p = torch.exp2(qh @ kh[:, :, j0:j0 + tile].transpose(2, 3) - m[..., None]) \
                / l[..., None]
            if mask is not None:
                p = p * mask[:, :, :, j0:j0 + tile]
            acc = acc + r(p) @ vh[:, :, j0:j0 + tile]
        ctx = r(acc.transpose(1, 2).reshape(b, t, e))
    else:
        ctx = (acc / l[..., None]).transpose(1, 2).reshape(b, t, e)
    return ctx, m * math.log(2.0) + torch.log(l)


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ctx: torch.Tensor,
    lse: torch.Tensor, dctx: torch.Tensor, num_heads: int, scale: float,
    mask: Optional[torch.Tensor] = None, bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel #2's attention backward in eager torch, each (query, key) pair
    once: ``(dq, dk, dv)``, all ``[B, T, E]``, from the forward's ``q``, ``k``,
    ``v``, its dropped-out context ``ctx``, the softmax rows' log-sum-exp
    ``lse [B, H, T]`` and the context's gradient ``dctx``.  Two identities
    replace the softmax's row statistics: ``P = exp(S - lse)`` and
    ``rowsum(dP * P) = dctx . ctx`` per head (``ctx`` was computed with the
    dropped-out ``P``, so it holds with ``mask``, the attention mask of
    :func:`block_masks`, ``[B, H, T, T]``).  ``bf16`` rounds every product's
    operands: q, k, v, ctx and dctx (bf16 values already, as the bf16
    forward and FFN backward leave them), dS and the dropped-out P."""
    b, t, e = q.shape
    d = e // num_heads
    r = _operands(bf16)

    def heads(a):
        return r(a).reshape(b, t, num_heads, d).transpose(1, 2)  # [B, H, T, d]

    qh, kh, vh, ch, dch = map(heads, (q, k, v, ctx, dctx))
    p = torch.exp(qh @ kh.transpose(2, 3) * (1.0 / scale) - lse[..., None])
    delta = (dch * ch).sum(-1, keepdim=True)
    dp = dch @ vh.transpose(2, 3)
    pm = p
    if mask is not None:
        dp, pm = dp * mask, p * mask
    ds = r(p * (dp - delta) * (1.0 / scale))
    return tuple(a.transpose(1, 2).reshape(b, t, e)
                 for a in (ds @ kh, ds.transpose(2, 3) @ qh, r(pm).transpose(2, 3) @ dch))


def _layer_norm_backward(dy, y, g, inv):
    """dx of ``LayerNorm`` over the last axis from the gradient ``dy`` of its
    output, its normalised input ``y`` (before the affine), the scale ``g``
    and ``inv = 1 / sigma``."""
    gh = dy * g
    return (gh - gh.mean(-1, keepdim=True) - y * (gh * y).mean(-1, keepdim=True)) * inv


def _normalise(a):
    """LayerNorm over the last axis before its affine, and ``1 / sigma``."""
    inv = torch.rsqrt(a.var(-1, unbiased=False, keepdim=True) + 1e-5)
    return (a - a.mean(-1, keepdim=True)) * inv, inv


def fused_block_saved_reference(
    x: torch.Tensor, params: Sequence[torch.Tensor], num_heads: int, scale: float,
    drop: DropoutConfig = DropoutConfig(),
) -> torch.Tensor:
    """What kernel #1's training forward saves for #2, in eager torch: the flat
    tensor of :func:`saved_numel` floats (q, k, v, the dropped-out attention
    context and x1, each ``[B, T, E]``, then the softmax rows' log-sum-exp
    ``[B, H, T]``).  For a bf16 ``x`` q, k, v and the context are bf16
    values: the bf16 forward rounds them where they are made, since they
    are only ever operands of products."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo, *_rest) = params
    b, t, e = x.shape
    d = e // num_heads
    r = _operands(x.dtype == torch.bfloat16)
    xf = upcast(x)
    m_attn, m_ao, _, _ = block_masks(b, t, e, params[12].shape[0], num_heads, drop, x.device)
    y1a = r(_normalise(xf)[0] * g1 + be1)
    q, k, v = (r(F.linear(y1a, r(w), bias)) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    qh, kh, vh = (a.reshape(b, t, num_heads, d).transpose(1, 2) for a in (q, k, v))
    s = qh @ kh.transpose(2, 3) * (1.0 / scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if m_attn is not None:
        p = p * m_attn
    ctx = r((r(p) @ vh).transpose(1, 2).reshape(b, t, e))
    a = F.linear(ctx, r(wo), bo)
    if m_ao is not None:
        a = a * m_ao
    return torch.cat([torch.stack([q, k, v, ctx, xf + a]).reshape(-1), lse.reshape(-1)])


def fused_block_backward_reference(
    x: torch.Tensor, params: Sequence[torch.Tensor], g: torch.Tensor, num_heads: int,
    scale: float, drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Kernel #2 in eager torch, formula by formula as ``csrc/fused_block_bwd.cu``
    computes it (no autograd): ``(dx, dparams)``.  The forward's saved values
    (q, k, v, the dropped-out context, x1, the log-sum-exp) are recomputed
    here; the attention part is :func:`attention_backward_reference`.  A
    bf16 ``x`` (and ``g``) takes the bf16 mode, the JAX kernel's VJP: every
    product's operands rounded to bf16, f32 sums (the bias and LayerNorm
    gradients sum unrounded values), ``dx`` in bf16, the parameter gradients
    in float32."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo,
     g2, be2, w1, bb1, w2, bb2) = params
    b, t, e = x.shape
    bf16 = x.dtype == torch.bfloat16
    r = _operands(bf16)
    m_attn, m_ao, m_fi, m_fo = block_masks(b, t, e, w1.shape[0], num_heads, drop, x.device)

    def one(m):
        return 1.0 if m is None else m

    def cols(a):
        return a.reshape(-1, a.shape[-1]).sum(0)

    def atb(a, c):  # a^T c over the B*T rows
        return r(a.reshape(-1, a.shape[-1])).T @ r(c.reshape(-1, c.shape[-1]))

    # the forward: what the training forward saves, the rest recomputed
    saved = fused_block_saved_reference(x, params, num_heads, scale, drop)
    q, k, v, ctx, x1 = saved[:N_SAVED * x.numel()].reshape(N_SAVED, b, t, e)
    lse = saved[N_SAVED * x.numel():].reshape(b, num_heads, t)
    xf, g = upcast(x), upcast(g)
    y1, inv1 = _normalise(xf)
    y1a = y1 * g1 + be1
    y2, inv2 = _normalise(x1)
    y2a = y2 * g2 + be2
    f1 = F.linear(r(y2a), r(w1), bb1)
    gld = F.gelu(f1) * one(m_fi)

    # FFN, LN2 and out-projection backward
    df2 = g * one(m_fo)
    pdf = torch.exp(-0.5 * f1 * f1) * 0.3989422804014327
    df1 = (r(df2) @ r(w2)) * one(m_fi) * (0.5 * (1 + torch.erf(f1 * 0.7071067811865476))
                                          + f1 * pdf)
    dy2 = r(df1) @ r(w1)
    dx1 = g + _layer_norm_backward(dy2, y2, g2, inv2)
    da = dx1 * one(m_ao)
    dctx = r(r(da) @ r(wo))
    dq, dk, dv = attention_backward_reference(q, k, v, ctx, lse, dctx, num_heads, scale, m_attn,
                                              bf16)
    dy1 = r(dq) @ r(wq) + r(dk) @ r(wk) + r(dv) @ r(wv)
    dx = dx1 + _layer_norm_backward(dy1, y1, g1, inv1)
    dparams = (cols(dy1 * y1), cols(dy1), atb(dq, y1a), atb(dk, y1a), atb(dv, y1a),
               cols(dq), cols(dk), cols(dv), atb(da, ctx), cols(da),
               cols(dy2 * y2), cols(dy2), atb(df1, y2a), cols(df1), atb(df2, gld), cols(df2))
    return dx.to(x.dtype), dparams


def _check_cuda_inputs(x: torch.Tensor, params: Sequence[torch.Tensor],
                       num_heads: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"x must be float32 or bfloat16 [B, T, E], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, t, e = x.shape
    if (e, num_heads) != (KERNEL_E, KERNEL_H) or b == 0 or t == 0:
        raise ValueError(
            f"the CUDA block is built for E={KERNEL_E}, {KERNEL_H} heads and a "
            f"non-empty batch; got x {tuple(x.shape)} with {num_heads} heads"
        )
    if t > MAX_KERNEL_T:
        raise ValueError(
            f"the CUDA block's attention backward holds one head's queries in shared "
            f"memory, which fits T <= {MAX_KERNEL_T}; T={t} needs "
            f"{attention_backward_smem_bytes(t)} bytes of {SMEM_OPTIN_BYTES}"
        )
    if len(params) != N_PARAMS:
        raise ValueError(f"params must hold {N_PARAMS} tensors, got {len(params)}")
    f = params[13].shape[0]
    want = [(e,), (e,), (e, e), (e, e), (e, e), (e,), (e,), (e,), (e, e), (e,),
            (e,), (e,), (f, e), (f,), (e, f), (e,)]
    if f != KERNEL_F:
        raise ValueError(f"the CUDA block is built for F={KERNEL_F}, got {f}")
    for i, (p, shape) in enumerate(zip(params, want)):
        if tuple(p.shape) != shape or p.dtype != torch.float32:
            raise ValueError(f"param {i}: want float32 {shape}, got {p.dtype} "
                             f"{tuple(p.shape)}")
    for i, p in enumerate((x, *params)):
        if p.device != x.device:
            raise ValueError(f"tensor {i} is on {p.device}, x on {x.device}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"tensor {i} must be contiguous and 16-byte aligned")


def drop_args(drop: DropoutConfig, b: int):
    """The kernels' dropout arguments (``DropCfg`` in ``csrc/drop.cuh``): on,
    seed (uint32), batch tile, and (threshold, keep scale) for drop_p and
    for ffn_drop_p."""
    return (int(drop.active), int(drop.seed) & M32, pick_tile(b),
            threshold(drop.drop_p), keep_scale(drop.drop_p),
            threshold(drop.ffn_drop_p), keep_scale(drop.ffn_drop_p))


def _params_array(params: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * N_PARAMS)(*(p.data_ptr() for p in params))


def fused_block_forward_cuda(
    x: torch.Tensor, params: Sequence[torch.Tensor], num_heads: int, scale: float,
    drop: DropoutConfig = DropoutConfig(), save: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel #1 on a CUDA tensor: ``(out, saved)``, where ``saved``
    (one flat tensor of :func:`saved_numel` floats: ``[5, B, T, E]`` of q, k,
    v, the dropped-out attention context and x1, then ``[B, H, T]`` of the
    softmax rows' log-sum-exp) is returned only when ``save``, for kernel #2.
    Counted once per call, and in ``launches_bf16`` too for a bf16 ``x``
    (the bf16 instantiation, ``out`` in bf16); it is three kernel launches,
    which hand q, k, v and the context to each other through device memory
    (``saved``'s first four planes, float32 in both modes, or scratch of
    that size)."""
    _check_cuda_inputs(x, params, num_heads)
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    b, t, e = x.shape
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    work = torch.empty((saved_numel(b, t, e, num_heads) if save else 4 * b * t * e,),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tce_fused_block_fwd(
            x.data_ptr(), out.data_ptr(), _params_array(params), b, t, e, num_heads,
            params[13].shape[0], 1.0 / scale, *drop_args(drop, b),
            work.data_ptr(), int(save), int(bf16), stream,
        )
    _build.check(lib, rc, "fused_transformer_block")
    fused_transformer_block.launches += 1
    fused_transformer_block.launches_bf16 += bf16
    return out, (work if save else None)


def fused_block_backward(
    x: torch.Tensor, params: Sequence[torch.Tensor], g: torch.Tensor,
    saved: torch.Tensor, num_heads: int, scale: float,
    drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Kernel #2 on CUDA tensors: ``(dx, dparams)`` for the upstream gradient
    ``g`` of the block's output, from x, the parameters and what the
    training forward saved.  Its plain version is autograd through
    :func:`fused_transformer_block_reference` (float32) or
    :func:`fused_block_backward_reference` (bf16: ``x`` and ``g`` bf16,
    ``dx`` bf16, the parameter gradients float32).  Counted once per call,
    and in ``launches_bf16`` too for the bf16 instantiation; it is five
    kernel launches (``csrc/fused_block_bwd.cu``)."""
    _check_cuda_inputs(x, params, num_heads)
    b, t, e = x.shape
    bf16 = x.dtype == torch.bfloat16
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)} on {x.device}")
    if saved is None or saved.shape != (saved_numel(b, t, e, num_heads),) \
            or saved.dtype != torch.float32 or saved.device != x.device \
            or saved.data_ptr() % 16:
        raise ValueError(f"the backward needs the flat tensor of "
                         f"{saved_numel(b, t, e, num_heads)} floats the training forward "
                         f"saved")
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    g = g.contiguous()
    dx = torch.empty_like(x)
    dparams = [torch.empty_like(p) for p in params]
    ws = torch.empty((lib.tce_fused_block_bwd_workspace(b, t),), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tce_fused_block_bwd(
            x.data_ptr(), g.data_ptr(), saved.data_ptr(), _params_array(params),
            dx.data_ptr(), _params_array(dparams), ws.data_ptr(), b, t, e,
            num_heads, params[13].shape[0], 1.0 / scale, *drop_args(drop, b), int(bf16),
            stream,
        )
    _build.check(lib, rc, "fused_block_backward")
    fused_block_backward.launches += 1
    fused_block_backward.launches_bf16 += bf16
    return dx, tuple(dparams)


class FusedBlockFunction(torch.autograd.Function):
    """The block with its gradient: kernels #1 and #2 for a CUDA tensor; for
    a bf16 CPU tensor the twin and the plain statement of #2 (a float32 CPU
    tensor takes autograd through the twin, in
    :func:`fused_transformer_block`).  ``dx`` comes back in ``x``'s dtype,
    the parameter gradients in float32."""

    @staticmethod
    def forward(ctx, x, num_heads, scale, drop, *params):
        ctx.cfg = (num_heads, scale, drop)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, *params)
            return fused_transformer_block_reference(x, params, num_heads, scale, *drop)
        out, saved = fused_block_forward_cuda(x, params, num_heads, scale, drop,
                                              save=True)
        ctx.save_for_backward(x, *params, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, drop = ctx.cfg
        x, *rest = ctx.saved_tensors
        params = rest[:N_PARAMS]
        if x.device.type == "cpu":
            dx, dparams = fused_block_backward_reference(x, params, g, num_heads, scale, drop)
        else:
            dx, dparams = fused_block_backward(x, params, g, rest[N_PARAMS],
                                               num_heads, scale, drop)
        return (dx, None, None, None, *dparams)


def fused_transformer_block(
    x: torch.Tensor,
    params: Sequence[torch.Tensor],
    num_heads: int,
    scale: float,
    training: bool = False,
    seed: int = 0,
    drop_p: float = 0.0,
    ffn_drop_p: float = 0.0,
    row_offset: int = 0,
    global_batch: Optional[int] = None,
) -> torch.Tensor:
    """Fused pre-LN block, ``x [B, T, E]`` → ``[B, T, E]``.

    ``scale`` divides the attention logits (the reference passes
    ``emb_size ** 0.5``).  ``training`` applies the four dropout masks drawn
    from the integer ``seed`` at rates ``drop_p`` and ``ffn_drop_p``.  A CUDA
    tensor launches the kernels (float32 or bfloat16, contiguous, E=64 with 8 heads,
    F=256 and any window of T <= ``MAX_KERNEL_T`` = 1,699 rows, else it
    raises); a CPU tensor runs the plain version.  Under autograd the gradient is kernel #2 on the card and
    autograd through the twin on the CPU.  A bfloat16 ``x`` selects the bf16
    mode (the module docstring); the parameters stay float32.  ``x`` may be
    rows ``[row_offset, row_offset + B)`` of a batch of ``global_batch``
    (a data-parallel rank's): its masks are then that batch's
    (:func:`shard_seed`).
    """
    drop = DropoutConfig(bool(training), int(seed), float(drop_p), float(ffn_drop_p))
    if drop.active:
        drop = drop._replace(seed=shard_seed(drop.seed, x.shape[0], row_offset, global_batch))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused block for device {x.device}")
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params))
    if x.device.type == "cpu" and not (wants_grad and x.dtype == torch.bfloat16):
        return fused_transformer_block_reference(x, params, num_heads, scale, *drop)
    if wants_grad:
        return FusedBlockFunction.apply(x, num_heads, scale, drop, *params)
    return fused_block_forward_cuda(x, params, num_heads, scale, drop)[0]


fused_transformer_block.launches = 0
fused_transformer_block.launches_bf16 = 0
fused_block_backward.launches = 0
fused_block_backward.launches_bf16 = 0
