"""Fused pre-LN transformer block, forward and backward: the CUDA kernels and
their plain twin.

Counterpart of ``transformer_clip_eeg_tpu/ops/pallas_block.py``
(``fused_transformer_block`` and its ``custom_vjp``).  The forward kernel is
``csrc/fused_block.cu`` (kernel #1), the backward ``csrc/fused_block_bwd.cu``
(kernel #2); each source's header says what bounds it and how it is laid
out.  :func:`fused_transformer_block` goes through :class:`FusedBlockFunction`
whenever a gradient is wanted: for a CUDA tensor its forward launches #1 and
its backward #2; for a CPU tensor its forward is
:func:`fused_transformer_block_reference` and its backward is autograd
through that twin.  There is no other path.

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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu_torch.ops.dropout import (
    M32,
    hash_bits,
    keep_scale,
    linear_index,
    mask_from_bits,
    threshold,
)

N_PARAMS = 16
# the one shape the kernels are compiled for: the flagship's E=64, 8 heads, F=4E
KERNEL_E, KERNEL_H, KERNEL_F = 64, 8, 256
# the most dynamic shared memory a CTA may opt into on sm_90 (227 KB)
SMEM_OPTIN_BYTES = 227 * 1024
# the training forward saves q, k, v, the attention context and x1 for the
# backward: five [B, T, E] planes, then each softmax row's log-sum-exp [B, H, T]
N_SAVED = 5


def saved_numel(b: int, t: int, e: int, num_heads: int) -> int:
    """Floats the training forward saves for the backward (one flat tensor:
    ``[N_SAVED, B, T, E]`` then ``[B, H, T]``)."""
    return N_SAVED * b * t * e + b * num_heads * t


def kernel_smem_bytes(t: int) -> int:
    """Shared memory the forward kernel takes for one sample of ``t`` rows
    (``smem_floats`` in ``csrc/fused_block.cu``: LN/ctx and Q/x1 rows, then
    the larger of padded K, V and a score row per warp, or the FFN chunk)."""
    e, f, warps, rows = KERNEL_E, KERNEL_F, 8, 16
    attn = 2 * t * (e + 1) + warps * t
    ffn = rows * f + 4 * rows * e
    return 4 * (2 * t * e + max(attn, ffn))


# the longest window that fits: 218 rows (3.4 s at 64 Hz); the attention
# term dominates at any T above 60, so kernel_smem_bytes is 4 * 266 * T here.
# The backward keeps one head's query records and dQ (28 floats a row) and a
# 5 KB block per warp, and is not the tighter limit.
MAX_KERNEL_T = SMEM_OPTIN_BYTES // (4 * (4 * KERNEL_E + 2 + 8))


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
        return mask_from_bits(hash_bits(key, idx), p)

    attn = ao = fi = fo = None
    if drop.drop_p > 0.0:
        key = seed_base[:, None, None, None] + torch.arange(
            h, dtype=torch.int64, device=device)[None, :, None, None]
        idx = local[:, None, None, None] * (t * t) + linear_index((t, t), device)
        attn = mask_from_bits(hash_bits(key, idx), drop.drop_p)
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
    :func:`fused_transformer_block`)."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo,
     g2, be2, w1, bb1, w2, bb2) = params
    b, t, e = x.shape
    d = e // num_heads
    drop = DropoutConfig(bool(training), int(seed), float(drop_p), float(ffn_drop_p))
    m_attn, m_ao, m_fi, m_fo = block_masks(b, t, e, w1.shape[0], num_heads, drop,
                                           x.device)
    y1 = F.layer_norm(x, (e,), g1, be1, 1e-5)
    q = F.linear(y1, wq, bq).reshape(b, t, num_heads, d)
    k = F.linear(y1, wk, bk).reshape(b, t, num_heads, d)
    v = F.linear(y1, wv, bv).reshape(b, t, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / scale)
    p = torch.softmax(s, dim=-1)
    if m_attn is not None:
        p = p * m_attn
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, e)
    a = F.linear(ctx, wo, bo)
    if m_ao is not None:
        a = a * m_ao
    x1 = x + a
    y2 = F.layer_norm(x1, (e,), g2, be2, 1e-5)
    gl = F.gelu(F.linear(y2, w1, bb1))
    if m_fi is not None:
        gl = gl * m_fi
    f2 = F.linear(gl, w2, bb2)
    if m_fo is not None:
        f2 = f2 * m_fo
    return x1 + f2


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ctx: torch.Tensor,
    lse: torch.Tensor, dctx: torch.Tensor, num_heads: int, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel #2's attention backward in eager torch, each (query, key) pair
    once: ``(dq, dk, dv)``, all ``[B, T, E]``, from the forward's ``q``, ``k``,
    ``v``, its dropped-out context ``ctx``, the softmax rows' log-sum-exp
    ``lse [B, H, T]`` and the context's gradient ``dctx``.  Two identities
    replace the softmax's row statistics: ``P = exp(S - lse)`` and
    ``rowsum(dP * P) = dctx . ctx`` per head (``ctx`` was computed with the
    dropped-out ``P``, so it holds with ``mask``, the attention mask of
    :func:`block_masks`, ``[B, H, T, T]``)."""
    b, t, e = q.shape
    d = e // num_heads

    def heads(a):
        return a.reshape(b, t, num_heads, d).transpose(1, 2)  # [B, H, T, d]

    qh, kh, vh, ch, dch = map(heads, (q, k, v, ctx, dctx))
    p = torch.exp(qh @ kh.transpose(2, 3) * (1.0 / scale) - lse[..., None])
    delta = (dch * ch).sum(-1, keepdim=True)
    dp = dch @ vh.transpose(2, 3)
    pm = p
    if mask is not None:
        dp, pm = dp * mask, p * mask
    ds = p * (dp - delta) * (1.0 / scale)
    return tuple(a.transpose(1, 2).reshape(b, t, e)
                 for a in (ds @ kh, ds.transpose(2, 3) @ qh, pm.transpose(2, 3) @ dch))


def _layer_norm_backward(dy, y, g, inv):
    """dx of ``LayerNorm`` over the last axis from the gradient ``dy`` of its
    output, its normalised input ``y`` (before the affine), the scale ``g``
    and ``inv = 1 / sigma``."""
    gh = dy * g
    return (gh - gh.mean(-1, keepdim=True) - y * (gh * y).mean(-1, keepdim=True)) * inv


def fused_block_backward_reference(
    x: torch.Tensor, params: Sequence[torch.Tensor], g: torch.Tensor, num_heads: int,
    scale: float, drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Kernel #2 in eager torch, formula by formula as ``csrc/fused_block_bwd.cu``
    computes it (no autograd): ``(dx, dparams)``.  The forward's saved values
    (q, k, v, the dropped-out context, x1, the log-sum-exp) are recomputed
    here; the attention part is :func:`attention_backward_reference`."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo,
     g2, be2, w1, bb1, w2, bb2) = params
    b, t, e = x.shape
    d = e // num_heads
    m_attn, m_ao, m_fi, m_fo = block_masks(b, t, e, w1.shape[0], num_heads, drop, x.device)

    def one(m):
        return 1.0 if m is None else m

    def normalise(a):
        inv = torch.rsqrt(a.var(-1, unbiased=False, keepdim=True) + 1e-5)
        return (a - a.mean(-1, keepdim=True)) * inv, inv

    def cols(a):
        return a.reshape(-1, a.shape[-1]).sum(0)

    def atb(a, c):  # a^T c over the B*T rows
        return a.reshape(-1, a.shape[-1]).T @ c.reshape(-1, c.shape[-1])

    # the forward, keeping what the training forward saves
    y1, inv1 = normalise(x)
    y1a = y1 * g1 + be1
    q, k, v = (F.linear(y1a, w, bias) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    qh, kh, vh = (a.reshape(b, t, num_heads, d).transpose(1, 2) for a in (q, k, v))
    s = qh @ kh.transpose(2, 3) * (1.0 / scale)
    lse = torch.logsumexp(s, dim=-1)
    ctx = ((torch.exp(s - lse[..., None]) * one(m_attn)) @ vh).transpose(1, 2).reshape(b, t, e)
    x1 = x + F.linear(ctx, wo, bo) * one(m_ao)
    y2, inv2 = normalise(x1)
    y2a = y2 * g2 + be2
    f1 = F.linear(y2a, w1, bb1)
    gld = F.gelu(f1) * one(m_fi)

    # FFN, LN2 and out-projection backward
    df2 = g * one(m_fo)
    pdf = torch.exp(-0.5 * f1 * f1) * 0.3989422804014327
    df1 = (df2 @ w2) * one(m_fi) * (0.5 * (1 + torch.erf(f1 * 0.7071067811865476)) + f1 * pdf)
    dy2 = df1 @ w1
    dx1 = g + _layer_norm_backward(dy2, y2, g2, inv2)
    da = dx1 * one(m_ao)
    dctx = da @ wo
    dq, dk, dv = attention_backward_reference(q, k, v, ctx, lse, dctx, num_heads, scale, m_attn)
    dy1 = dq @ wq + dk @ wk + dv @ wv
    dx = dx1 + _layer_norm_backward(dy1, y1, g1, inv1)
    dparams = (cols(dy1 * y1), cols(dy1), atb(dq, y1a), atb(dk, y1a), atb(dv, y1a),
               cols(dq), cols(dk), cols(dv), atb(da, ctx), cols(da),
               cols(dy2 * y2), cols(dy2), atb(df1, y2a), cols(df1), atb(df2, gld), cols(df2))
    return dx, dparams


def _check_cuda_inputs(x: torch.Tensor, params: Sequence[torch.Tensor],
                       num_heads: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 [B, T, E], got {x.dtype} {tuple(x.shape)}")
    b, t, e = x.shape
    if (e, num_heads) != (KERNEL_E, KERNEL_H) or b == 0 or t == 0:
        raise ValueError(
            f"the CUDA block is built for E={KERNEL_E}, {KERNEL_H} heads and a "
            f"non-empty batch; got x {tuple(x.shape)} with {num_heads} heads"
        )
    if t > MAX_KERNEL_T:
        raise ValueError(
            f"the CUDA block holds a whole sample in shared memory, which fits "
            f"T <= {MAX_KERNEL_T}; T={t} needs {kernel_smem_bytes(t)} bytes of "
            f"{SMEM_OPTIN_BYTES}.  Longer windows wait for a K/V-tiled kernel "
            f"(ROADMAP.md)"
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
    softmax rows' log-sum-exp) is written only when ``save``, for kernel #2."""
    _check_cuda_inputs(x, params, num_heads)
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    b, t, e = x.shape
    out = torch.empty_like(x)
    saved = x.new_empty((saved_numel(b, t, e, num_heads),)) if save else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tce_fused_block_fwd(
            x.data_ptr(), out.data_ptr(), _params_array(params), b, t, e, num_heads,
            params[13].shape[0], 1.0 / scale, *drop_args(drop, b),
            None if saved is None else saved.data_ptr(), stream,
        )
    _build.check(lib, rc, "fused_transformer_block")
    fused_transformer_block.launches += 1
    return out, saved


def fused_block_backward(
    x: torch.Tensor, params: Sequence[torch.Tensor], g: torch.Tensor,
    saved: torch.Tensor, num_heads: int, scale: float,
    drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Kernel #2 on CUDA tensors: ``(dx, dparams)`` for the upstream gradient
    ``g`` of the block's output, from x, the parameters and what the
    training forward saved.  Its plain version is autograd through
    :func:`fused_transformer_block_reference`.  Counted once per call; it is
    five kernel launches (``csrc/fused_block_bwd.cu``)."""
    _check_cuda_inputs(x, params, num_heads)
    b, t, e = x.shape
    if g.shape != x.shape or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 {tuple(x.shape)} on {x.device}")
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
    ws = x.new_empty((lib.tce_fused_block_bwd_workspace(b, t),))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tce_fused_block_bwd(
            x.data_ptr(), g.data_ptr(), saved.data_ptr(), _params_array(params),
            dx.data_ptr(), _params_array(dparams), ws.data_ptr(), b, t, e,
            num_heads, params[13].shape[0], 1.0 / scale, *drop_args(drop, b), stream,
        )
    _build.check(lib, rc, "fused_block_backward")
    fused_block_backward.launches += 1
    return dx, tuple(dparams)


class FusedBlockFunction(torch.autograd.Function):
    """The block with its gradient: kernels #1 and #2 for a CUDA tensor; the
    twin and autograd through the twin for a CPU tensor."""

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
            with torch.enable_grad():
                xs = [x.detach().requires_grad_()]
                ps = [p.detach().requires_grad_() for p in params]
                out = fused_transformer_block_reference(xs[0], ps, num_heads, scale, *drop)
                grads = torch.autograd.grad(out, xs + ps, g)
            dx, dparams = grads[0], grads[1:]
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
) -> torch.Tensor:
    """Fused pre-LN block, ``x [B, T, E]`` → ``[B, T, E]``.

    ``scale`` divides the attention logits (the reference passes
    ``emb_size ** 0.5``).  ``training`` applies the four dropout masks drawn
    from the integer ``seed`` at rates ``drop_p`` and ``ffn_drop_p``.  A CUDA
    tensor launches the kernels (float32, contiguous, E=64 with 8 heads,
    F=256 and T <= ``MAX_KERNEL_T``, else it raises); a CPU tensor runs the
    plain version.  Under autograd the gradient is kernel #2 on the card and
    autograd through the twin on the CPU.
    """
    drop = DropoutConfig(bool(training), int(seed), float(drop_p), float(ffn_drop_p))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused block for device {x.device}")
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params))
    if wants_grad:
        return FusedBlockFunction.apply(x, num_heads, scale, drop, *params)
    if x.device.type == "cpu":
        return fused_transformer_block_reference(x, params, num_heads, scale, *drop)
    return fused_block_forward_cuda(x, params, num_heads, scale, drop)[0]


fused_transformer_block.launches = 0
fused_block_backward.launches = 0
