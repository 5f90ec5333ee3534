"""What the configurations' references share: the dropout hash, the layers,
the LSTM, the transformer block, the CLIP losses and optax's AdamW, in plain
PyTorch on dicts of named tensors.

The dropout masks are the configuration's own definition of dropout, copied
here as a plain function: a counter-based hash of the element's row-major
index and a 32-bit key (``keep = bits >= p * 2**32``, kept elements scaled
by ``float32(1 / (1 - p))``), every layer keyed by ``fold(step_seed, n)``
where ``n`` is the layer's place among the model's dropout layers and
``step_seed = fold(run_seed, step)``.  The transformer block keys its four
masks per batch tile of 8 samples, as the reference's fused block does.
All uint32 arithmetic is done in int64 with 16-bit split products, so
nothing overflows.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

M32 = 0xFFFFFFFF
GOLDEN, MIX1, MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
LN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Matrix products and convolutions in float32 (``tf32=False``) or with
    TF32 operands (the control's precision), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- the dropout hash ---------------------------------------------------------

def fold(seed: int, n: int) -> int:
    """A 31-bit seed from ``seed`` and a counter ``n``."""
    h = (int(n) + (int(seed) & M32) * GOLDEN) & M32
    h = ((h ^ (h >> 16)) * MIX1) & M32
    h = ((h ^ (h >> 13)) * MIX2) & M32
    return (h ^ (h >> 16)) & 0x7FFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash_bits(key, idx: torch.Tensor) -> torch.Tensor:
    """32 hash bits (int64 in [0, 2**32)) of ``idx`` under ``key`` (an int,
    or an int64 tensor broadcasting against ``idx``)."""
    if isinstance(key, torch.Tensor):
        kc = _mul32(key & M32, GOLDEN)
    else:
        kc = ((int(key) & M32) * GOLDEN) & M32
    h = (idx + kc) & M32
    h = _mul32(h ^ (h >> 16), MIX1)
    h = _mul32(h ^ (h >> 13), MIX2)
    return h ^ (h >> 16)


def keep_mask(bits: torch.Tensor, p: float) -> torch.Tensor:
    """0 or ``float32(1 / (1 - p))`` per element of ``bits``."""
    threshold = int(np.uint32(int(p * 2 ** 32)))
    scale = float(np.float32(1.0 / (1.0 - p)))
    return (bits >= threshold).to(torch.float32) * scale


def index_grid(shape: Sequence[int], device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(tuple(shape))


@torch.no_grad()
def dropout_mask(seed: int, shape: Sequence[int], p: float, device) -> torch.Tensor:
    """The multiplier of one plain dropout layer over ``shape``."""
    return keep_mask(hash_bits(seed, index_grid(shape, device)), p)


@torch.no_grad()
def block_masks(seed: int, b: int, t: int, e: int, f: int, heads: int, p: float,
                ffn_p: float, device) -> Tuple[torch.Tensor, ...]:
    """The transformer block's four masks: attention ``[b, H, T, T]``,
    attention output ``[b, T, E]``, FFN inner ``[b, T, F]`` (at ``ffn_p``)
    and FFN output ``[b, T, E]``.  Sample ``s`` of tile ``s // tb`` is keyed
    by ``(seed + s // tb) * 8191 + mask_id``, its index counted inside the
    tile."""
    tb = next((k for k in (8, 4, 2) if b % k == 0), 1)
    sample = torch.arange(b, dtype=torch.int64, device=device)
    local = sample % tb
    base = ((int(seed) & M32) + sample // tb) * 8191
    head_ids = torch.arange(heads, dtype=torch.int64, device=device)
    attn_key = base[:, None, None, None] + head_ids[None, :, None, None]
    attn_idx = local[:, None, None, None] * (t * t) + index_grid((t, t), device)
    attn = keep_mask(hash_bits(attn_key, attn_idx), p)

    def rows(mask_id: int, width: int, rate: float) -> torch.Tensor:
        idx = local[:, None, None] * (t * width) + index_grid((t, width), device)
        return keep_mask(hash_bits((base + mask_id)[:, None, None], idx), rate)

    return attn, rows(heads, e, p), rows(heads + 1, f, ffn_p), rows(heads + 2, e, p)


# -- layers ---------------------------------------------------------------------

def dense(x: torch.Tensor, p: Params, name: str, bias: bool = True) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"] if bias else None)


def conv_same(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """Stride-1 'same' convolution over time of ``[B, T, C]`` (an even
    kernel pads ``(K - 1) // 2`` before and the rest after)."""
    w = p[f"{name}.weight"]
    k = w.shape[2]
    xc = F.pad(x.transpose(1, 2), ((k - 1) // 2, (k - 1) - (k - 1) // 2))
    return F.conv1d(xc, w, p[f"{name}.bias"]).transpose(1, 2)


def layer_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """LayerNorm over the weight's shape: the last axis, or time and channels
    jointly for a ``[T, C]`` affine."""
    w = p[f"{name}.weight"]
    return F.layer_norm(x, tuple(w.shape), w, p[f"{name}.bias"], LN_EPS)


def batch_norm(x: torch.Tensor, p: Params, state: Params, name: str, training: bool
               ) -> torch.Tensor:
    """BatchNorm over the channels of ``[B, T, C]`` (biased batch variance;
    the running statistics move with the unbiased one at momentum 0.1)."""
    rows = x.reshape(-1, x.shape[-1])
    y = F.batch_norm(rows, state[f"{name}.running_mean"], state[f"{name}.running_var"],
                     p[f"{name}.weight"], p[f"{name}.bias"], training, 0.1, LN_EPS)
    return y.reshape(x.shape)


def lstm(x: torch.Tensor, p: Params, name: str, bidirectional: bool) -> torch.Tensor:
    """torch ``nn.LSTM`` (gates i, f, g, o; zero initial state): ``[B, T, in]``
    → ``[B, T, H]``, or ``[B, T, 2H]`` with the reversed direction second."""
    sfx = ("", "_reverse") if bidirectional else ("",)
    xs = [x] + ([torch.flip(x, dims=(1,))] if bidirectional else [])
    xw = torch.stack([F.linear(xi, p[f"{name}.weight_ih_l0{s}"],
                               p[f"{name}.bias_ih_l0{s}"] + p[f"{name}.bias_hh_l0{s}"])
                      for xi, s in zip(xs, sfx)])                      # [D, B, T, 4H]
    whh = torch.stack([p[f"{name}.weight_hh_l0{s}"].t() for s in sfx])  # [D, H, 4H]
    d, b, t, g4 = xw.shape
    hidden = g4 // 4
    h = xw.new_zeros((d, b, hidden))
    c = xw.new_zeros((d, b, hidden))
    hs = []
    for step in range(t):
        gates = xw[:, :, step] + torch.bmm(h, whh)
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    out = torch.stack(hs, dim=2)                                       # [D, B, T, H]
    if not bidirectional:
        return out[0]
    return torch.cat([out[0], torch.flip(out[1], dims=(1,))], dim=-1)


def transformer_block(x: torch.Tensor, p: Params, name: str, heads: int, seed: int,
                      training: bool, drop_p: float = 0.5, ffn_drop_p: float = 0.5
                      ) -> torch.Tensor:
    """Pre-LN block: ``x + Drop(MHA(LN(x)))`` then ``x + Drop(FFN(LN(x)))``,
    the logits divided by sqrt of the whole width, exact GELU."""
    b, t, e = x.shape
    d = e // heads
    f = p[f"{name}.ffn.fc1.weight"].shape[0]
    masks = (block_masks(seed, b, t, e, f, heads, drop_p, ffn_drop_p, x.device)
             if training else (None,) * 4)
    m_attn, m_ao, m_fi, m_fo = masks
    y1 = layer_norm(x, p, f"{name}.ln1")
    q, k, v = (dense(y1, p, f"{name}.attn.{w}").reshape(b, t, heads, d)
               for w in ("queries", "keys", "values"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(e)
    pr = torch.softmax(s, dim=-1)
    if m_attn is not None:
        pr = pr * m_attn
    ctx = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, t, e)
    a = dense(ctx, p, f"{name}.attn.projection")
    if m_ao is not None:
        a = a * m_ao
    x1 = x + a
    inner = F.gelu(dense(layer_norm(x1, p, f"{name}.ln2"), p, f"{name}.ffn.fc1"))
    if m_fi is not None:
        inner = inner * m_fi
    out = dense(inner, p, f"{name}.ffn.fc2")
    if m_fo is not None:
        out = out * m_fo
    return x1 + out


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-12)


def infonce(a: torch.Tensor, b: torch.Tensor, log_temperature: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of ``a @ b.T * exp(T)`` against the diagonal, both
    ways: ``(loss over rows, loss over columns)``."""
    logits = a @ b.T * torch.exp(log_temperature)
    target = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, target), F.cross_entropy(logits.T, target)


# -- optax's AdamW ------------------------------------------------------------

class AdamW:
    """``scale_by_adam`` → ``add_decayed_weights`` → ``-lr``, per leaf::

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2;  n += 1
        p -= lr (mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps) + wd p)
    """

    def __init__(self, params: Params, lr: float, b1: float, b2: float, wd: float,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.wd, self.eps = lr, b1, b2, wd, eps
        self.n = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.n += 1
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mu_hat = self.mu[k] / (1 - self.b1 ** self.n)
            nu_hat = self.nu[k] / (1 - self.b2 ** self.n)
            p.sub_(self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.wd * p))


def train_steps(model, params: Params, state: Params, batches, seed: int, opt: dict,
                ) -> Tuple[list, Params]:
    """The reference's steps from ``params`` and ``state`` (updated in place):
    per batch the losses (floats) and, for the first, the gradient of each
    leaf; ``model`` is a configuration's reference module (``losses(params,
    state, batch, step_seed)``).  Returns ``(losses per step, first
    gradients)``."""
    adam = AdamW(params, opt["learning_rate"], opt["beta1"], opt["beta2"], opt["weight_decay"])
    names = list(params)
    out, first = [], None
    for step, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        losses, objective = model.losses(leaves, state, batch, fold(seed, step))
        grads = torch.autograd.grad(objective, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads)
        out.append({k: float(v.detach()) for k, v in losses.items()})
    return out, first
