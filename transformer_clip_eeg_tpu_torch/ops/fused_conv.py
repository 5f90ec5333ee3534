"""Fused conv BasicBlock, forward and backward, and the convolution alone:
the CUDA kernels and their plain twins.

Counterpart of ``transformer_clip_eeg_tpu/ops/pallas_conv.py``
(``fused_basic_block`` and its ``custom_vjp``) and of the conv-only Pallas
kernel of ``scripts/bench_conv_algo.py``.  The block is a 'same' Conv1d of K
taps on ``x [B, T, C]`` (C in = C out), plus bias, then dropout, then a
LayerNorm over each sample's joint ``[T, C]`` with a ``[T, C]`` affine (eps
1e-5), then exact GELU.  The kernels:

* ``csrc/fused_conv.cu``: the block's forward (kernel #5) and, in its
  conv-only mode, the convolution alone (kernel #7, :func:`conv1d_same`);
* ``csrc/fused_conv_bwd.cu``: the block's backward (kernel #6); its dx is
  :func:`conv1d_same` of the upstream gradient with the tap-flipped,
  transposed kernel.

Each source's header says what bounds it and how it is laid out.  Weights
are in torch's ``Conv1d`` layout ``[C_out, C_in, K]`` (as
``BasicBlock.conv.weight`` holds them); the wrappers re-lay them tap-major,
``[K, C_in, C_out]``, for the kernels.  :func:`fused_basic_block` goes
through :class:`FusedBasicBlockFunction` whenever a gradient is wanted: for
a CUDA tensor its forward launches #5 (saving the conv output after dropout
and each sample's mean and 1/sigma, 6.3 MB per ``[128, 192, 64]`` block) and
its backward #6; for a CPU tensor its forward is
:func:`fused_basic_block_reference` and its backward is autograd through
that twin.  There is no other path.

Dropout (training mode) follows the JAX kernel exactly: one mask drawn from
:mod:`~transformer_clip_eeg_tpu_torch.ops.dropout` with the key
``seed_base = int32((seed + b // tb) * 7577)`` (mask id 0) for sample ``b``
in batch tile ``tb = pick_tile(B)``, and the row-major index inside that
tile's ``(tb, T, C)`` shape, on the conv output after its bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu_torch.ops.dropout import (
    M32,
    hash_bits32,
    linear_index,
    mask_from_bits,
)
from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    SMEM_OPTIN_BYTES,
    DropoutConfig,
    drop_args,
    pick_tile,
    shard_seed,
)
from transformer_clip_eeg_tpu_torch.ops.layers import same_padding, upcast

# the one width the kernels are compiled for: the flagship's square C=64
KERNEL_C = 64
MAX_KERNEL_K = 64
# the JAX conv kernel's per-tile seed multiplier (pallas_conv.py _fwd_kernel)
CONV_TILE_MULT = 7577
_ROW_PAD, _BLOCK_SUMS = 4, 8  # US = C + 4 and CNW in csrc/fused_conv.cu


def kernel_smem_bytes(t: int, k: int, fused: bool = True) -> int:
    """Shared memory the forward kernel takes for one sample (``smem_floats``
    in ``csrc/fused_conv.cu``): the padded sample at rows of C+4 floats, a
    double buffer of weight taps, and in the fused mode the conv output."""
    c = KERNEL_C
    floats = (t + k - 1) * (c + _ROW_PAD) + 2 * c * c + (t * c if fused else 0) + _BLOCK_SUMS
    return 4 * floats


def max_kernel_t(k: int, fused: bool = True) -> int:
    """The longest window the forward kernel holds at ``k`` taps: T <= 345 at
    K=64 for the block (5.4 s at 64 Hz), more for the conv alone."""
    c = KERNEL_C
    per_row = 4 * ((c + _ROW_PAD) + (c if fused else 0))
    return (SMEM_OPTIN_BYTES - kernel_smem_bytes(0, k, fused)) // per_row


def conv_mask(seed: int, b: int, t: int, c: int, p: float, device=None) -> torch.Tensor:
    """The block's dropout multipliers ``[b, t, c]``: 0 or ``1 / (1 - p)``,
    keyed per batch tile as the JAX kernel keys them."""
    tb = pick_tile(b)
    sample = torch.arange(b, dtype=torch.int64, device=device)
    key = ((int(seed) & M32) + sample // tb) * CONV_TILE_MULT  # mod 2**32 in hash_bits32
    idx = (sample % tb)[:, None, None] * (t * c) + linear_index((t, c), device)
    return mask_from_bits(hash_bits32(key[:, None, None], idx), p)


def conv1d_reference(x: torch.Tensor, w: torch.Tensor,
                     padding: Tuple[int, int]) -> torch.Tensor:
    """``x [B, T, C_in]`` padded with ``padding`` zero rows (before, after)
    and correlated with ``w [C_out, C_in, K]``: ``[B, T', C_out]``."""
    return F.conv1d(F.pad(x.transpose(1, 2), padding), w).transpose(1, 2)


def fused_basic_block_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, seed: int, kernel_size: int, drop_p: float, training: bool,
) -> torch.Tensor:
    """The block in eager torch (the arguments of :func:`fused_basic_block`)."""
    bsz, t, _ = x.shape
    c = w.shape[0]
    conv = conv1d_reference(x, w, same_padding(kernel_size, 1)) + b
    if DropoutConfig(bool(training), int(seed), float(drop_p)).active:
        conv = conv * conv_mask(seed, bsz, t, c, drop_p, x.device)
    return F.gelu(F.layer_norm(conv, (t, c), scale, bias, 1e-5))


def conv_dw_reference(x: torch.Tensor, dconv: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel #6's dW in eager torch, as the one product the kernel computes:
    ``A^T dconv`` over the ``B*T`` rows, where row ``(b, t)`` of ``A`` is the
    window of ``k`` rows of the zero-padded ``x[b]`` that meets output row
    ``t``, flattened to ``(tap, input channel)``.  Returns torch's Conv1d
    layout ``[C_out, C_in, K]``."""
    bsz, t, c = x.shape
    u = F.pad(x, (0, 0, *same_padding(k, 1)))                    # [B, T + K - 1, C]
    a = u.unfold(1, k, 1).permute(0, 1, 3, 2).reshape(bsz * t, k * c)
    dw = a.T @ dconv.reshape(bsz * t, -1)                        # [(tap, C_in), C_out]
    return dw.reshape(k, c, -1).permute(2, 1, 0)


def fused_conv_backward_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, g: torch.Tensor, drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, ...]:
    """Kernel #6 in eager torch, formula by formula as
    ``csrc/fused_conv_bwd.cu`` computes it (no autograd): ``(dx, dw, db,
    dscale, dbias)``.  What the training forward saves (z, mean, 1/sigma) is
    recomputed here."""
    bsz, t, c = x.shape
    k = w.shape[2]
    lo, hi = same_padding(k, 1)
    mask = conv_mask(drop.seed, bsz, t, c, drop.drop_p, x.device) if drop.active else 1.0
    z = (conv1d_reference(x, w, (lo, hi)) + b) * mask
    mean = z.mean((1, 2), keepdim=True)
    inv = torch.rsqrt(z.var((1, 2), unbiased=False, keepdim=True) + 1e-5)
    y = (z - mean) * inv
    a = y * scale + bias
    pdf = torch.exp(-0.5 * a * a) * 0.3989422804014327
    da = g * (0.5 * (1 + torch.erf(a * 0.7071067811865476)) + a * pdf)
    gh = da * scale
    dz = (gh - gh.mean((1, 2), keepdim=True) - y * (gh * y).mean((1, 2), keepdim=True)) * inv
    dconv = dz * mask
    dx = conv1d_reference(dconv, w.transpose(0, 1).flip(2), (hi, lo))
    return (dx, conv_dw_reference(x, dconv, k), dconv.sum((0, 1)), (da * y).sum(0),
            da.sum(0))


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"{what}: x must be float32 [B, T, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, t, c = x.shape
    if c != KERNEL_C or b == 0 or t == 0:
        raise ValueError(f"{what}: the CUDA conv kernels are built for C={KERNEL_C} in and "
                         f"out and a non-empty batch; got x {tuple(x.shape)}")


def _check_w(x: torch.Tensor, w: torch.Tensor, what: str) -> int:
    c = KERNEL_C
    if w.dim() != 3 or tuple(w.shape[:2]) != (c, c) or w.dtype != torch.float32:
        raise ValueError(f"{what}: w must be float32 [{c}, {c}, K], got {w.dtype} "
                         f"{tuple(w.shape)}")
    k = w.shape[2]
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"{what}: the CUDA conv kernels take 1 <= K <= {MAX_KERNEL_K}, "
                         f"got K={k}")
    if w.device != x.device:
        raise ValueError(f"{what}: w is on {w.device}, x on {x.device}")
    return k


def _check_window(t: int, k: int, fused: bool, what: str) -> None:
    if kernel_smem_bytes(t, k, fused) > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"{what}: the CUDA conv kernel holds a padded sample in shared memory, which "
            f"fits T <= {max_kernel_t(k, fused)} at K={k}; T={t} needs "
            f"{kernel_smem_bytes(t, k, fused)} bytes of {SMEM_OPTIN_BYTES}")


def _check_block(x, w, b, scale, bias, what: str) -> int:
    _check_x(x, what)
    k = _check_w(x, w, what)
    _, t, c = x.shape
    _check_window(t, k, True, what)
    for name, p, shape in (("b", b, (c,)), ("scale", scale, (t, c)), ("bias", bias, (t, c))):
        if tuple(p.shape) != shape or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {x.device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")
    return k


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("the conv kernels take contiguous, 16-byte aligned tensors")
    return t.data_ptr()


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """torch's ``[C_out, C_in, K]`` → the kernels' ``[K, C_in, C_out]``."""
    return w.permute(2, 1, 0).contiguous()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_conv_forward_cuda(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, drop: DropoutConfig = DropoutConfig(), save: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch kernel #5 on CUDA tensors: ``(out, z, stats)``, where ``z``
    (``[B, T, C]``, the conv output after dropout) and ``stats`` (``[B, 2]``:
    mean and 1/sigma of each sample) are written only when ``save``, for
    kernel #6."""
    k = _check_block(x, w, b, scale, bias, "fused_basic_block")
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    bsz, t, c = x.shape
    out = torch.empty_like(x)
    z = torch.empty_like(x) if save else None
    stats = x.new_empty((bsz, 2)) if save else None
    wt = _tap_major(w)
    with torch.cuda.device(x.device):
        rc = lib.tce_fused_conv_fwd(
            _ptr(x), _ptr(wt), _ptr(b), _ptr(scale), _ptr(bias), _ptr(out), bsz, t, c, k,
            *drop_args(drop, bsz)[:5], None if z is None else _ptr(z),
            None if stats is None else _ptr(stats), _stream(x),
        )
    _build.check(lib, rc, "fused_basic_block")
    fused_basic_block.launches += 1
    return out, z, stats


def fused_conv_backward(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    g: torch.Tensor, z: torch.Tensor, stats: torch.Tensor,
    drop: DropoutConfig = DropoutConfig(),
) -> Tuple[torch.Tensor, ...]:
    """Kernel #6 on CUDA tensors: ``(dx, dw, db, dscale, dbias)`` for the
    upstream gradient ``g`` of the block's output, from x, the parameters and
    what the training forward saved.  dx is :func:`conv1d_same` (kernel #7)
    of the kernel's dconv.  Its plain version is autograd through
    :func:`fused_basic_block_reference`.  Counted once per call; it is three
    kernel launches (``csrc/fused_conv_bwd.cu``) and #7's."""
    _check_x(x, "fused_conv_backward")
    k = _check_w(x, w, "fused_conv_backward")
    bsz, t, c = x.shape
    _check_window(t, k, True, "fused_conv_backward")
    for name, v, shape in (("g", g, x.shape), ("z", z, x.shape), ("stats", stats, (bsz, 2)),
                           ("scale", scale, (t, c)), ("bias", bias, (t, c))):
        if v is None or tuple(v.shape) != tuple(shape) or v.dtype != torch.float32 \
                or v.device != x.device:
            raise ValueError(f"fused_conv_backward: {name} must be float32 {tuple(shape)} "
                             f"on {x.device}")
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    g = g.contiguous()
    dconv = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = x.new_empty((c,))
    dln = x.new_empty((2, t, c))
    n_ws = lib.tce_fused_conv_bwd_workspace(bsz, t, k)
    _build.check(lib, max(-n_ws, 0), "fused_conv_backward (workspace)")
    ws = x.new_empty((n_ws,))
    with torch.cuda.device(x.device):
        rc = lib.tce_fused_conv_bwd(
            _ptr(x), _ptr(g), _ptr(z), _ptr(stats), _ptr(scale), _ptr(bias), _ptr(dconv),
            _ptr(dw), _ptr(db), _ptr(dln), _ptr(ws), bsz, t, c, k, *drop_args(drop, bsz)[:5],
            _stream(x),
        )
    _build.check(lib, rc, "fused_conv_backward")
    fused_conv_backward.launches += 1
    lo, hi = same_padding(k, 1)
    dx = conv1d_same(dconv, w.transpose(0, 1).flip(2), padding=(hi, lo))
    return dx, dw, db, dln[0], dln[1]


class FusedBasicBlockFunction(torch.autograd.Function):
    """The block with its gradient: kernels #5 and #6 for a CUDA tensor; the
    twin and autograd through the twin for a CPU tensor."""

    @staticmethod
    def forward(ctx, x, w, b, scale, bias, drop):
        ctx.drop = drop
        if x.device.type == "cpu":
            ctx.save_for_backward(x, w, b, scale, bias)
            return fused_basic_block_reference(x, w, b, scale, bias, drop.seed, w.shape[2],
                                               drop.drop_p, drop.training)
        out, z, stats = fused_conv_forward_cuda(x, w, b, scale, bias, drop, save=True)
        ctx.save_for_backward(x, w, b, scale, bias, z, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        drop = ctx.drop
        x, w, b, scale, bias, *saved = ctx.saved_tensors
        if x.device.type == "cpu":
            with torch.enable_grad():
                leaves = [v.detach().requires_grad_() for v in (x, w, b, scale, bias)]
                out = fused_basic_block_reference(*leaves, drop.seed, w.shape[2],
                                                  drop.drop_p, drop.training)
                grads = torch.autograd.grad(out, leaves, g)
        else:
            grads = fused_conv_backward(x, w, scale, bias, g, *saved, drop)
        return (*grads, None)


def fused_basic_block(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    seed: int,
    kernel_size: int,
    drop_p: float,
    training: bool,
    row_offset: int = 0,
    global_batch: Optional[int] = None,
) -> torch.Tensor:
    """Fused Conv1d(K, same) + b → dropout → LayerNorm[T, C] → GELU.

    ``x [B, T, C]``; ``w [C, C, K]`` (torch's Conv1d layout, square C);
    ``b [C]``; ``scale``/``bias [T, C]``; ``seed`` the integer dropout
    stream (``training`` with ``drop_p > 0`` applies the mask).  A bf16 ``x``
    is upcast and the output comes back in bf16.  A CUDA
    tensor launches the kernels (float32 weights, C=64, K <= 64 and
    T <= ``max_kernel_t(K)``, else it raises); a CPU tensor runs the plain
    version.  Under autograd the gradient is kernel #6 on the card and
    autograd through the twin on the CPU.  ``x`` may be rows ``[row_offset,
    row_offset + B)`` of a batch of ``global_batch`` (a data-parallel
    rank's): its mask is then that batch's (the block's ``shard_seed``: the
    mask is keyed by tile as #1's).
    """
    if w.dim() != 3 or w.shape[2] != kernel_size:
        raise ValueError(f"kernel_size={kernel_size} but w has shape {tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused conv block for device {x.device}")
    dt = x.dtype
    # a bf16 x (--compute_dtype bfloat16) is upcast and the output rounded
    # back, the weights staying float32, as the TPU kernel does: the kernels
    # are float32 inside.  Autograd then returns dx in bf16 and the weight
    # gradients in float32, as the JAX kernel's VJP does
    x = upcast(x).contiguous()  # contiguous: e.g. the view a torch Conv1d returns
    drop = DropoutConfig(bool(training), int(seed), float(drop_p))
    if drop.active:
        drop = drop._replace(seed=shard_seed(drop.seed, x.shape[0], row_offset, global_batch))
    wants_grad = torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, w, b, scale, bias))
    if wants_grad:
        out = FusedBasicBlockFunction.apply(x, w, b, scale, bias, drop)
    elif x.device.type == "cpu":
        out = fused_basic_block_reference(x, w, b, scale, bias, drop.seed, kernel_size,
                                          drop.drop_p, drop.training)
    else:
        out = fused_conv_forward_cuda(x, w, b, scale, bias, drop)[0]
    return out.to(dt)


def conv1d_same(x: torch.Tensor, w: torch.Tensor,
                padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The convolution alone, no bias: ``x [B, T, C_in]`` padded with
    ``padding`` zero rows (before, after; torch's 'same' by default) and
    correlated with ``w [C_out, C_in, K]`` → ``[B, T, C_out]``.  A CUDA tensor
    launches kernel #7 (the conv-only mode of #5: C=64 in and out, K <= 64,
    the two paddings adding to K-1; forward only, so it raises under
    autograd); a CPU tensor runs :func:`conv1d_reference`."""
    k = w.shape[2] if w.dim() == 3 else 0
    padding = same_padding(k, 1) if padding is None else tuple(padding)
    if x.device.type == "cpu":
        return conv1d_reference(x, w, padding)
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise ValueError("conv1d_same has no backward kernel: call it without autograd on "
                         "the card (the block's gradient is fused_basic_block's)")
    _check_x(x, "conv1d_same")
    k = _check_w(x, w, "conv1d_same")
    if len(padding) != 2 or min(padding) < 0 or sum(padding) != k - 1:
        raise ValueError(f"conv1d_same: the paddings must add to K-1={k - 1}, got {padding}")
    bsz, t, c = x.shape
    _check_window(t, k, False, "conv1d_same")
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    x = x.contiguous()
    out = torch.empty_like(x)
    wt = _tap_major(w)
    with torch.cuda.device(x.device):
        rc = lib.tce_conv1d_fwd(_ptr(x), _ptr(wt), _ptr(out), bsz, t, c, k, padding[0],
                                _stream(x))
    _build.check(lib, rc, "conv1d_same")
    conv1d_same.launches += 1
    return out


fused_basic_block.launches = 0
fused_conv_backward.launches = 0
conv1d_same.launches = 0
