"""The one dropout-mask function of the port.

Counterpart of ``_dropout_mask(..., use_prng=False)`` in
``transformer_clip_eeg_tpu/ops/pallas_block.py``: the JAX block kernel's own
definition of its masks off the TPU, a counter-based hash of the element's
linear index and a 32-bit key::

    key  = uint32(seed_base + mask_id)
    h    = idx + key * 0x9E3779B9
    h    = (h ^ h >> 16) * 0x85EBCA6B
    h    = (h ^ h >> 13) * 0xC2B2AE35
    bits = h ^ h >> 16
    keep = bits >= uint32(int(p * 2**32)),  kept elements scale by 1 / (1 - p)

all in uint32 arithmetic.  Here the key and the index are int64 masked to
32 bits and the mixing rounds run on int32 tensors holding the same bits
(two's-complement products wrap mod 2**32 as uint32 ones do; right shifts
are masked to be logical), so the CPU and the card draw the same bits, and
the CUDA kernels compute the same function in-kernel (``drop_bits`` in
``csrc/fused_block.cu``).  Every dropout of the port draws from it: the
fused block's four masks and
:class:`~transformer_clip_eeg_tpu_torch.ops.layers.Dropout`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN, MIX1, MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit constant."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _signed(c: int) -> int:
    """The int32 value with the bits of the 32-bit constant ``c``."""
    return c - (1 << 32) if c >= 1 << 31 else c


def _srl(h: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 ``h`` by ``n``."""
    return (h >> n) & ((1 << (32 - n)) - 1)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` in [0, 2**32) as the int32 tensor of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def hash_bits32(key: Union[int, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """The 32 hash bits of index ``idx`` (int64) under ``key`` (an int or an
    int64 tensor that broadcasts with ``idx``), as int32 of the same bits."""
    if isinstance(key, torch.Tensor):
        kc = _int32(_mul32(key & M32, GOLDEN))
    else:
        kc = _signed(((int(key) & M32) * GOLDEN) & M32)
    h = _int32(idx & M32) + kc
    h = (h ^ _srl(h, 16)) * _signed(MIX1)
    h = (h ^ _srl(h, 13)) * _signed(MIX2)
    return h ^ _srl(h, 16)


def hash_bits(key: Union[int, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """:func:`hash_bits32` as int64 in [0, 2**32)."""
    return hash_bits32(key, idx).to(torch.int64) & M32


def threshold(p: float) -> int:
    """``uint32(int(p * 2**32))``: bits at or above it are kept."""
    return int(np.uint32(int(p * (2 ** 32))))


def keep_scale(p: float) -> float:
    """The multiplier of a kept element, ``float32(1 / (1 - p))``."""
    return float(np.float32(1.0 / (1.0 - p)))


def mask_from_bits(bits: torch.Tensor, p: float, dtype=torch.float32) -> torch.Tensor:
    """0 or ``1 / (1 - p)`` per element of the int32 ``bits`` of
    :func:`hash_bits32` (compared as unsigned by flipping the sign bit on
    both sides)."""
    keep = (bits ^ _signed(1 << 31)) >= _signed(threshold(p) ^ (1 << 31))
    return keep.to(dtype).mul_(torch.tensor(keep_scale(p), dtype=dtype, device=bits.device))


def linear_index(shape: Sequence[int], device=None) -> torch.Tensor:
    """Row-major linear element index of ``shape``, int64."""
    n = 1
    for s in shape:
        n *= int(s)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def dropout_mask(key: Union[int, torch.Tensor], shape: Sequence[int], p: float,
                 device=None, offset: int = 0) -> torch.Tensor:
    """The multiplier tensor for one mask: ``key`` is ``seed_base + mask_id``
    (an int, or an int64 tensor broadcasting against ``shape``) and the
    element index is ``offset`` plus the row-major linear index inside
    ``shape`` (a slice of rows of a larger tensor takes that tensor's mask
    with ``offset`` the index of its first element)."""
    return mask_from_bits(hash_bits32(key, linear_index(shape, device) + offset), p)


def mesh_rows(mesh, b: int) -> Tuple[int, Optional[int]]:
    """``(row_offset, global_batch)`` of a rank's ``b`` rows under ``mesh``
    (``(0, None)``: no mesh), for the fused kernels' masks."""
    if mesh is None:
        return 0, None
    return mesh.rank * b, mesh.n_data * b


def fold_seed(seed: int, n: int) -> int:
    """A 31-bit seed derived from ``seed`` and a counter ``n`` (a step
    number, a layer's stream id): one draw of the same hash, in Python
    integers (it runs on the host for every layer and draw of a step)."""
    h = (int(n) + (int(seed) & M32) * GOLDEN) & M32
    h = ((h ^ (h >> 16)) * MIX1) & M32
    h = ((h ^ (h >> 13)) * MIX2) & M32
    return (h ^ (h >> 16)) & 0x7FFFFFFF


def set_dropout_seeds(module, seed: int) -> None:
    """Key the next forward's dropout masks: every submodule that draws masks
    (one with a ``dropout_seed`` attribute: ``ops.layers.Dropout`` and the
    transformer block) gets ``fold_seed(seed, n)``, ``n`` its rank among
    them in ``module.modules()`` order, so each layer has its own stream."""
    n = 0
    for m in module.modules():
        if hasattr(m, "dropout_seed"):
            m.dropout_seed = fold_seed(seed, n)
            n += 1
