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

all in uint32 arithmetic.  Here it is int64 arithmetic masked to 32 bits (a
32x32-bit product is split in two 16-bit halves so nothing overflows int64),
so the CPU and the card draw the same bits, and the CUDA kernels compute the
same function in-kernel (``drop_bits`` in ``csrc/fused_block.cu``).  Every
dropout of the port draws from it: the fused block's four masks and
:class:`~transformer_clip_eeg_tpu_torch.ops.layers.Dropout`.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN, MIX1, MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit constant."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_bits(key: Union[int, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """The 32 hash bits (as int64 in [0, 2**32)) of index ``idx`` under
    ``key``; ``key`` is an int or an int64 tensor that broadcasts with
    ``idx``."""
    if isinstance(key, torch.Tensor):
        kc = _mul32(key & M32, GOLDEN)
    else:
        kc = ((int(key) & M32) * GOLDEN) & M32
    h = (idx + kc) & M32
    h = _mul32(h ^ (h >> 16), MIX1)
    h = _mul32(h ^ (h >> 13), MIX2)
    return h ^ (h >> 16)


def threshold(p: float) -> int:
    """``uint32(int(p * 2**32))``: bits at or above it are kept."""
    return int(np.uint32(int(p * (2 ** 32))))


def keep_scale(p: float) -> float:
    """The multiplier of a kept element, ``float32(1 / (1 - p))``."""
    return float(np.float32(1.0 / (1.0 - p)))


def mask_from_bits(bits: torch.Tensor, p: float, dtype=torch.float32) -> torch.Tensor:
    """0 or ``1 / (1 - p)`` per element."""
    scale = torch.tensor(keep_scale(p), dtype=dtype, device=bits.device)
    return torch.where(bits >= threshold(p), scale, torch.zeros((), dtype=dtype,
                                                                device=bits.device))


def linear_index(shape: Sequence[int], device=None) -> torch.Tensor:
    """Row-major linear element index of ``shape``, int64."""
    n = 1
    for s in shape:
        n *= int(s)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def dropout_mask(key: Union[int, torch.Tensor], shape: Sequence[int], p: float,
                 device=None) -> torch.Tensor:
    """The multiplier tensor for one mask: ``key`` is ``seed_base + mask_id``
    (an int, or an int64 tensor broadcasting against ``shape``) and the
    element index is the row-major linear index inside ``shape``."""
    return mask_from_bits(hash_bits(key, linear_index(shape, device)), p)


def fold_seed(seed: int, n: int) -> int:
    """A 31-bit seed derived from ``seed`` and a counter ``n`` (a step
    number, a layer's stream id): one draw of the same hash."""
    return int(hash_bits(int(seed), torch.tensor(int(n) & M32))) & 0x7FFFFFFF


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
