"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the layers and kernels the configurations run, from their shapes.

Peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit): a float32
product reaches the tensor cores only as TF32 operands, so 495 TFLOP/s
bounds any float32 kernel; bfloat16 989 TFLOP/s; HBM 3.35 TB/s.

Kernels #1-#4 (the fused transformer block forward and backward, the LSTM
recurrence forward and backward) count as the port's performance record
counts them: products only (two operations a multiply-add), each input byte
read once and each output byte written once; a training forward also
writes what it saves for its backward.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
F32 = 4

# the transformer block's widths (E, heads, FFN) and what its training
# forward saves: five [B, T, E] planes and a [B, H, T] log-sum-exp
BLOCK_E, BLOCK_H, BLOCK_F = 64, 8, 256
BLOCK_SAVED_PLANES = 5


def block_params(e: int = BLOCK_E, f: int = BLOCK_F) -> int:
    """The block's 16 parameters: 2 LayerNorms, Q/K/V/O and the FFN."""
    return 4 * e + 4 * (e * e + e) + (f * e + f) + (e * f + e)


def block_fwd_flops(b: int, t: int, e: int = BLOCK_E, f: int = BLOCK_F) -> float:
    """#1: Q, K, V and out projections, scores, P V, the FFN."""
    return b * (2 * t * e * e * 4 + 2 * 2 * t * t * e + 2 * 2 * t * e * f)


def block_fwd_bytes(b: int, t: int, training: bool, e: int = BLOCK_E, f: int = BLOCK_F,
                    h: int = BLOCK_H) -> float:
    x = b * t * e
    saved = BLOCK_SAVED_PLANES * x + b * h * t if training else 0
    return F32 * (2 * x + block_params(e, f) + saved)


def block_bwd_flops(b: int, t: int, e: int = BLOCK_E, f: int = BLOCK_F) -> float:
    """#2: dX and dW of every forward product."""
    return 2 * block_fwd_flops(b, t, e, f)


def block_bwd_bytes(b: int, t: int, e: int = BLOCK_E, f: int = BLOCK_F,
                    h: int = BLOCK_H) -> float:
    """x, the upstream gradient, the saved planes and the parameters in; dx
    and the parameter gradients out."""
    x = b * t * e
    return F32 * (3 * x + BLOCK_SAVED_PLANES * x + b * h * t + 2 * block_params(e, f))


def lstm_fwd_flops(t: int, d: int, b: int, hidden: int) -> float:
    """#3: the recurrent product ``h whh`` of every step."""
    return 2 * hidden * 4 * hidden * t * b * d


def lstm_fwd_bytes(t: int, d: int, b: int, hidden: int, training: bool) -> float:
    """Gate inputs and ``whh`` in, ``h`` out; in training also ``c`` and the
    gate activations, which the backward reads."""
    rows = t * d * b
    saved = rows * hidden + rows * 4 * hidden if training else 0
    return F32 * (rows * 4 * hidden + d * hidden * 4 * hidden + rows * hidden + saved)


def lstm_bwd_flops(t: int, d: int, b: int, hidden: int) -> float:
    """#4: ``dpre whh^T`` through the recurrence and ``dwhh = h^T dpre``."""
    return 2 * t * d * b * 4 * hidden * hidden * 2


def lstm_bwd_bytes(t: int, d: int, b: int, hidden: int) -> float:
    rows = t * d * b
    return F32 * (2 * rows * 4 * hidden + 3 * rows * hidden + 2 * d * hidden * 4 * hidden)


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time of a kernel: its operations at the precision's peak or
    its bytes at the memory's, whichever is longer."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


# -- a model's products, per example, forward ----------------------------------

def dense_flops(t: int, n_in: int, n_out: int) -> float:
    return 2.0 * t * n_in * n_out


def conv_flops(t: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * t * c_in * c_out * k


def lstm_flops(t: int, n_in: int, hidden: int, directions: int) -> float:
    """Input projection and recurrence."""
    return directions * (dense_flops(t, n_in, 4 * hidden) + dense_flops(t, hidden, 4 * hidden))


def attention_block_flops(t: int) -> float:
    return block_fwd_flops(1, t)


def train_flops(forward_by_layer: list) -> float:
    """Forward and backward of a step: each product once forward and twice
    backward (its input's and its weights' gradient), but the first layer of
    an encoder, whose input takes no gradient, once backward.
    ``forward_by_layer``: ``(flops, is_first_layer)``."""
    return sum(f * (2 if first else 3) for f, first in forward_by_layer)
