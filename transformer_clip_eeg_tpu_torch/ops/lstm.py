"""Batch-first (bi)LSTM with the input projection hoisted out of the loop.

Counterpart of ``transformer_clip_eeg_tpu/ops/lstm.py``: torch ``nn.LSTM``
semantics (gate order i, f, g, o; two biases; zero initial state) with
torch's own parameter names and layouts (``weight_ih_l0 [4H, in]``,
``weight_hh_l0 [4H, H]``, ``bias_ih_l0``, ``bias_hh_l0``, and the
``_reverse`` set for the second direction).

The input projection of every timestep and both directions is one batched
matmul; the recurrence of both directions is one call of
:func:`~transformer_clip_eeg_tpu_torch.ops.lstm_scan.lstm_scan_packed`, the
reverse direction running on time-flipped input, with its gradient through
the recurrence's own backward.  The input projection stays a ``torch.matmul``
under autograd, as the JAX package leaves it to XLA.

A bfloat16 input (``--compute_dtype bfloat16``) takes JAX's casts: the input
projection in bf16, ``whh`` rounded to bf16, the recurrence (kernels #3 and
#4, or the twin) in float32 on upcast operands, ``hs`` rounded back to bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import torch_uniform_init, upcast
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import lstm_scan_packed


class LSTM(nn.Module):
    """Single-layer LSTM: ``[B, T, in]`` → ``[B, T, H]`` (``[B, T, 2H]``
    bidirectional, forward then backward features, as torch)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        g4 = 4 * hidden_size
        self._suffixes = ("", "_reverse") if bidirectional else ("",)
        for s in self._suffixes:
            self.register_parameter(f"weight_ih_l0{s}", nn.Parameter(torch.empty(g4, input_size)))
            self.register_parameter(f"weight_hh_l0{s}", nn.Parameter(torch.empty(g4, hidden_size)))
            self.register_parameter(f"bias_ih_l0{s}", nn.Parameter(torch.empty(g4)))
            self.register_parameter(f"bias_hh_l0{s}", nn.Parameter(torch.empty(g4)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # torch: U(-1/sqrt(H), 1/sqrt(H)) for every LSTM parameter
        for s in self._suffixes:
            for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
                torch_uniform_init(getattr(self, name + s), self.hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        hidden = self.hidden_size
        p = [[getattr(self, n + s) for n in ("weight_ih_l0", "weight_hh_l0",
                                             "bias_ih_l0", "bias_hh_l0")]
             for s in self._suffixes]
        xs = [x] + ([torch.flip(x, dims=(1,))] if self.bidirectional else [])
        dt = x.dtype
        w_ih = torch.stack([w[0].t() for w in p]).to(dt)                 # [D, in, 4H]
        bias = torch.stack([w[2] + w[3] for w in p])[:, None, :].to(dt)  # [D, 1, 4H]
        xw = torch.matmul(torch.stack(xs).reshape(len(xs), b * t, -1), w_ih) + bias
        xw = xw.reshape(len(xs), b, t, 4 * hidden).permute(2, 0, 1, 3).contiguous()
        whh = torch.stack([w[1].t() for w in p]).to(dt).contiguous()     # [D, H, 4H]
        # the recurrence is float32 inside for any dtype, as the TPU kernel
        # upcasts its inputs: no kernel change for bf16.  The casts sit where
        # JAX's do, so autograd rounds dxw and dwhh to bf16 where its
        # custom_vjp does
        hs = lstm_scan_packed(upcast(xw), upcast(whh)).to(dt)            # [T, D, B, H]
        out = hs[:, 0].transpose(0, 1)
        if self.bidirectional:
            rev = torch.flip(hs[:, 1].transpose(0, 1), dims=(1,))
            out = torch.cat([out, rev], dim=-1)
        return out
