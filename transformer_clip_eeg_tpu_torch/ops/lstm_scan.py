"""LSTM recurrence, forward and backward: the CUDA kernels and their plain
twin.

Counterpart of ``transformer_clip_eeg_tpu/ops/pallas_lstm.py``
(``lstm_scan_pallas_packed`` and its ``custom_vjp``).  The forward kernel is
``csrc/lstm_scan.cu`` (kernel #3), the backward ``csrc/lstm_scan_bwd.cu``
(kernel #4); each source's header says what bounds it and how it is laid
out.  Both run each recurrence as a thread-block cluster whose CTAs split
the hidden units; :func:`lstm_launch_plan` is the one place that sizes the
launch (``csrc/lstm_cluster.cuh`` checks it).  :func:`lstm_scan_packed`
launches #3 for a CUDA tensor and runs
:func:`lstm_scan_reference` for a CPU tensor; under autograd it goes through
:class:`LSTMScanFunction` (#4 on the card, autograd through the twin on the
CPU).  There is no other path.

Shapes, as in the JAX package: gate inputs ``xw [T, D, B, 4H]`` (the input
projection with both biases already added; ``D`` independent recurrences,
e.g. the forward and the time-flipped reverse direction of a biLSTM),
recurrent weights ``whh [D, H, 4H]`` (``[in, out]``, the transpose of torch's
``weight_hh_l0``), zero initial state, torch gate order i, f, g, o.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

OWNERS = 256         # threads of a CTA that own a (row, unit) (csrc/lstm_cluster.cuh)
EXCHANGE_GROUPS = 2  # of a CTA's threads, each waiting only for its own rows
MAX_UNITS = 32       # hidden units per CTA


class LaunchPlan(NamedTuple):
    """How the recurrence kernels launch (``csrc/lstm_cluster.cuh``)."""

    cluster: int     # CTAs per recurrence; each owns hidden // cluster units
    batch_tile: int  # batch rows per cluster: one owner thread per (row, unit)
    threads: int     # per CTA: 2 x OWNERS at H >= 32, else OWNERS
    ctas: int        # in the grid: tiles x directions x cluster
    smem_fwd: int    # shared-memory bytes per CTA of the forward kernel
    smem_bwd: int    # and of the backward kernel


def lstm_launch_plan(b: int, d: int, hidden: int) -> LaunchPlan:
    """The launch plan of kernels #3 and #4 for ``D=d`` recurrences of batch
    ``b`` and hidden size ``hidden``: one cluster per (batch tile,
    direction), each CTA owning ``min(hidden, 32)`` units (H=128: clusters
    of 4 CTAs of 8 batch rows, 128 CTAs at B=128, D=2).  The C entry points
    check the plan against the header's rules, which also hold each product
    thread's rows; ``tests/test_torch_port_lstm_cluster.py`` holds this
    function to them.  Raises ``ValueError`` for a shape the kernels cannot
    run."""
    if hidden <= 0 or hidden % 4 or 128 % hidden or min(b, d) < 1:
        raise ValueError(f"the CUDA recurrence takes H a multiple of 4 dividing 128 and "
                         f"B, D >= 1; got H={hidden}, B={b}, D={d}")
    units = min(hidden, MAX_UNITS)
    cluster, bt = hidden // units, OWNERS // units
    threads = 2 * OWNERS if hidden >= 32 else OWNERS
    # two mbarriers per exchange group, then two step buffers of h (forward)
    # or dpre (backward)
    barriers = 2 * EXCHANGE_GROUPS * 8
    smem_fwd = barriers + 4 * 2 * bt * hidden
    smem_bwd = barriers + 4 * 2 * bt * 4 * hidden
    return LaunchPlan(cluster, bt, threads, -(-b // bt) * d * cluster, smem_fwd, smem_bwd)


def lstm_scan_reference(
    xw: torch.Tensor, whh: torch.Tensor, return_c: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The recurrence as a Python loop over time; returns ``h [T, D, B, H]``
    (and ``c`` of the same shape when ``return_c``)."""
    t_len, d, b, g4 = xw.shape
    hidden = g4 // 4
    h = xw.new_zeros((d, b, hidden))
    c = xw.new_zeros((d, b, hidden))
    hs, cs = [], []
    for t in range(t_len):
        gates = xw[t] + torch.matmul(h, whh)
        i = torch.sigmoid(gates[..., :hidden])
        f = torch.sigmoid(gates[..., hidden:2 * hidden])
        g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
        o = torch.sigmoid(gates[..., 3 * hidden:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    h_all = torch.stack(hs)
    return (h_all, torch.stack(cs)) if return_c else h_all


def _check_cuda_inputs(xw: torch.Tensor, whh: torch.Tensor) -> None:
    if xw.dim() != 4 or whh.dim() != 3:
        raise ValueError(f"want xw [T, D, B, 4H] and whh [D, H, 4H], got "
                         f"{tuple(xw.shape)} and {tuple(whh.shape)}")
    t, d, b, g4 = xw.shape
    hidden = g4 // 4
    if tuple(whh.shape) != (d, hidden, g4) or g4 % 4:
        raise ValueError(f"whh {tuple(whh.shape)} does not match xw {tuple(xw.shape)}")
    if hidden % 4 or 128 % hidden or min(t, d, b) == 0:
        raise ValueError(
            f"the CUDA recurrence takes H a multiple of 4 dividing 128 and "
            f"non-empty T, D, B; got xw {tuple(xw.shape)}"
        )
    for name, a in (("xw", xw), ("whh", whh)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {a.dtype}")
        if a.device != xw.device or a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on {xw.device}")


def _launch_forward(xw: torch.Tensor, whh: torch.Tensor, return_c: bool,
                    save_gates: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel #3."""
    _check_cuda_inputs(xw, whh)
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    t, d, b, g4 = xw.shape
    plan = lstm_launch_plan(b, d, g4 // 4)
    h_out = xw.new_empty((t, d, b, g4 // 4))
    c_out = torch.empty_like(h_out) if return_c else None
    gates = torch.empty_like(xw) if save_gates else None
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.tce_lstm_scan_fwd(
            xw.data_ptr(), whh.data_ptr(), h_out.data_ptr(),
            None if c_out is None else c_out.data_ptr(),
            None if gates is None else gates.data_ptr(), t, d, b, g4 // 4,
            plan.cluster, plan.batch_tile, plan.threads, plan.smem_fwd, stream,
        )
    _build.check(lib, rc, "lstm_scan_packed")
    lstm_scan_packed.launches += 1
    return h_out, c_out, gates


def lstm_scan_packed(
    xw: torch.Tensor, whh: torch.Tensor, return_c: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """All ``D`` recurrences in one launch: ``h [T, D, B, H]`` (and ``c``
    when ``return_c``).  A CUDA tensor launches the kernel (float32,
    contiguous, H a multiple of 4 that divides 128, else it raises); a CPU
    tensor runs the plain version.  Under autograd ``h`` carries its
    gradient through :class:`LSTMScanFunction`; ``c`` has none, so
    ``return_c`` is refused there."""
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LSTM recurrence for device {xw.device}")
    if torch.is_grad_enabled() and (xw.requires_grad or whh.requires_grad):
        if return_c:
            raise ValueError("return_c has no gradient; call it without autograd")
        return LSTMScanFunction.apply(xw, whh)
    if xw.device.type == "cpu":
        return lstm_scan_reference(xw, whh, return_c)
    h_out, c_out, _ = _launch_forward(xw, whh, return_c, save_gates=False)
    return (h_out, c_out) if return_c else h_out


def lstm_scan_backward(
    whh: torch.Tensor, h: torch.Tensor, c: torch.Tensor, gates: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4 on CUDA tensors: ``(dxw [T, D, B, 4H], dwhh [D, H, 4H])`` for
    the upstream gradient ``g [T, D, B, H]`` of ``h``, from the forward's
    ``h`` and ``c`` and the gate activations the training forward wrote
    (``gates``, laid out as ``xw``: i, f, g, o after their sigmoid or
    tanh).  Its plain version is autograd through :func:`lstm_scan_reference`.
    Counted once per call, whatever number of launches it takes."""
    t, d, b, g4 = gates.shape
    hidden = g4 // 4
    for name, a, shape in (("h", h, (t, d, b, hidden)), ("c", c, (t, d, b, hidden)),
                           ("g", g, (t, d, b, hidden)),
                           ("whh", whh, (d, hidden, g4))):
        if tuple(a.shape) != shape or a.dtype != torch.float32 or a.device != gates.device:
            raise ValueError(f"{name}: want float32 {shape} on {gates.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    _check_cuda_inputs(gates, whh)
    dxw = _backward_recurrence(whh, c.contiguous(), gates, g.contiguous())
    dwhh = _dwhh(h.contiguous(), dxw)
    lstm_scan_backward.launches += 1
    return dxw, dwhh


def _backward_recurrence(whh: torch.Tensor, c: torch.Tensor, gates: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Kernel #4's recurrence on checked, contiguous inputs: ``dxw``."""
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    t, d, b, g4 = gates.shape
    plan = lstm_launch_plan(b, d, g4 // 4)
    dxw = torch.empty_like(gates)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        rc = lib.tce_lstm_scan_bwd(
            gates.data_ptr(), whh.data_ptr(), c.data_ptr(), g.data_ptr(), dxw.data_ptr(),
            t, d, b, g4 // 4, plan.cluster, plan.batch_tile, plan.threads, plan.smem_bwd,
            stream,
        )
    _build.check(lib, rc, "lstm_scan_backward (recurrence)")
    return dxw


def _dwhh(h: torch.Tensor, dxw: torch.Tensor) -> torch.Tensor:
    """Kernel #4's weight gradient through ``wgrad.cuh``: ``dwhh [D, H, 4H]``
    = the sum over t >= 1 and b of ``h[t-1]^T dxw[t]``, in a fixed order."""
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    t, d, b, hidden = h.shape
    dwhh = h.new_empty((d, hidden, 4 * hidden))
    ws = h.new_empty((lib.tce_lstm_dwhh_workspace(t, d, b, hidden),))
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.tce_lstm_dwhh(h.data_ptr(), dxw.data_ptr(), dwhh.data_ptr(), ws.data_ptr(),
                               t, d, b, hidden, stream)
    _build.check(lib, rc, "lstm_scan_backward (dwhh)")
    return dwhh


class LSTMScanFunction(torch.autograd.Function):
    """The recurrence with its gradient: kernels #3 and #4 for a CUDA
    tensor; the twin and autograd through the twin for a CPU tensor.  On
    the card the forward saves ``h``, ``c`` and the gate activations, not
    ``xw``: the backward reads the gates instead of recomputing ``xw + h whh``."""

    @staticmethod
    def forward(ctx, xw, whh):
        if xw.device.type == "cpu":
            ctx.save_for_backward(xw, whh)
            return lstm_scan_reference(xw, whh)
        h, c, gates = _launch_forward(xw, whh, return_c=True, save_gates=True)
        ctx.save_for_backward(whh, h, c, gates)
        return h

    @staticmethod
    def backward(ctx, g):
        if ctx.saved_tensors[0].device.type == "cpu":
            xw, whh = ctx.saved_tensors
            with torch.enable_grad():
                xs = xw.detach().requires_grad_()
                ws = whh.detach().requires_grad_()
                return torch.autograd.grad(lstm_scan_reference(xs, ws), (xs, ws), g)
        whh, h, c, gates = ctx.saved_tensors
        return lstm_scan_backward(whh, h, c, gates, g)


lstm_scan_packed.launches = 0
lstm_scan_backward.launches = 0
