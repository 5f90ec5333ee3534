"""LSTM recurrence, forward and backward: the CUDA kernels and their plain
twin.

Counterpart of ``transformer_clip_eeg_tpu/ops/pallas_lstm.py``
(``lstm_scan_pallas_packed`` and its ``custom_vjp``).  The forward kernel is
``csrc/lstm_scan.cu`` (kernel #3), the backward ``csrc/lstm_scan_bwd.cu``
(kernel #4); each source's header says what bounds it and how it is laid
out.  Each has three families: up to H=128 every recurrence runs as a
thread-block cluster whose CTAs split the hidden units and hold their slice
of ``whh`` in registers (``csrc/lstm_cluster.cuh``); at H=256 as a cluster of
8 CTAs, each with its slice in shared memory and the step's product on the
tensor cores in split TF32, tiles of 16, 24 or 32 batch rows chosen so that
every cluster is co-resident (``csrc/lstm_mid.cuh``); past 256 one
persistent cooperative grid runs all of them, cut into (direction, batch
group) pairs and each pair's units into slices, a CTA a slice, with its slice
of ``whh`` in shared memory as far as it fits and the rest streamed from L2
each step, and each step's product on the tensor cores in split TF32
(``csrc/lstm_wide.cuh``).
:func:`lstm_launch_plan` is the one place that sizes either launch (the
headers' rules check it).  :func:`lstm_scan_packed`
launches #3 for a CUDA tensor and runs
:func:`lstm_scan_reference` for a CPU tensor; under autograd it goes through
:class:`LSTMScanFunction` (#4 on the card, autograd through the twin on the
CPU).  There is no other path.

The cluster kernels are built for H in :data:`PLAN_HIDDEN`, the wide ones
for any multiple of :data:`WIDE_GRANULE` past :data:`MAX_CLUSTER_HIDDEN`.  On
the card any other H is zero-padded to the next of them (:func:`pad_hidden`,
:func:`plan_hidden`) and the result sliced back, as the JAX kernel pads
(``ops/pallas_lstm.py:180-201``).  The padding is exact: a padded unit has
zero gate inputs and zero ``whh`` rows and columns, so its gates are i = f
= o = 1/2 and g = 0, its c and h stay 0 and never reach a real unit's
gates; the gradients that flow into the padding are dropped by the slice.

Shapes, as in the JAX package: gate inputs ``xw [T, D, B, 4H]`` (the input
projection with both biases already added; ``D`` independent recurrences,
e.g. the forward and the time-flipped reverse direction of a biLSTM),
recurrent weights ``whh [D, H, 4H]`` (``[in, out]``, the transpose of torch's
``weight_hh_l0``), zero initial state, torch gate order i, f, g, o.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from transformer_clip_eeg_tpu_torch.ops.fused_block import SMEM_OPTIN_BYTES

OWNERS = 256         # threads of a CTA that own a (row, unit) (csrc/lstm_cluster.cuh)
EXCHANGE_GROUPS = 2  # of a CTA's threads at most, each waiting only for its own rows
MAX_UNITS = 32       # hidden units per CTA
PLAN_HIDDEN = (4, 8, 16, 32, 64, 128, 256)  # the hidden sizes the cluster kernels are built for
MAX_CLUSTER_HIDDEN = PLAN_HIDDEN[-1]  # clusters of 8 CTAs, the portable cluster size
# the H=256 kernels (csrc/lstm_mid.cuh): CTAs a cluster, threads a CTA, the
# batch tiles they are built for (2, 3 or 4 n8 blocks of mma.sync), the
# floats between rows of the forward's h buffer and of the backward's dpre
# buffer, and the floats of a CTA's slice of whh
MID_CLUSTER = 8
MID_THREADS = 256
MID_TILES = (16, 24, 32)
MID_LDH = MAX_CLUSTER_HIDDEN + 8
MID_LDP = 4 * MAX_UNITS + 8
MID_SLICE = MAX_CLUSTER_HIDDEN * 4 * MAX_UNITS
# the clusters of 8 CTAs, one CTA an SM, that an H100 SXM (132 SMs) holds at
# once (cudaOccupancyMaxActiveClusters of both H=256 kernels at every tile,
# mid_coresident): the plan's wave, which the C entry points check on the
# card
MID_WAVE_CLUSTERS = 15
# the wide kernels (csrc/lstm_wide.cuh): threads and warps a CTA, rows of K
# a chunk (forward, K = H; backward, K = 4H), chunks in the ring, floats
# after each staged row, a tile's rows and columns at most, a warp's blocks
# of 16 rows and 8 columns, and the multiple of which H must be
WIDE_THREADS = 256
WIDE_WARPS = 8
WIDE_KC = {"fwd": 64, "bwd": 128}
WIDE_STAGES = 2
WIDE_PAD = 4
WIDE_TM = 128
WIDE_TN = 64
WIDE_WARP_MB = 2
WIDE_WARP_NB = 4
WIDE_GRANULE = 64
# the cost model that picks each kernel's units a CTA and batch groups
# (wide_candidates): an SM's split-TF32 products (flops of the three TF32
# products a microsecond), its share of L2 reads (bytes a microsecond), and
# what a step costs beside them (the barrier, the gate math)
WIDE_SM_FLOPS_PER_US = 2.0e6
WIDE_SM_L2_BYTES_PER_US = 4.0e4
WIDE_STEP_US = 2.0


class LaunchPlan(NamedTuple):
    """How the cluster kernels launch (``csrc/lstm_cluster.cuh``), H <= 128."""

    cluster: int     # CTAs per recurrence; each owns hidden // cluster units
    batch_tile: int  # batch rows per cluster: one owner thread per (row, unit)
    threads: int     # per CTA: 2 x OWNERS at H >= 32, else OWNERS
    ctas: int        # in the grid: tiles x directions x cluster
    smem_fwd: int    # shared-memory bytes per CTA of the forward kernel
    smem_bwd: int    # and of the backward kernel


class MidPlan(NamedTuple):
    """How the H=256 kernels launch (``csrc/lstm_mid.cuh``): one cluster of
    ``cluster`` CTAs per (batch tile, direction), one CTA an SM."""

    cluster: int     # CTAs per recurrence; each owns 32 units
    batch_tile: int  # batch rows per cluster: 16, 24 or 32 (n8 blocks of mma.sync)
    threads: int     # per CTA
    ctas: int        # in the grid: tiles x directions x cluster
    smem_fwd: int    # shared-memory bytes per CTA of the forward kernel
    smem_bwd: int    # and of the backward kernel
    waves: int       # of MID_WAVE_CLUSTERS clusters: 1 while they fit the card at once


def mid_smem_bytes(kind: str, tile: int) -> int:
    """``fwd_smem_bytes`` / ``bwd_smem_bytes`` of ``csrc/lstm_mid.cuh``: two
    mbarriers, the slice, then two h buffers and the halves of the sums the
    warps swap (forward) or two dpre buffers and two buffers of the 8 CTAs'
    partial sums (backward)."""
    if kind == "fwd":
        return 16 + 4 * (MID_SLICE + 2 * tile * MID_LDH + 128 * tile)
    return 16 + 4 * (MID_SLICE + 2 * tile * MID_LDP + 2 * MID_CLUSTER * tile * MAX_UNITS)


def mid_plan(b: int, d: int, tile: Optional[int] = None) -> MidPlan:
    """The H=256 plan for ``d`` recurrences of batch ``b``: the smallest
    tile of :data:`MID_TILES` whose clusters fit one wave of
    :data:`MID_WAVE_CLUSTERS` (else the largest), or ``tile``.  At B=128 that
    is 16 rows at D=1 (8 clusters) and 24 at D=2 (12 clusters: 16-row tiles
    would take 16, a second wave); ``tools/lstm_mid_tiles.py`` times every
    tile on the card."""
    if tile is None:
        fits = [t for t in MID_TILES if d * -(-b // t) <= MID_WAVE_CLUSTERS]
        tile = fits[0] if fits else MID_TILES[-1]
    if tile not in MID_TILES or min(b, d) < 1:
        raise ValueError(f"the H=256 recurrence takes a batch tile in {MID_TILES} and B, D "
                         f">= 1; got tile {tile}, B={b}, D={d}")
    clusters = d * -(-b // tile)
    return MidPlan(MID_CLUSTER, tile, MID_THREADS, clusters * MID_CLUSTER,
                   mid_smem_bytes("fwd", tile), mid_smem_bytes("bwd", tile),
                   -(-clusters // MID_WAVE_CLUSTERS))


def mid_coresident(kind: str, plan: MidPlan) -> int:
    """The clusters of the H=256 ``kind`` ("fwd" or "bwd") kernel at the
    batch tile of ``plan`` that the current CUDA card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    n = getattr(lib, f"tce_lstm_{kind}_mid_coresident")(plan.batch_tile)
    if n < 0:
        _build.check(lib, -n, f"mid_coresident({kind!r}, {plan})")
    return n


class WidePlan(NamedTuple):
    """How the wide kernels launch (``csrc/lstm_wide.cuh``), H > 256: one
    persistent cooperative grid per launch, a CTA per SM.  Each kernel cuts
    every direction's batch into ``groups_*`` groups and the hidden units into
    slices of ``units_*``; a CTA owns one slice of one (direction, group)
    pair.  The forward's slice of ``whh`` is H rows x 4 ``units_fwd``
    columns, the backward's (of ``whh^T``) 4H rows x ``units_bwd``;
    ``resident_*`` of its rows stay in shared memory, the others are streamed
    from L2 every step."""

    units_fwd: int     # hidden units per CTA of the forward kernel
    units_bwd: int     # and of the backward kernel
    groups_fwd: int    # batch groups of each direction, forward
    groups_bwd: int    # and backward
    ctas_fwd: int      # CTAs per launch: pairs per launch x H / units
    ctas_bwd: int
    launches_fwd: int  # the pairs run D x groups / (pairs per launch) at a time
    launches_bwd: int
    threads: int       # per CTA
    resident_fwd: int  # rows of the forward's slice in shared memory (of H)
    resident_bwd: int  # rows of the backward's slice in shared memory (of 4H)
    smem_fwd: int      # shared-memory bytes per CTA of the forward kernel
    smem_bwd: int      # and of the backward kernel


def _group_rows(b: int, groups: int) -> int:
    return -(-b // groups)


def _tile_rows(rows: int) -> int:
    return min(-(-rows // 16) * 16, WIDE_TM)


def _tile_cols(n: int) -> int:
    return min(n, WIDE_TN)


def _ldw(n: int) -> int:
    return n + 8 if n % 16 == 0 else n


def _warps_k(tr: int, tc: int, kc: int) -> int:
    wm = -(-(tr // 16) // WIDE_WARP_MB)
    wn = -(-(tc // 8) // WIDE_WARP_NB)
    return min(WIDE_WARPS // (wm * wn), kc // 8)


def wide_smem_bytes(n: int, resident: int, tr: int, tc: int, streamed: int, kc: int) -> int:
    """``smem_bytes`` of ``csrc/lstm_wide.cuh`` for ``n`` columns a CTA,
    tiles of ``tr`` rows x ``tc`` columns and chunks of ``kc`` rows: the
    resident rows, then a ring of chunks of the step's operand and, if rows
    of whh are ``streamed`` (1), of those rows, or the splits' sums,
    whichever is larger."""
    ring = WIDE_STAGES * (tr * (kc + WIDE_PAD) + streamed * kc * _ldw(tc))
    red = _warps_k(tr, tc, kc) * tr * (tc + WIDE_PAD)
    return 4 * (resident * _ldw(n) + max(ring, red))


class _WideKernelPlan(NamedTuple):
    units: int
    groups: int
    ctas: int
    launches: int
    resident: int
    smem: int
    step_us: float   # the cost model's time of a step
    l2_bytes: int    # read from L2 a step by each CTA: its operand rows and streamed whh


def _wide_kernel_plan(b: int, d: int, hidden: int, sms: int, kind: str, units: int,
                      groups: int) -> Optional[_WideKernelPlan]:
    """The plan of ``kind`` ("fwd" or "bwd") at ``units`` a CTA and
    ``groups`` batch groups, or None if the kernel cannot take it."""
    k, cols = (hidden, 4) if kind == "fwd" else (4 * hidden, 1)
    kc = WIDE_KC[kind]
    n, rows = cols * units, _group_rows(b, groups)
    if hidden % units or n % 8 or (groups - 1) * rows >= b:
        return None
    tr, tc = _tile_rows(rows), _tile_cols(n)
    # all of the slice if it fits beside the ring, else as many chunks as
    # fit beside the rings of the operand and of the streamed rows
    resident = k
    if wide_smem_bytes(n, k, tr, tc, 0, kc) > SMEM_OPTIN_BYTES:
        free = SMEM_OPTIN_BYTES - wide_smem_bytes(n, 0, tr, tc, 1, kc)
        if free < 0:
            return None
        resident = free // (4 * _ldw(n) * kc) * kc
    per_pair, pairs = hidden // units, d * groups
    run = 1 if per_pair > sms else min(sms // per_pair, pairs)
    launches = -(-pairs // run)
    row_tiles, col_tiles = -(-rows // tr), -(-n // tc)
    flops = 3 * 2 * row_tiles * tr * k * col_tiles * tc
    l2 = 4 * (rows * k * col_tiles + row_tiles * (k - resident) * n)
    step_us = launches * (max(flops / WIDE_SM_FLOPS_PER_US, l2 / WIDE_SM_L2_BYTES_PER_US)
                          + WIDE_STEP_US)
    return _WideKernelPlan(units, groups, run * per_pair, launches, resident,
                           wide_smem_bytes(n, resident, tr, tc, int(resident < k), kc), step_us,
                           l2)


def wide_candidates(b: int, d: int, hidden: int, sms: int, kind: str) -> list:
    """Every plan of ``kind`` the kernel takes whose pairs fit the SMs, by
    the cost model's step time (then the L2 bytes a CTA reads)."""
    cols = 4 if kind == "fwd" else 1
    out = []
    for units in range(1, hidden + 1):
        if hidden % units or cols * units % 8 or hidden // units > sms:
            continue
        for groups in range(1, max(1, -(-b // 16)) + 1):
            plan = _wide_kernel_plan(b, d, hidden, sms, kind, units, groups)
            if plan is not None:
                out.append(plan)
    return sorted(out, key=lambda p: (round(p.step_us, 6), p.l2_bytes, p.units, p.groups))


@functools.lru_cache(maxsize=None)
def _wide_plan(b: int, d: int, hidden: int, sms: int, fwd: Optional[Tuple[int, int]] = None,
               bwd: Optional[Tuple[int, int]] = None) -> WidePlan:
    """The wide plan; ``fwd`` / ``bwd`` = (units, groups) set a kernel's
    plan, else each takes the cost model's cheapest.  Cached: every call on
    the card asks for it, and the search walks every candidate."""
    if hidden % WIDE_GRANULE:
        raise ValueError(f"the wide recurrence takes H a multiple of {WIDE_GRANULE}; "
                         f"got H={hidden} (lstm_scan_packed pads it)")
    plan = {"threads": WIDE_THREADS}
    for kind, forced in (("fwd", fwd), ("bwd", bwd)):
        if forced is not None:
            p = _wide_kernel_plan(b, d, hidden, sms, kind, *forced)
            if p is None:
                raise ValueError(f"the wide {kind} kernel cannot take (units, groups) = "
                                 f"{forced} at B={b}, H={hidden}")
        else:
            p = wide_candidates(b, d, hidden, sms, kind)[0]
        plan.update({f"units_{kind}": p.units, f"groups_{kind}": p.groups,
                     f"ctas_{kind}": p.ctas, f"launches_{kind}": p.launches,
                     f"resident_{kind}": p.resident, f"smem_{kind}": p.smem})
    return WidePlan(**plan)


def lstm_launch_plan(b: int, d: int, hidden: int, sms: Optional[int] = None
                     ) -> Union[LaunchPlan, MidPlan, WidePlan]:
    """The launch plan of kernels #3 and #4 for ``D=d`` recurrences of batch
    ``b`` and hidden size ``hidden``.  H in :data:`PLAN_HIDDEN` up to 128: a
    :class:`LaunchPlan`, one cluster per (batch tile, direction), each CTA
    owning ``min(hidden, 32)`` units (H=128: clusters of 4 CTAs of 8 batch
    rows, 128 CTAs at B=128, D=2).  H=256: a :class:`MidPlan`
    (:func:`mid_plan`), clusters of 8 CTAs of 32 units.  H > 256, a
    multiple of :data:`WIDE_GRANULE`: a :class:`WidePlan` for a card of
    ``sms`` SMs (default: the current CUDA device's), each kernel's units a
    CTA and batch groups the cheapest by the cost model of
    :func:`wide_candidates` (at B=128 on 132 SMs every shape of
    ``--lstm_units 512`` and ``1024`` puts 128 CTAs to work in each kernel;
    ``tools/lstm_wide_units.py`` times the candidates on the card).  The C
    entry points check the plan against the headers' rules;
    ``tests/test_torch_port_lstm_cluster.py`` and
    ``tests/test_torch_port_lstm_wide.py`` hold this function to them.
    Raises ``ValueError`` for a shape the kernels cannot run (an H that
    :func:`plan_hidden` does not return, B or D < 1)."""
    wide = hidden > MAX_CLUSTER_HIDDEN and hidden % WIDE_GRANULE == 0
    if (hidden not in PLAN_HIDDEN and not wide) or min(b, d) < 1:
        raise ValueError(f"the CUDA recurrence takes H in {PLAN_HIDDEN} or a multiple of "
                         f"{WIDE_GRANULE} past {MAX_CLUSTER_HIDDEN}, and B, D >= 1; "
                         f"got H={hidden}, B={b}, D={d}")
    if hidden == MAX_CLUSTER_HIDDEN:
        return mid_plan(b, d)
    if wide:
        if sms is None:
            sms = torch.cuda.get_device_properties(torch.cuda.current_device()
                                                   ).multi_processor_count
        return _wide_plan(b, d, hidden, sms)
    units = min(hidden, MAX_UNITS)
    cluster, bt = hidden // units, OWNERS // units
    threads = 2 * OWNERS if hidden >= 32 else OWNERS
    # two mbarriers per exchange group, then two step buffers of h (forward)
    # or dpre (backward)
    barriers = 2 * EXCHANGE_GROUPS * 8
    smem_fwd = barriers + 4 * 2 * bt * hidden
    smem_bwd = barriers + 4 * 2 * bt * 4 * hidden
    return LaunchPlan(cluster, bt, threads, -(-b // bt) * d * cluster, smem_fwd, smem_bwd)


def plan_hidden(hidden: int) -> int:
    """The hidden size the kernels run ``hidden`` at: up to
    :data:`MAX_CLUSTER_HIDDEN` the smallest of :data:`PLAN_HIDDEN` that holds
    it (the cluster kernels), past it the next multiple of
    :data:`WIDE_GRANULE` (the wide kernels)."""
    for h in PLAN_HIDDEN:
        if hidden <= h:
            return h
    return -(-hidden // WIDE_GRANULE) * WIDE_GRANULE


def pad_hidden(xw: torch.Tensor, whh: torch.Tensor, hp: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``xw [T, D, B, 4H]`` and ``whh [D, H, 4H]`` zero-padded to ``hp``
    units: each gate's block of columns (and ``whh``'s rows) grows from H to
    ``hp``.  Differentiable; the recurrence on the padded inputs, sliced to
    ``[..., :H]``, is the recurrence on the original ones."""
    hidden = whh.shape[1]
    extra = hp - hidden
    xw_p = F.pad(xw.unflatten(-1, (4, hidden)), (0, extra)).flatten(-2)
    whh_p = F.pad(whh.unflatten(-1, (4, hidden)), (0, extra, 0, 0, 0, extra)).flatten(-2)
    return xw_p.contiguous(), whh_p.contiguous()


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
    # one unbind, not T selects: each select's backward is a zero tensor of
    # xw's size
    for xw_t in xw.unbind(0):
        gates = xw_t + torch.matmul(h, whh)
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
    if plan_hidden(hidden) != hidden or min(t, d, b) == 0:
        raise ValueError(
            f"the CUDA recurrence takes H = plan_hidden(H) (lstm_scan_packed pads any "
            f"other) and non-empty T, D, B; got xw {tuple(xw.shape)}"
        )
    for name, a in (("xw", xw), ("whh", whh)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {a.dtype}")
        if a.device != xw.device or a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on {xw.device}")


def _plan_args(plan: Union[LaunchPlan, MidPlan, WidePlan], kind: str, d: int, b: int,
               hidden: int, like: torch.Tensor) -> tuple:
    """The C entry point's plan arguments (n, bt, groups, threads, smem,
    state, arrived) for ``kind`` "fwd" or "bwd"; an H=256 plan passes its
    waves as ``groups``.  A wide plan also takes a [D, B, H] scratch for c
    (or dc) and D x groups zeroed arrival counters: tensors, which the caller
    passes by :func:`_addresses` and keeps alive until the call returns."""
    smem = plan.smem_fwd if kind == "fwd" else plan.smem_bwd
    if isinstance(plan, LaunchPlan):
        return plan.cluster, plan.batch_tile, 1, plan.threads, smem, None, None
    if isinstance(plan, MidPlan):
        return plan.cluster, plan.batch_tile, plan.waves, plan.threads, smem, None, None
    units, resident, groups = ((plan.units_fwd, plan.resident_fwd, plan.groups_fwd)
                               if kind == "fwd" else
                               (plan.units_bwd, plan.resident_bwd, plan.groups_bwd))
    state = like.new_empty((d, b, hidden))
    arrived = torch.zeros(d * groups, dtype=torch.int32, device=like.device)
    return units, resident, groups, plan.threads, smem, state, arrived


def _addresses(args: tuple) -> list:
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def _launch_forward(xw: torch.Tensor, whh: torch.Tensor, return_c: bool,
                    save_gates: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel #3."""
    _check_cuda_inputs(xw, whh)
    from transformer_clip_eeg_tpu_torch import _build

    lib = _build.load()
    t, d, b, g4 = xw.shape
    hidden = g4 // 4
    with torch.cuda.device(xw.device):
        plan = lstm_launch_plan(b, d, hidden)
        h_out = xw.new_empty((t, d, b, hidden))
        c_out = torch.empty_like(h_out) if return_c else None
        gates = torch.empty_like(xw) if save_gates else None
        w, args = whh, _plan_args(plan, "fwd", d, b, hidden, xw)
        if isinstance(plan, WidePlan):
            # [D, H(k), H(j), 4(g)]: a CTA's columns, the 4 gates of each of
            # its units, side by side in each row
            w = whh.unflatten(-1, (4, hidden)).transpose(-1, -2).contiguous()
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.tce_lstm_scan_fwd(
            xw.data_ptr(), w.data_ptr(), h_out.data_ptr(),
            None if c_out is None else c_out.data_ptr(),
            None if gates is None else gates.data_ptr(), t, d, b, hidden, *_addresses(args),
            stream,
        )
    _build.check(lib, rc, "lstm_scan_packed")
    # a wide plan runs the directions past the SMs in several launches
    lstm_scan_packed.launches += plan.launches_fwd if isinstance(plan, WidePlan) else 1
    return h_out, c_out, gates


def lstm_scan_packed(
    xw: torch.Tensor, whh: torch.Tensor, return_c: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """All ``D`` recurrences in one call: ``h [T, D, B, H]`` (and ``c``
    when ``return_c``).  A CUDA tensor launches the kernel (float32 and
    contiguous, else it raises; any H, zero-padded to :func:`plan_hidden`
    and sliced back); a CPU tensor runs the plain version.  Under autograd
    ``h`` carries its gradient, through :class:`LSTMScanFunction` on the
    card and autograd through the twin on the CPU; ``c`` has none on the
    card, so ``return_c`` is refused there, on either device."""
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LSTM recurrence for device {xw.device}")
    hidden = xw.shape[-1] // 4
    if xw.device.type == "cuda" and xw.dim() == 4 and plan_hidden(hidden) != hidden:
        out = lstm_scan_packed(*pad_hidden(xw, whh, plan_hidden(hidden)), return_c)
        return (out[0][..., :hidden], out[1][..., :hidden]) if return_c else out[..., :hidden]
    wants_grad = torch.is_grad_enabled() and (xw.requires_grad or whh.requires_grad)
    if wants_grad and return_c:
        raise ValueError("return_c has no gradient; call it without autograd")
    if xw.device.type == "cpu":
        return lstm_scan_reference(xw, whh, return_c)
    if wants_grad:
        return LSTMScanFunction.apply(xw, whh)
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
    hidden = g4 // 4
    with torch.cuda.device(gates.device):
        plan = lstm_launch_plan(b, d, hidden)
        dxw = torch.empty_like(gates)
        w, args = whh, _plan_args(plan, "bwd", d, b, hidden, gates)
        if isinstance(plan, WidePlan):
            w = whh.transpose(1, 2).contiguous()  # [D, 4H, H]: a CTA's units side by side
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        rc = lib.tce_lstm_scan_bwd(
            gates.data_ptr(), w.data_ptr(), c.data_ptr(), g.data_ptr(), dxw.data_ptr(),
            t, d, b, hidden, *_addresses(args), stream,
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
    """The recurrence with its gradient on the card: kernels #3 and #4 (a
    CPU tensor takes autograd through the twin, in :func:`lstm_scan_packed`).
    The forward saves ``h``, ``c`` and the gate activations, not ``xw``: the
    backward reads the gates instead of recomputing ``xw + h whh``.  It
    takes float32 only, also in the bf16 compute mode: ``ops/lstm.py`` casts
    around it where JAX casts around its kernel, which upcasts its bf16
    inputs and runs the recurrence in float32 too."""

    @staticmethod
    def forward(ctx, xw, whh):
        h, c, gates = _launch_forward(xw, whh, return_c=True, save_gates=True)
        ctx.save_for_backward(whh, h, c, gates)
        return h

    @staticmethod
    def backward(ctx, g):
        whh, h, c, gates = ctx.saved_tensors
        return lstm_scan_backward(whh, h, c, gates, g)


lstm_scan_packed.launches = 0
lstm_scan_backward.launches = 0
