"""Torch port, the LSTM recurrence past H=256 (the wide kernels): on the
CPU ``lstm_scan_packed`` and its gradient at H=300, 512 and 1024 against
JAX's interpret-mode ``lstm_scan_pallas_packed`` and ``jax.vjp``; the
double_lstm and convLSTM encoders at 512 units against JAX's on carried
weights; ``lstm_launch_plan``'s wide plan (units and batch groups per CTA,
whh rows kept in shared memory and streamed, shared-memory bytes), held to
the rules it reads from ``csrc/lstm_wide.cuh`` (checked again by the C entry
points on the card); and the kernels' split-TF32 step product, emulated,
through both recurrences at T=192 against float64.  The kernels themselves
are held at these widths by the gpu tests of
``tests/test_torch_port_cuda.py``."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.ops.pallas_lstm import lstm_scan_pallas_packed
from transformer_clip_eeg_tpu_torch.models import encoders as te
from transformer_clip_eeg_tpu_torch.ops import lstm_scan as port
from transformer_clip_eeg_tpu_torch.ops.fused_block import SMEM_OPTIN_BYTES
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (
    WidePlan,
    lstm_launch_plan,
    lstm_scan_packed,
    pad_hidden,
    plan_hidden,
)
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

LSTM_ATOL = 1e-6       # forward, as tests/test_torch_port_lstm_cluster.py
LSTM_GRAD_ATOL = 1e-5  # gradient, as there
ENCODER_ATOL = 1e-4    # an encoder, as tests/test_torch_port_zoo_models.py
H100_SMS = 132         # the H100's SMs, at which the plans are pinned (the card gives its own)
HEADER = Path(port.__file__).resolve().parent.parent / "csrc" / "lstm_wide.cuh"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads while these tests run: the suite runs files in
    parallel processes, and torch's default of one thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(t, d, b, hidden, seed):
    """xw, whh at torch's init scale U(+-1/sqrt(H)), and an upstream gradient."""
    rng = np.random.default_rng(seed)
    xw = (0.5 * rng.standard_normal((t, d, b, 4 * hidden))).astype(np.float32)
    lim = hidden ** -0.5
    whh = rng.uniform(-lim, lim, (d, hidden, 4 * hidden)).astype(np.float32)
    g = rng.standard_normal((t, d, b, hidden)).astype(np.float32)
    return xw, whh, g


WIDE = [300, 512, 1024]
SHAPES = [(16, 2), (19, 1)]  # (T, D): both directions packed; one, T off the JAX chunk of 8


@pytest.mark.parametrize("t,d", SHAPES, ids=["T16D2", "T19D1"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_forward_matches_pallas_interpret(hidden, t, d):
    xw, whh, _ = _case(t, d, 8, hidden, seed=hidden + t)
    want = np.asarray(lstm_scan_pallas_packed(jnp.asarray(xw), jnp.asarray(whh), hidden, True))
    got = lstm_scan_packed(torch.from_numpy(xw), torch.from_numpy(whh))
    assert got.shape == (t, d, 8, hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=LSTM_ATOL)


@pytest.mark.parametrize("t,d", SHAPES, ids=["T16D2", "T19D1"])
@pytest.mark.parametrize("hidden", WIDE)
def test_wide_gradient_matches_jax_vjp(hidden, t, d):
    """dxw and dwhh of the port (autograd through the twin on the CPU, the
    recurrence the wide kernels compute on the card) against ``jax.vjp``
    of the interpret-mode Pallas recurrence."""
    xw, whh, g = _case(t, d, 8, hidden, seed=hidden + t + 1)
    out, vjp = jax.vjp(lambda a, w: lstm_scan_pallas_packed(a, w, hidden, True),
                       jnp.asarray(xw), jnp.asarray(whh))
    jdxw, jdwhh = vjp(jnp.asarray(g))
    a = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(whh).requires_grad_()
    h = lstm_scan_packed(a, w)
    dxw, dwhh = torch.autograd.grad(h, (a, w), torch.from_numpy(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(out), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(jdxw), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(jdwhh), atol=LSTM_GRAD_ATOL)


def _encoder_matches_jax(jmod, tmod, x):
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(x))))
    tmod.load_state_dict(state_dict_from_jax(variables, tmod))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ENCODER_ATOL)


def test_double_lstm_encoder_at_512_units_matches_jax():
    """``--eeg_encoder double_lstm --lstm_units 512``'s encoder (two LSTMs of
    H=512, D=1), weights carried from JAX, eval mode (no dropout), T=16."""
    x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(np.float32)
    _encoder_matches_jax(je.EEGLstm(speech_dim=64, units_lstm=512, spatial_filters=8),
                         te.EEGLstm(speech_dim=64, units_lstm=512, spatial_filters=8), x)


def test_conv_lstm_encoder_at_512_units_matches_jax():
    """The convLSTM encoder with biLSTMs of 512 units and, from an output of
    600, 300 (the width the card pads to 320), weights carried from JAX,
    eval mode, T=16."""
    kw = dict(units_lstm=512, output_dim=600, eeg_dim=16, filters=(64, 64), kernels=(8, 8),
              time_dimension=16)
    x = np.random.default_rng(3).standard_normal((2, 16, 16)).astype(np.float32)
    _encoder_matches_jax(je.EEGConvLSTM(**kw), te.EEGConvLSTM(**kw), x)


def _kernel_plans(plan):
    """(units, groups, CTAs, launches, resident rows, shared-memory bytes) of
    the forward and the backward kernel."""
    return ((plan.units_fwd, plan.groups_fwd, plan.ctas_fwd, plan.launches_fwd,
             plan.resident_fwd, plan.smem_fwd),
            (plan.units_bwd, plan.groups_bwd, plan.ctas_bwd, plan.launches_bwd,
             plan.resident_bwd, plan.smem_bwd))


def test_wide_plan_at_512_keeps_all_of_whh_in_shared_memory():
    """H=512 at B=128, D=2 (``--lstm_units 512`` packed, or the convLSTM's
    second biLSTM at ``--latent_dim 1024``): the forward cuts each direction
    into 2 batch groups of 64 rows and 32 slices of 16 units (128 CTAs),
    each CTA's whole slice of whh (512 x 64) resident, so that all of both
    directions' whh stays in shared memory (a copy per group); the backward
    into 4 groups of 32 rows and 16 slices of 32 units (128 CTAs), 896 of
    its slice's 2,048 rows resident and 1,152 streamed from L2 a step."""
    plan = lstm_launch_plan(128, 2, 512, sms=H100_SMS)
    assert isinstance(plan, WidePlan) and plan.threads == 256
    fwd, bwd = _kernel_plans(plan)
    assert fwd == (16, 2, 128, 1, 512, 182272)
    assert bwd == (32, 4, 128, 1, 896, 218112)
    # bytes of whh resident on the card: the forward 8 MiB (all of both
    # directions' whh, once for each of the 2 groups), the backward 3.5 MiB
    assert 128 * 512 * 4 * 16 * 4 == 2 * 2 * 512 * 2048 * 4
    assert 128 * 896 * 32 * 4 == 14680064


@pytest.mark.parametrize("hidden,want", [
    # H=512: 16 units in 4 groups of 32 rows, 128 CTAs, in each kernel; the
    # backward's whole slice (2,048 x 16) resident
    (512, ((16, 4, 128, 1, 512, 182272), (16, 4, 128, 1, 2048, 230400))),
    # H=1024: 16 units in 2 groups of 64 rows (the forward), 32 units in 4
    # groups of 32 (the backward), 128 CTAs each
    (1024, ((16, 2, 128, 1, 512, 219136), (32, 4, 128, 1, 896, 218112)))])
def test_wide_plan_of_one_direction(hidden, want):
    """D=1 at B=128 (the double_lstm encoders at ``--lstm_units 512`` and
    ``1024``): units, batch groups, CTAs, launches, resident rows and shared
    memory of each kernel."""
    plan = lstm_launch_plan(128, 1, hidden, sms=H100_SMS)
    assert _kernel_plans(plan) == want
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_wide_plan_at_1024_streams_part_of_whh():
    """H=1024 at B=128, D=2: both directions' whh (32 MiB) exceed the card's
    shared memory, so the forward (16 units, all 128 rows in one group)
    keeps 384 of its slice's 1,024 rows and streams 640 from L2 a step, and
    the backward (32 units, 2 groups of 64 rows) keeps 768 of 4,096."""
    plan = lstm_launch_plan(128, 2, 1024, sms=H100_SMS)
    fwd, bwd = _kernel_plans(plan)
    assert fwd == (16, 1, 128, 1, 384, 217088)
    assert bwd == (32, 2, 128, 1, 768, 231424)
    fwd_row, bwd_row = 4 * 4 * plan.units_fwd, 4 * plan.units_bwd  # bytes of a row of each slice
    assert fwd_row * 1024 == 256 * 1024 and bwd_row * 4096 == 512 * 1024
    # resident and streamed bytes of each CTA's slice, forward and backward
    assert (fwd_row * 384, fwd_row * (1024 - 384)) == (98304, 163840)
    assert (bwd_row * 768, bwd_row * (4096 - 768)) == (98304, 425984)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_wide_plan_runs_more_directions_than_sms_in_turn():
    """(direction, batch group) pairs whose CTAs do not fit the SMs at once
    run in launches of as many pairs as fit: D=3 at H=512, B=8 fits in one
    launch of 96 CTAs; D=200 at H=320 takes launches of 13 pairs of 10 CTAs
    (forward) and of 16 pairs of 8 (backward)."""
    three = lstm_launch_plan(8, 3, 512, sms=H100_SMS)
    assert _kernel_plans(three) == ((16, 1, 96, 1, 512, 164864),
                                    (16, 1, 96, 1, 2048, 213504))
    many = lstm_launch_plan(8, 200, 320, sms=H100_SMS)
    assert (many.units_fwd, many.ctas_fwd, many.launches_fwd) == (32, 130, 16)
    assert (many.units_bwd, many.ctas_bwd, many.launches_bwd) == (40, 128, 13)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("hidden", [512, 1024])
def test_wide_plan_of_k2_fills_the_sms(hidden, d):
    """Every wide shape of ``--lstm_units 512`` and ``1024`` (B=128, D=1 and
    2) puts at least 128 of the H100's 132 SMs to work in both kernels, in
    one launch, within the shared memory a CTA may take, with batch groups
    that tile B (none empty)."""
    plan = lstm_launch_plan(128, d, hidden, sms=H100_SMS)
    for units, groups, ctas, launches, _, smem in _kernel_plans(plan):
        assert 128 <= ctas <= H100_SMS and launches == 1
        assert ctas == d * groups * (hidden // units)
        assert smem <= SMEM_OPTIN_BYTES
        rows = -(-128 // groups)
        assert (groups - 1) * rows < 128 <= groups * rows


def _c_expr(expr: str, env: dict) -> int:
    """An integer expression of the header (names, calls of its rule
    functions, + - * / %, ``a ? b : c`` and ``==``/``&&``/``<``/``>``
    tests), evaluated as C does for non-negative ints."""
    expr = re.sub(r"sizeof\(float\)", "4", expr).replace("(size_t)", "")
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    m = re.fullmatch(r"\s*(.+?) \? (.+?) : (.+)", expr, re.S)
    if m:
        return eval(f"({m[2]}) if ({m[1]}) else ({m[3]})", {}, dict(env))
    return eval(f"({expr})", {}, dict(env))


def _header_rules() -> dict:
    """The constants and rule functions of ``csrc/lstm_wide.cuh`` as
    Python callables (each function is one ``return`` of an expression)."""
    text = HEADER.read_text()
    env = {name: int(v) for name, v in
           re.findall(r"constexpr int (\w+) = (\d+);", text)}
    for name, params, body in re.findall(
            r"(?:inline |constexpr )+(?:int|size_t|bool) (\w+)\(([^)]*)\) \{\s*return (.+?);\s*\}",
            text, re.S):
        names = [p.split()[-1] for p in params.split(",")]
        env[name] = (lambda *a, names=names, body=body:
                     _c_expr(body, dict(env, **dict(zip(names, a)))))
    return env


@pytest.mark.parametrize("b,d,hidden", [(128, 2, 512), (128, 1, 512), (128, 2, 1024),
                                        (128, 1, 1024), (130, 2, 320), (1, 1, 320),
                                        (8, 2, 1024), (4096, 2, 512), (8, 200, 320),
                                        (128, 2, 4096)])
def test_wide_plan_passes_the_cuda_headers_rules(b, d, hidden):
    """The plan the wrapper computes is one the C entry points accept: U, BG
    and R by ``plan_ok``, the grid by ``pairs_per_launch``, the shared-memory
    bytes by ``smem_bytes`` with each kernel's tile (``group_rows``,
    ``tile_rows``, ``tile_cols``), within the 227 KiB a CTA may take; the
    Python constants and helpers are the header's."""
    rules = _header_rules()
    for name, value in (("NT", port.WIDE_THREADS), ("NW", port.WIDE_WARPS),
                        ("KC_FWD", port.WIDE_KC["fwd"]), ("KC_BWD", port.WIDE_KC["bwd"]),
                        ("STAGES", port.WIDE_STAGES),
                        ("PAD", port.WIDE_PAD), ("TM", port.WIDE_TM), ("TN", port.WIDE_TN),
                        ("WARP_MB", port.WIDE_WARP_MB), ("WARP_NB", port.WIDE_WARP_NB),
                        ("GRANULE", port.WIDE_GRANULE)):
        assert rules[name] == value, name
    assert rules["NW"] * 32 == rules["NT"]
    plan = lstm_launch_plan(b, d, hidden, sms=H100_SMS)
    assert plan.threads == rules["NT"]
    for units, groups, ctas, launches, resident, smem, k, cols, kc in (
            (plan.units_fwd, plan.groups_fwd, plan.ctas_fwd, plan.launches_fwd,
             plan.resident_fwd, plan.smem_fwd, hidden, 4, rules["KC_FWD"]),
            (plan.units_bwd, plan.groups_bwd, plan.ctas_bwd, plan.launches_bwd,
             plan.resident_bwd, plan.smem_bwd, 4 * hidden, 1, rules["KC_BWD"])):
        per_pair, pairs = hidden // units, d * groups
        run = rules["pairs_per_launch"](pairs, per_pair, H100_SMS)
        assert ctas == run * per_pair <= H100_SMS and launches == -(-pairs // run)
        assert rules["plan_ok"](hidden, units, cols, resident, k, b, groups, kc)
        assert k % kc == 0
        n = cols * units
        tr = rules["tile_rows"](rules["group_rows"](b, groups))
        tc = rules["tile_cols"](n)
        assert (tr, tc) == (port._tile_rows(port._group_rows(b, groups)), port._tile_cols(n))
        assert rules["ldw"](n) % 32 in (8, 24) and rules["ldw"](n) == port._ldw(n)
        wm, wn, wk = rules["warps_m"](tr), rules["warps_n"](tc), rules["warps_k"](tr, tc, kc)
        assert wk == port._warps_k(tr, tc, kc) and 1 <= wk and wm * wn * wk <= rules["NW"]
        assert 16 * rules["WARP_MB"] * wm >= tr and 8 * rules["WARP_NB"] * wn >= tc
        streamed = int(resident < k)
        assert smem == rules["smem_bytes"](n, resident, tr, tc, streamed, kc) <= SMEM_OPTIN_BYTES
        assert smem == port.wide_smem_bytes(n, resident, tr, tc, streamed, kc)
        # all of the slice where it fits beside the ring, else as many whole
        # chunks as fit beside the rings
        assert streamed == int(rules["smem_bytes"](n, k, tr, tc, 0, kc) > SMEM_OPTIN_BYTES)
        assert resident == k or smem + 4 * rules["ldw"](n) * kc > SMEM_OPTIN_BYTES


@pytest.mark.parametrize("hidden,want", [(257, 320), (288, 320), (300, 320), (512, 512),
                                         (1000, 1024), (1024, 1024), (1025, 1088)])
def test_plan_hidden_rounds_a_wide_h_to_the_granule(hidden, want):
    assert plan_hidden(hidden) == want
    assert isinstance(lstm_launch_plan(128, 2, want, sms=H100_SMS), WidePlan)


@pytest.mark.parametrize("hidden", [300, 1000, 288])
def test_wide_plan_refuses_an_h_off_the_granule(hidden):
    """``lstm_scan_packed`` pads such an H first (``pad_hidden``)."""
    with pytest.raises(ValueError, match="multiple of 64 past 256"):
        lstm_launch_plan(128, 2, hidden, sms=H100_SMS)


def test_wide_zero_padding_is_exact_at_the_granule():
    """H=300 padded to 320, the width the wide kernels run it at: the twin
    on the padded inputs, sliced back, against the twin on the original
    ones (T=6, D=2, B=3): h within 1e-6 and the padded units 0; dxw and
    dwhh through the padding's autograd within 1e-6 of max(1, max |g|)."""
    xw, whh, g = (torch.from_numpy(a) for a in _case(6, 2, 3, 300, seed=300))
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    xw_p, whh_p = pad_hidden(a, w, plan_hidden(300))
    assert xw_p.shape == (6, 2, 3, 1280) and whh_p.shape == (2, 320, 1280)
    got = port.lstm_scan_reference(xw_p, whh_p)
    assert not got[..., 300:].any()
    got = got[..., :300]
    ra, rw = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    want = port.lstm_scan_reference(ra, rw)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    for name, u, v in zip(("dxw", "dwhh"), torch.autograd.grad(got, (a, w), g),
                          torch.autograd.grad(want, (ra, rw), g)):
        err = float((u - v).abs().max()) / max(1.0, float(v.abs().max()))
        assert err <= 1e-6, (name, err)


# The wide kernels' step product on the tensor cores, emulated on the CPU:
# split TF32 as csrc/rowtile.cuh splits (hi = x with the 13 low bits of its
# mantissa cleared, lo = x - hi, of which the tensor core reads the top bits
# alike), the three products lo*hi + hi*lo + hi*hi (each exact in f32), f32
# sums; the control takes one TF32 product, hi*hi.  Both recurrences run at
# the K2 widths over T=192 steps against float64.
LSTM_TOL = 1e-5      # chip_smoke.py's limits for #3 (h) and #4 (dxw, of max(1, max|ref|))
LSTM_BWD_TOL = 1e-5
SPLIT_MARGIN = 10    # the emulated split stays within a tenth of them
EMU_T, EMU_B = 192, 4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split_product(a: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    if a.dtype == torch.float64:  # the reference's exact product
        return a @ w
    ah, wh = _tf32(a), _tf32(w)
    if not split:
        return ah @ wh
    al, wl = _tf32(a - ah), _tf32(w - wh)
    return (al @ wh + ah @ wl) + ah @ wh


def _emulated_forward(xw, whh, split):
    """h, c and the gates of the recurrence in f32 with the emulated product."""
    hidden = whh.shape[-1] // 4
    h = xw.new_zeros(xw.shape[1:-1] + (hidden,))
    c = torch.zeros_like(h)
    hs, cs, gs = [], [], []
    for xw_t in xw.unbind(0):
        pre = xw_t + _split_product(h, whh, split)
        i, f, o = (torch.sigmoid(pre[..., k * hidden:(k + 1) * hidden]) for k in (0, 1, 3))
        g = torch.tanh(pre[..., 2 * hidden:3 * hidden])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], -1))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def _emulated_backward(whh, c, gates, g, split):
    """dxw of the backward recurrence in f32, with the kernels' formulas
    (csrc/lstm_scan_bwd.cu) and the emulated product dpre whh^T."""
    hidden = whh.shape[1]
    whh_t = whh.transpose(-1, -2).contiguous()
    dh_next = torch.zeros_like(g[0])
    dc_next = torch.zeros_like(g[0])
    dxw = torch.empty_like(gates)
    for t in range(g.shape[0] - 1, -1, -1):
        i, f, gg, o = gates[t].split(hidden, -1)
        c_prev = c[t - 1] if t > 0 else torch.zeros_like(c[t])
        dh = g[t] + dh_next
        th = torch.tanh(c[t])
        dcv = dh * o * (1 - th * th) + dc_next
        dc_next = dcv * f
        dpre = torch.cat([(dcv * gg) * i * (1 - i), (dcv * c_prev) * f * (1 - f),
                          (dcv * i) * (1 - gg * gg), (dh * th) * o * (1 - o)], -1)
        dxw[t] = dpre
        dh_next = _split_product(dpre, whh_t, split)
    return dxw


@pytest.mark.parametrize("split", [True, False], ids=["split", "single_tf32"])
@pytest.mark.parametrize("hidden", [512, 1024])
def test_split_tf32_forward_within_the_limit(hidden, split):
    """#3's recurrence with the wide kernels' product at H=512 and 1024,
    T=192, B=4, D=1: split TF32 within LSTM_TOL / 10 of float64; one TF32
    product (the control) misses LSTM_TOL, so the split is needed."""
    xw, whh, _ = _case(EMU_T, 1, EMU_B, hidden, seed=hidden + 7)
    want = port.lstm_scan_reference(torch.from_numpy(xw).double(),
                                    torch.from_numpy(whh).double())
    got, _, _ = _emulated_forward(torch.from_numpy(xw), torch.from_numpy(whh), split)
    err = float((got.double() - want).abs().max())
    if split:
        assert err <= LSTM_TOL / SPLIT_MARGIN, err
    else:
        assert err > LSTM_TOL, err


@pytest.mark.parametrize("split", [True, False], ids=["split", "single_tf32"])
@pytest.mark.parametrize("hidden", [512, 1024])
def test_split_tf32_backward_within_the_limit(hidden, split):
    """#4's recurrence (dxw) with the wide kernels' product at H=512 and
    1024, T=192, B=4, D=1, on the forward's float64 states rounded to f32:
    split TF32 within LSTM_BWD_TOL / 10 of float64 autograd (of max(1,
    max|ref|)); one TF32 product misses LSTM_BWD_TOL."""
    xw, whh, g = (torch.from_numpy(a) for a in _case(EMU_T, 1, EMU_B, hidden,
                                                      seed=hidden + 8))
    a = xw.double().requires_grad_()
    h64 = port.lstm_scan_reference(a, whh.double())
    want, = torch.autograd.grad(h64, a, g.double())
    with torch.no_grad():
        _, c64, gates64 = _emulated_forward(xw.double(), whh.double(), split=False)
    got = _emulated_backward(whh, c64.float(), gates64.float(), g, split)
    err = float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))
    if split:
        assert err <= LSTM_BWD_TOL / SPLIT_MARGIN, err
    else:
        assert err > LSTM_BWD_TOL, err
