"""Torch port, the LSTM recurrence past H=256 (the wide kernels): on the
CPU ``lstm_scan_packed`` and its gradient at H=300, 512 and 1024 against
JAX's interpret-mode ``lstm_scan_pallas_packed`` and ``jax.vjp``; the
double_lstm and convLSTM encoders at 512 units against JAX's on carried
weights; and ``lstm_launch_plan``'s wide plan (units per CTA, whh rows kept
in shared memory and streamed, shared-memory bytes), held to the rules it
reads from ``csrc/lstm_wide.cuh`` (checked again by the C entry points on
the card).  The kernels themselves are held at these widths by the gpu
tests of ``tests/test_torch_port_cuda.py``."""

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


def test_wide_plan_at_512_keeps_all_of_whh_in_shared_memory():
    """H=512 at B=128, D=2 (``--lstm_units 512`` packed, or the convLSTM's
    second biLSTM at ``--latent_dim 1024``): 8 units a CTA, 64 CTAs a
    direction, 128 on the card in one launch; each CTA's slice of whh (512
    x 32 forward, 2048 x 8 backward: 64 KiB) stays in shared memory."""
    plan = lstm_launch_plan(128, 2, 512, sms=H100_SMS)
    assert isinstance(plan, WidePlan)
    assert (plan.units_fwd, plan.ctas_fwd, plan.launches_fwd, plan.threads) == (8, 128, 1, 256)
    assert (plan.units_bwd, plan.ctas_bwd, plan.launches_bwd) == (8, 128, 1)
    assert (plan.resident_fwd, plan.resident_bwd) == (512, 2048)  # all of H and 4H
    assert 4 * 4 * plan.units_fwd * 512 == 4 * plan.units_bwd * 2048 == 64 * 1024  # bytes each
    assert (plan.smem_fwd, plan.smem_bwd) == (151552, 151552)


@pytest.mark.parametrize("hidden,want", [
    # H=512: the forward 4 units a CTA (128 CTAs), the backward its least, 8
    (512, (4, 8, 128, 64, 512, 2048, 118784, 151552)),
    # H=1024: 8 units a CTA each, 128 CTAs, each whole slice (32 KiB a row
    # group of whh) resident in 217,088 B, close to the 227 KiB a CTA may take
    (1024, (8, 8, 128, 128, 1024, 4096, 217088, 217088))])
def test_wide_plan_of_one_direction(hidden, want):
    """D=1 at B=128 (the double_lstm encoders at ``--lstm_units 512`` and
    ``1024``): units, CTAs, resident rows and shared memory of each kernel."""
    plan = lstm_launch_plan(128, 1, hidden, sms=H100_SMS)
    assert (plan.units_fwd, plan.units_bwd, plan.ctas_fwd, plan.ctas_bwd, plan.resident_fwd,
            plan.resident_bwd, plan.smem_fwd, plan.smem_bwd) == want
    assert (plan.launches_fwd, plan.launches_bwd) == (1, 1)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_wide_plan_at_1024_streams_part_of_whh():
    """H=1024 at B=128, D=2: both directions' whh (32 MiB) exceed the card's
    shared memory, so each CTA (16 units, 256 KiB of whh) keeps 576 of its
    1024 forward rows (2112 of 4096 backward) beside the rings of staged
    rows and streams the rest from L2 each step."""
    plan = lstm_launch_plan(128, 2, 1024, sms=H100_SMS)
    assert (plan.units_fwd, plan.ctas_fwd, plan.launches_fwd) == (16, 128, 1)
    assert (plan.units_bwd, plan.ctas_bwd, plan.launches_bwd) == (16, 128, 1)
    assert (plan.resident_fwd, plan.resident_bwd) == (576, 2112)
    fwd_row, bwd_row = 4 * 4 * plan.units_fwd, 4 * plan.units_bwd  # bytes of a row of each slice
    assert fwd_row * 1024 == bwd_row * 4096 == 256 * 1024
    # resident and streamed bytes of each CTA's slice, forward and backward
    assert (fwd_row * 576, fwd_row * (1024 - 576)) == (147456, 114688)
    assert (bwd_row * 2112, bwd_row * (4096 - 2112)) == (135168, 126976)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_wide_plan_runs_more_directions_than_sms_in_turn():
    """D recurrences whose CTAs do not fit the SMs at once run in launches
    of as many directions as fit: D=3 at H=512 takes 16 units a CTA (96
    CTAs), D=200 one CTA a direction in two launches of 132 and 68."""
    three = lstm_launch_plan(8, 3, 512, sms=H100_SMS)
    assert (three.units_fwd, three.ctas_fwd, three.launches_fwd) == (16, 96, 1)
    assert (three.units_bwd, three.ctas_bwd, three.launches_bwd) == (16, 96, 1)
    many = lstm_launch_plan(8, 200, 320, sms=H100_SMS)
    assert (many.units_fwd, many.ctas_fwd, many.launches_fwd) == (320, 132, 2)
    assert (many.units_bwd, many.ctas_bwd, many.launches_bwd) == (320, 132, 2)


def _c_expr(expr: str, env: dict) -> int:
    """An integer expression of the header (names, calls of its rule
    functions, + - * /, ``a ? b : c`` and ``==``/``&&``/``<=`` tests),
    evaluated as C does for non-negative ints."""
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
    """The plan the wrapper computes is one the C entry points accept: U and
    R by ``plan_ok``, the grid by ``dirs_per_launch``, the shared-memory
    bytes by ``smem_bytes`` with each kernel's tiling (``col_groups``,
    ``row_groups``), within the 227 KiB a CTA may take; the Python constants
    are the header's."""
    rules = _header_rules()
    for name, value in (("NT", port.WIDE_THREADS), ("TILE", port.WIDE_TILE),
                        ("PAD", port.WIDE_PAD), ("KC", port.WIDE_KC),
                        ("STAGES", port.WIDE_STAGES), ("GRANULE", port.WIDE_GRANULE),
                        ("MAX_RG", port.WIDE_MAX_RG), ("MAX_CG", port.WIDE_MAX_CG)):
        assert rules[name] == value, name
    plan = lstm_launch_plan(b, d, hidden, sms=H100_SMS)
    assert plan.threads == rules["NT"]
    kc = rules["KC"]
    for units, ctas, launches, k, n, resident, smem in (
            (plan.units_fwd, plan.ctas_fwd, plan.launches_fwd, hidden, 4 * plan.units_fwd,
             plan.resident_fwd, plan.smem_fwd),
            (plan.units_bwd, plan.ctas_bwd, plan.launches_bwd, 4 * hidden, plan.units_bwd,
             plan.resident_bwd, plan.smem_bwd)):
        per_dir = hidden // units
        dirs = rules["dirs_per_launch"](d, per_dir, H100_SMS)
        assert ctas == dirs * per_dir <= H100_SMS and launches == -(-d // dirs)
        assert rules["plan_ok"](hidden, units, resident, k, kc)
        cg = rules["col_groups"](n)
        rg = rules["row_groups"](b, cg)
        assert 1 <= rules["k_splits"](kc, cg, rg) and cg * rg <= rules["NT"]
        streamed = int(resident < k)
        assert smem == rules["smem_bytes"](n, resident, kc, cg, rg, streamed) <= SMEM_OPTIN_BYTES
        # all of the slice where it fits beside the ring, else as many whole
        # chunks as fit beside the rings
        assert streamed == int(rules["smem_bytes"](n, k, kc, cg, rg, 0) > SMEM_OPTIN_BYTES)
        assert resident == k or smem + 4 * n * kc > SMEM_OPTIN_BYTES


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
