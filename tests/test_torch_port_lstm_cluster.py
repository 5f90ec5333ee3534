"""Torch port, the LSTM recurrence at the flagship's width and its launch
plan: ``lstm_scan_packed`` forward and its gradient at H=128 on the CPU
against JAX's interpret-mode ``lstm_scan_pallas_packed`` and ``jax.vjp``,
and ``lstm_launch_plan``, which sizes the thread-block clusters of kernels
#3 and #4 (checked again by ``csrc/lstm_cluster.cuh`` on the card)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.ops.pallas_lstm import lstm_scan_pallas_packed
from transformer_clip_eeg_tpu_torch.ops.fused_block import SMEM_OPTIN_BYTES
from transformer_clip_eeg_tpu_torch.ops import lstm_scan as port
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import lstm_launch_plan, lstm_scan_packed

LSTM_ATOL = 1e-6       # forward, as tests/test_torch_port_kernels.py
LSTM_GRAD_ATOL = 1e-5  # gradient, as tests/test_torch_port_training_kernels.py
HEADER = Path(port.__file__).resolve().parent.parent / "csrc" / "lstm_cluster.cuh"


def _case(t, d, b, hidden, seed):
    """xw, whh at torch's init scale U(+-1/sqrt(H)), and an upstream gradient."""
    rng = np.random.default_rng(seed)
    xw = (0.5 * rng.standard_normal((t, d, b, 4 * hidden))).astype(np.float32)
    lim = hidden ** -0.5
    whh = rng.uniform(-lim, lim, (d, hidden, 4 * hidden)).astype(np.float32)
    g = rng.standard_normal((t, d, b, hidden)).astype(np.float32)
    return xw, whh, g


@pytest.mark.parametrize("t,b", [(16, 3), (5, 1)])
def test_flagship_width_forward_matches_pallas_interpret(t, b):
    """H=128, both directions packed, as the speech encoder's first biLSTM."""
    xw, whh, _ = _case(t, 2, b, 128, seed=t)
    want = np.asarray(lstm_scan_pallas_packed(jnp.asarray(xw), jnp.asarray(whh), 128, True))
    got = lstm_scan_packed(torch.from_numpy(xw), torch.from_numpy(whh))
    assert got.shape == (t, 2, b, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=LSTM_ATOL)


def test_flagship_width_gradient_matches_jax_vjp():
    """H=128: dxw and dwhh of the port's CPU path (autograd through the twin)
    against ``jax.vjp`` of the interpret-mode Pallas recurrence."""
    xw, whh, g = _case(16, 2, 3, 128, seed=7)
    out, vjp = jax.vjp(lambda a, w: lstm_scan_pallas_packed(a, w, 128, True),
                       jnp.asarray(xw), jnp.asarray(whh))
    jdxw, jdwhh = vjp(jnp.asarray(g))
    a = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(whh).requires_grad_()
    h = lstm_scan_packed(a, w)
    dxw, dwhh = torch.autograd.grad(h, (a, w), torch.from_numpy(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(out), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(jdxw), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(jdwhh), atol=LSTM_GRAD_ATOL)


def test_flagship_plan_is_one_wave_of_clusters():
    """H=128 at B=128, D=2: clusters of 4 CTAs of 32 units and 8 rows, 128
    CTAs for 132 SMs, each well inside the 227 KB of shared memory."""
    plan = lstm_launch_plan(128, 2, 128)
    assert (plan.cluster, plan.batch_tile, plan.ctas) == (4, 8, 128)
    assert plan.threads == 512
    assert 0 < plan.smem_fwd <= plan.smem_bwd <= SMEM_OPTIN_BYTES


def test_h4_plan_is_one_cta_per_recurrence():
    plan = lstm_launch_plan(128, 2, 4)
    assert (plan.cluster, plan.batch_tile, plan.threads, plan.ctas) == (1, 64, 256, 4)
    assert plan.smem_bwd <= SMEM_OPTIN_BYTES


@pytest.mark.parametrize("b", [1, 37, 130])
@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128])
def test_plan_covers_ragged_batches(hidden, b):
    """Every batch row in some tile, the last tile ragged, for every H."""
    plan = lstm_launch_plan(b, 2, hidden)
    tiles = plan.ctas // (2 * plan.cluster)
    assert (tiles - 1) * plan.batch_tile < b <= tiles * plan.batch_tile
    assert plan.batch_tile * (hidden // plan.cluster) == port.OWNERS
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_plan_with_one_direction():
    two, one = lstm_launch_plan(128, 2, 128), lstm_launch_plan(128, 1, 128)
    assert one.ctas * 2 == two.ctas
    assert one._replace(ctas=two.ctas) == two


@pytest.mark.parametrize("hidden", [12, 6, 256, 0, 96])
def test_plan_refuses_h_not_dividing_128(hidden):
    with pytest.raises(ValueError, match="multiple of 4 dividing 128"):
        lstm_launch_plan(128, 2, hidden)


def test_plan_constants_match_the_cuda_header():
    """The plan's thread counts are the ones the C entry points check."""
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", text).group(1))

    assert const("OWNERS") == port.OWNERS
    assert const("EG") == port.EXCHANGE_GROUPS


def _c_value(expr: str, env: dict) -> int:
    """An integer constant expression of the header (names, + - * /, and
    one ``a ? b : c``), evaluated as C does for non-negative ints."""
    expr = expr.strip()
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if m:
        return _c_value(m[2] if _c_value(m[1], env) else m[3], env)
    expr = re.sub(r"sizeof\(float\)", "4", re.sub(r"sizeof\(uint64_t\)", "8", expr))
    return eval(expr.replace("(size_t)", "").replace("/", "//"), {}, dict(env))


def _header_rules(hidden: int) -> dict:
    """``Fwd<H>`` and ``Bwd<H>``'s constants, the thread count and the
    shared-memory sizes as ``csrc/lstm_cluster.cuh`` defines them."""
    text = HEADER.read_text()
    env = {"H": hidden}
    for name in ("OWNERS", "MAX_CLUSTER", "EG"):
        env[name] = int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    threads = re.search(r"constexpr int threads\(\) \{\s*return (.+?);", text)[1]
    env["NT"] = _c_value(threads, env)
    rules = {"threads": env["NT"]}
    for struct in ("Fwd", "Bwd"):
        body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S)[1]
        consts = dict(env)
        for name, expr in re.findall(r"static constexpr int (\w+) = ([^,;]+)[,;]", body):
            if name != "NT":
                consts[name] = _c_value(expr, consts)
        rules[struct] = consts
    env["BARRIER_BYTES"] = _c_value(
        re.search(r"BARRIER_BYTES = (.+?);", text)[1], env)
    for kind in ("fwd", "bwd"):
        expr = re.search(rf"{kind}_smem_bytes\(int H, int bt\) \{{\s*return (.+?);", text)[1]
        rules[kind] = lambda bt, e=expr: _c_value(e, dict(env, bt=bt))
    return rules


@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128])
def test_plan_passes_the_cuda_headers_rules(hidden):
    """The plan the wrapper computes is one the C entry points accept:
    ``plan_units``'s rules with each kernel's threads and rows per product
    thread as the header's ``Fwd<H>`` and ``Bwd<H>`` define them, and the
    shared-memory bytes of ``fwd_smem_bytes`` and ``bwd_smem_bytes``."""
    rules = _header_rules(hidden)
    plan = lstm_launch_plan(130, 2, hidden)
    units = hidden // plan.cluster
    assert 1 <= plan.cluster <= rules["Fwd"]["MAX_CLUSTER"] and hidden % plan.cluster == 0
    assert units >= 4 and units % 4 == 0 and port.OWNERS % units == 0
    assert plan.batch_tile == port.OWNERS // units
    assert plan.threads == rules["threads"]
    for struct in ("Fwd", "Bwd"):
        assert rules[struct]["NT"] == plan.threads
        assert plan.batch_tile % (port.EXCHANGE_GROUPS * rules[struct]["RPT"]) == 0, struct
    assert plan.smem_fwd == rules["fwd"](plan.batch_tile)
    assert plan.smem_bwd == rules["bwd"](plan.batch_tile)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES
