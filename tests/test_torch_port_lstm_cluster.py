"""Torch port, the LSTM recurrence at the flagship's width and its launch
plan: ``lstm_scan_packed`` forward and its gradient at H=128 and H=256 on
the CPU against JAX's interpret-mode ``lstm_scan_pallas_packed`` and
``jax.vjp``, and ``lstm_launch_plan``, which sizes the thread-block clusters
of kernels #3 and #4 (checked again by ``csrc/lstm_cluster.cuh`` and, at
H=256, ``csrc/lstm_mid.cuh`` on the card), for every H the cluster kernels
are built for (4 ... 256), and the
zero-padding that takes any other H to the next H the kernels run (past 256
a multiple of 32, the wide kernels: ``tests/test_torch_port_lstm_wide.py``).  The kernels themselves
are held at those shapes by the gpu tests of
``tests/test_torch_port_cuda.py``."""

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
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (
    PLAN_HIDDEN,
    lstm_launch_plan,
    lstm_scan_packed,
    lstm_scan_reference,
    pad_hidden,
    plan_hidden,
)

LSTM_ATOL = 1e-6       # forward, as tests/test_torch_port_kernels.py
LSTM_GRAD_ATOL = 1e-5  # gradient, as tests/test_torch_port_training_kernels.py
HEADER = Path(port.__file__).resolve().parent.parent / "csrc" / "lstm_cluster.cuh"
MID_HEADER = HEADER.with_name("lstm_mid.cuh")
# an H100 SXM: its SMs, and the shared memory and 32-bit registers of each
H100_SMS, SM_SMEM_BYTES, SM_REGISTERS = 132, 233_472, 65_536


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


def test_h256_plan_is_clusters_of_eight():
    """H=256 (``--lstm_units 256``): clusters of 8 CTAs (the portable
    size) of 32 units and 256 threads (``csrc/lstm_mid.cuh``), tiles of 24
    batch rows at B=128, D=2 (96 CTAs, 12 clusters) and of 16 at D=1 (64
    CTAs, 8 clusters), one wave either way (16-row tiles at D=2 would take
    16 clusters, and an H100 holds 15 at once)."""
    plan = lstm_launch_plan(128, 2, 256)
    assert isinstance(plan, port.MidPlan)
    assert (plan.cluster, plan.batch_tile, plan.threads, plan.ctas, plan.waves) == (
        8, 24, 256, 96, 1)
    one = lstm_launch_plan(128, 1, 256)
    assert (one.batch_tile, one.ctas, one.waves) == (16, 64, 1)
    assert max(plan.smem_fwd, plan.smem_bwd, one.smem_bwd) <= SMEM_OPTIN_BYTES


def _mid_rules() -> dict:
    """``csrc/lstm_mid.cuh``'s constants, and its shared-memory bytes of
    each kernel as functions of the batch tile."""
    text = MID_HEADER.read_text()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        env[name] = _c_value(expr.split("//")[0], env)
    for kind in ("fwd", "bwd"):
        expr = re.search(rf"{kind}_smem_bytes\(int bt\) \{{\s*return (.+?);", text, re.S)[1]
        expr = re.sub(r"\s+", " ", expr)
        env[kind] = lambda bt, e=expr: _c_value(e, dict(env, bt=bt))
    # plan_ok's rule on the batch tile: the tiles the kernels are built for
    rule = re.search(r"plan_ok\(int n, int bt, int threads\) \{\s*return (.+?);", text, re.S)[1]
    rule = re.sub(r"\s+", " ", rule).replace("&&", "and").replace("||", "or")
    env["plan_ok"] = lambda bt: eval(rule.replace("/", "//"), {},
                                     dict(env, n=env["N"], threads=env["NT"], bt=bt))
    return env


@pytest.mark.parametrize("d", [1, 2])
def test_h256_plan_is_one_wave_by_the_headers_residency(d):
    """At B=128 every CTA of the H=256 plan is resident at once, by the
    header's own arithmetic: each kernel's shared memory (more than half an
    SM's) and registers (``__launch_bounds__(threads, 1)``: what a thread may
    take of the SM's) put one CTA on an SM, a cluster of N CTAs then takes N SMs, and the
    plan's clusters are at most the 15 an H100 holds (``MID_WAVE_CLUSTERS``,
    what ``cudaOccupancyMaxActiveClusters`` reports on the card) and their
    CTAs at most its 132 SMs."""
    rules = _mid_rules()
    plan = lstm_launch_plan(128, d, 256)
    # what __launch_bounds__(threads, 1) lets ptxas give a thread
    regs = min(255, SM_REGISTERS // plan.threads)
    for smem in (rules["fwd"](plan.batch_tile), rules["bwd"](plan.batch_tile)):
        per_sm = min(SM_SMEM_BYTES // (smem + 1024), SM_REGISTERS // (plan.threads * regs))
        assert per_sm == 1 and smem <= SMEM_OPTIN_BYTES
    clusters = plan.ctas // rules["N"]
    assert clusters <= port.MID_WAVE_CLUSTERS and clusters * rules["N"] <= H100_SMS
    assert port.MID_WAVE_CLUSTERS * rules["N"] <= H100_SMS
    assert plan.waves == 1


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("b", [1, 37, 130])
def test_h256_plan_covers_ragged_batches(b, d):
    """H=256 at ragged batches: every row in some tile, the last tile
    ragged, the smallest tile whose clusters fit one wave (else the largest,
    in as many waves as the clusters need), each kernel within the card's
    shared memory."""
    plan = lstm_launch_plan(b, d, 256)
    tiles = plan.ctas // (d * plan.cluster)
    assert (tiles - 1) * plan.batch_tile < b <= tiles * plan.batch_tile
    fits = [t for t in port.MID_TILES if d * -(-b // t) <= port.MID_WAVE_CLUSTERS]
    assert plan.batch_tile == (fits[0] if fits else port.MID_TILES[-1])
    assert plan.waves == -(-(d * tiles) // port.MID_WAVE_CLUSTERS)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


@pytest.mark.parametrize("d", [1, 2])
def test_h256_forward_matches_pallas_interpret(d):
    """H=256 (``--lstm_units 256``; ``--latent_dim 512``'s second biLSTM
    at D=2): the port's recurrence against JAX's interpret-mode kernel."""
    xw, whh, _ = _case(6, d, 3, 256, seed=30 + d)
    want = np.asarray(lstm_scan_pallas_packed(jnp.asarray(xw), jnp.asarray(whh), 256, True))
    got = lstm_scan_packed(torch.from_numpy(xw), torch.from_numpy(whh))
    assert got.shape == (6, d, 3, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=LSTM_ATOL)


@pytest.mark.parametrize("d", [1, 2])
def test_h256_gradient_matches_jax_vjp(d):
    """H=256: dxw and dwhh of the port's CPU path against ``jax.vjp`` of the
    interpret-mode Pallas recurrence."""
    xw, whh, g = _case(6, d, 3, 256, seed=40 + d)
    out, vjp = jax.vjp(lambda a, w: lstm_scan_pallas_packed(a, w, 256, True),
                       jnp.asarray(xw), jnp.asarray(whh))
    jdxw, jdwhh = vjp(jnp.asarray(g))
    a = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(whh).requires_grad_()
    h = lstm_scan_packed(a, w)
    dxw, dwhh = torch.autograd.grad(h, (a, w), torch.from_numpy(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(out), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(jdxw), atol=LSTM_GRAD_ATOL)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(jdwhh), atol=LSTM_GRAD_ATOL)


@pytest.mark.parametrize("b", [1, 37, 130])
@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128, 256])
def test_plan_covers_ragged_batches(hidden, b):
    """Every batch row in some tile, the last tile ragged, for every H; up
    to 128 a tile holds one owner thread per (row, unit), at 256 two to four
    n8 blocks of rows."""
    plan = lstm_launch_plan(b, 2, hidden)
    tiles = plan.ctas // (2 * plan.cluster)
    assert (tiles - 1) * plan.batch_tile < b <= tiles * plan.batch_tile
    if hidden == 256:
        assert plan.batch_tile in port.MID_TILES
    else:
        assert plan.batch_tile * (hidden // plan.cluster) == port.OWNERS
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES


def test_plan_with_one_direction():
    two, one = lstm_launch_plan(128, 2, 128), lstm_launch_plan(128, 1, 128)
    assert one.ctas * 2 == two.ctas
    assert one._replace(ctas=two.ctas) == two


@pytest.mark.parametrize("hidden", [12, 6, 0, 96])
def test_plan_refuses_h_not_dividing_128(hidden):
    """Up to 256 the plan takes only the H the cluster kernels are built
    for (4, 8, ..., 128 and 256); the wrapper pads every other H first."""
    with pytest.raises(ValueError, match=r"takes H in \(4, 8, 16, 32, 64, 128, 256\)"):
        lstm_launch_plan(128, 2, hidden)


def test_plan_of_512_is_the_wide_family():
    """H=512 (which no cluster of the portable size holds) gets the wide
    kernels' plan: one persistent grid of 128 CTAs, the forward's of 16 units
    and 64 batch rows each."""
    plan = lstm_launch_plan(128, 2, 512, sms=132)
    assert isinstance(plan, port.WidePlan)
    assert (plan.units_fwd, plan.groups_fwd, plan.ctas_fwd) == (16, 2, 128)


@pytest.mark.parametrize("hidden,want", [(1, 4), (2, 4), (4, 4), (5, 8), (100, 128),
                                         (128, 128), (129, 256), (200, 256), (256, 256)])
def test_plan_hidden_is_the_next_built_size(hidden, want):
    assert plan_hidden(hidden) == want and want in PLAN_HIDDEN


@pytest.mark.parametrize("hidden", [257, 300, 384, 513, 1024, 5000])
def test_plan_hidden_maps_past_256_into_the_wide_family(hidden):
    """Every H past 256 runs at the next multiple of 64 (fewer than 64
    units of padding), which the wide kernels' plan takes."""
    hp = plan_hidden(hidden)
    assert hp % port.WIDE_GRANULE == 0 and 0 <= hp - hidden < port.WIDE_GRANULE
    assert isinstance(lstm_launch_plan(128, 2, hp, sms=132), port.WidePlan)


@pytest.mark.parametrize("hidden", [2, 100, 200, 256, 300, 1000])
def test_zero_padding_is_exact_forward_and_gradients(hidden):
    """The twin on the inputs padded to ``plan_hidden(H)`` and sliced back
    to H against the twin on the original inputs (T=6, D=2, B=3): h within
    1e-6 (f32 products of another blocking), and dxw and dwhh, through the
    padding's autograd, within 1e-6 of max(1, max |g|); every gradient that
    reaches a padded unit is dropped by the slice."""
    xw, whh, g = (torch.from_numpy(a) for a in _case(6, 2, 3, hidden, seed=hidden))
    hp = plan_hidden(hidden)
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    xw_p, whh_p = pad_hidden(a, w, hp)
    assert xw_p.shape == (6, 2, 3, 4 * hp) and whh_p.shape == (2, hp, 4 * hp)
    got = lstm_scan_reference(xw_p, whh_p)
    assert not got[..., hidden:].any()  # padded units stay 0
    got = got[..., :hidden]
    ra, rw = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    want = lstm_scan_reference(ra, rw)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    for name, u, v in zip(("dxw", "dwhh"), torch.autograd.grad(got, (a, w), g),
                          torch.autograd.grad(want, (ra, rw), g)):
        err = float((u - v).abs().max()) / max(1.0, float(v.abs().max()))
        assert err <= 1e-6, (name, err)


def test_plan_constants_match_the_cuda_header():
    """The plan's thread counts are the ones the C entry points check."""
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", text).group(1))

    assert const("OWNERS") == port.OWNERS
    assert const("EG") == port.EXCHANGE_GROUPS
    assert const("MAX_CLUSTER") * port.MAX_UNITS == port.MAX_CLUSTER_HIDDEN
    # the H=256 kernels (csrc/lstm_mid.cuh)
    mid = _mid_rules()
    assert mid["H"] == port.MAX_CLUSTER_HIDDEN and mid["N"] == port.MID_CLUSTER
    assert mid["U"] == port.MAX_UNITS and mid["NT"] == port.MID_THREADS
    assert tuple(8 * nb for nb in range(mid["MIN_NB"], mid["MAX_NB"] + 1)) == port.MID_TILES
    assert (mid["LDH"], mid["LDP"], mid["SLICE"]) == (port.MID_LDH, port.MID_LDP,
                                                      port.MID_SLICE)


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


@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128, 256])
def test_plan_passes_the_cuda_headers_rules(hidden):
    """The plan the wrapper computes is one the C entry points accept:
    ``plan_units``'s rules with each kernel's threads and rows per product
    thread as the header's ``Fwd<H>`` and ``Bwd<H>`` define them, and the
    shared-memory bytes of ``fwd_smem_bytes`` and ``bwd_smem_bytes``; at
    H=256 ``csrc/lstm_mid.cuh``'s ``plan_ok`` and shared-memory bytes, for
    both tiles."""
    if hidden == 256:
        mid = _mid_rules()
        for d in (1, 2):
            for tile in port.MID_TILES:
                plan = port.mid_plan(130, d, tile)
                assert (plan.cluster, plan.threads) == (mid["N"], mid["NT"])
                assert mid["plan_ok"](plan.batch_tile)
                assert plan.smem_fwd == mid["fwd"](tile) and plan.smem_bwd == mid["bwd"](tile)
                assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES
                # the forward's warps own 4 units each, the backward's 32
                assert mid["NW"] * 4 == mid["U"] and mid["NW"] * 32 == mid["H"]
        return
    rules = _header_rules(hidden)
    plan = lstm_launch_plan(130, 2, hidden)
    units = hidden // plan.cluster
    assert 1 <= plan.cluster <= rules["Fwd"]["MAX_CLUSTER"] and hidden % plan.cluster == 0
    assert units >= 4 and units % 4 == 0 and port.OWNERS % units == 0
    assert plan.batch_tile == port.OWNERS // units
    assert plan.threads == rules["threads"]
    for struct in ("Fwd", "Bwd"):
        consts = rules[struct]
        assert consts["NT"] == plan.threads
        assert 1 <= consts["GROUPS"] <= port.EXCHANGE_GROUPS
        assert plan.batch_tile % (consts["GROUPS"] * consts["RPT"]) == 0, struct
    # the forward's h stores: 4 units' k groups in one warp
    fwd = rules["Fwd"]
    assert 4 * fwd["KG"] <= 32
    # the weight slice a thread holds: at most 64 floats (registers)
    assert fwd["KPT"] * 4 <= 64
    bwd = rules["Bwd"]
    assert bwd["UPT"] * bwd["CPT"] <= 64
    assert plan.smem_fwd == rules["fwd"](plan.batch_tile)
    assert plan.smem_bwd == rules["bwd"](plan.batch_tile)
    assert max(plan.smem_fwd, plan.smem_bwd) <= SMEM_OPTIN_BYTES
