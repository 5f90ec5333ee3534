"""Torch port on the card: each CUDA kernel against its plain twin (the
backward kernels against autograd through the twins), gradients through
the kernels against the CPU, and a card session against a CPU session.
Marked ``gpu``; each test skips where torch sees no CUDA card.  On a card
without JAX installed: ``python -m pytest tests/test_torch_port_cuda.py -q
--noconftest`` (``tests/conftest.py`` imports JAX)."""

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu_torch.ops.fused_block import (
    MAX_KERNEL_T,
    DropoutConfig,
    drop_args,
    fused_block_backward,
    fused_block_backward_reference,
    fused_block_forward_cuda,
    fused_block_saved_reference,
    fused_transformer_block,
    fused_transformer_block_reference,
)
from transformer_clip_eeg_tpu_torch.ops.fused_conv import (
    conv1d_reference,
    conv1d_same,
    fused_basic_block,
    fused_basic_block_reference,
    fused_conv_backward,
    fused_conv_forward_cuda,
)
from transformer_clip_eeg_tpu_torch.ops.lstm import LSTM
from transformer_clip_eeg_tpu_torch import _build
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (
    MID_TILES,
    WIDE_KC,
    MidPlan,
    WidePlan,
    lstm_launch_plan,
    mid_coresident,
    mid_plan,
    lstm_scan_backward,
    lstm_scan_packed,
    lstm_scan_reference,
    wide_smem_bytes,
)
from transformer_clip_eeg_tpu_torch.serve import InferenceSession, build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_fused_block_kernel_matches_twin(cuda):
    gen = torch.Generator().manual_seed(0)
    e, f = 64, 256
    shapes = [(e,), (e,), (e, e), (e, e), (e, e), (e,), (e,), (e,), (e, e), (e,),
              (e,), (e,), (f, e), (f,), (e, f), (e,)]
    params = [(0.1 * torch.randn(s, generator=gen)).to(cuda) for s in shapes]
    x = torch.randn(16, 192, e, generator=gen).to(cuda)
    before = fused_transformer_block.launches
    got = fused_transformer_block(x, params, 8, 8.0)
    torch.cuda.synchronize()
    assert fused_transformer_block.launches == before + 1
    want = fused_transformer_block_reference(x, params, 8, 8.0)
    assert float((got - want).abs().max()) <= 1e-4


def test_fused_block_kernel_refuses_long_windows(cuda):
    e, f = 64, 256
    shapes = [(e,), (e,), (e, e), (e, e), (e, e), (e,), (e,), (e,), (e, e), (e,),
              (e,), (e,), (f, e), (f,), (e, f), (e,)]
    params = [torch.zeros(s, device=cuda) for s in shapes]
    before = fused_transformer_block.launches
    assert MAX_KERNEL_T == 1699
    with pytest.raises(ValueError, match="T <= 1699; T=1700"):
        fused_transformer_block(torch.zeros(2, 1700, e, device=cuda), params, 8, 8.0)
    with pytest.raises(ValueError, match="E=64"):
        fused_transformer_block(torch.zeros(2, 16, 32, device=cuda), params, 8, 8.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_transformer_block(torch.zeros(2, e, 256, device=cuda).transpose(1, 2), params, 8,
                                8.0)
    assert fused_transformer_block.launches == before
    # the C entry point alone refuses a window its attention cannot hold
    lib = _build.load()
    small = torch.zeros(64, device=cuda)
    ptrs = (torch.zeros(16, dtype=torch.int64) + small.data_ptr()).numpy()
    for bf16_mode in (0, 1):
        rc = lib.tce_fused_block_fwd(small.data_ptr(), small.data_ptr(), ptrs.ctypes.data, 1,
                                     4096, 64, 8, 256, 0.125, *drop_args(DropoutConfig(), 1),
                                     small.data_ptr(), 0, bf16_mode,
                                     torch.cuda.current_stream().cuda_stream)
        assert rc == 1, bf16_mode  # cudaErrorInvalidValue
    torch.cuda.synchronize()


@pytest.mark.parametrize("hidden,d", [(128, 2), (4, 2), (256, 2), (256, 1)],
                         ids=["128", "4", "256-D2", "256-D1"])
def test_lstm_kernel_matches_twin(cuda, hidden, d):
    gen = torch.Generator().manual_seed(1)
    xw = (0.5 * torch.randn(192, d, 37, 4 * hidden, generator=gen)).to(cuda)
    whh = (0.1 * torch.randn(d, hidden, 4 * hidden, generator=gen)).to(cuda)
    h, c = lstm_scan_packed(xw, whh, return_c=True)
    torch.cuda.synchronize()
    want_h, want_c = lstm_scan_reference(xw, whh, return_c=True)
    assert float((h - want_h).abs().max()) <= 1e-5
    assert float((c - want_c).abs().max()) <= 1e-5


def test_card_session_matches_cpu_session(cuda):
    cfg = TrainConfig(attention_depth=2)
    gpu = InferenceSession(build_model_from_config(cfg, 8, device=cuda), chunk=4,
                           device=cuda)
    cpu = InferenceSession(build_model_from_config(cfg, 8, device="cpu"), chunk=4,
                           device="cpu")
    rng = np.random.default_rng(2)
    eeg = rng.standard_normal((5, cfg.window_length, 64)).astype(np.float32)
    speech = rng.standard_normal((5, cfg.window_length, 1024)).astype(np.float32)
    np.testing.assert_allclose(gpu.embed_eeg(eeg), cpu.embed_eeg(eeg), atol=1e-3)
    np.testing.assert_allclose(gpu.embed_speech(speech), cpu.embed_speech(speech), atol=1e-3)


def _block_inputs(b, t, seed, cuda):
    gen = torch.Generator().manual_seed(seed)
    e, f = 64, 256
    shapes = [(e,), (e,), (e, e), (e, e), (e, e), (e,), (e,), (e,), (e, e), (e,),
              (e,), (e,), (f, e), (f,), (e, f), (e,)]
    params = [(0.1 * torch.randn(s, generator=gen)).to(cuda) for s in shapes]
    params[0] += 1.0
    params[10] += 1.0
    x = torch.randn(b, t, e, generator=gen).to(cuda)
    g = torch.randn(b, t, e, generator=gen).to(cuda)
    return x, params, g


def _err(got, want):
    """max abs error over max(1, max |want|): relative for large gradients,
    absolute for ones that are zero in exact arithmetic (the key bias's
    gradient is: softmax ignores a shift shared by every key)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


# (B, T): single rows, ragged row tiles, ragged key tiles and query pairs,
# the first kernel's limit and one past it, 4 s and 5 s windows, the flagship
# batch, and the longest window the kernels take
FWD_CASES = [(b, t) for t in (1, 7, 31, 33, 192, 218, 219, 256, 320) for b in (1, 5, 37)]
FWD_CASES += [(128, 192), (2, MAX_KERNEL_T)]


@pytest.mark.parametrize("b,t", FWD_CASES, ids=[f"B{b}T{t}" for b, t in FWD_CASES])
def test_fused_block_forward_at_ragged_shapes(cuda, b, t):
    """Kernel #1 in eval and in training (dropout 0.5/0.5) against the twin,
    and what it saves for #2 (q, k, v, the dropped-out context, x1, the
    log-sum-exp) against the twin's intermediates."""
    x, params, _ = _block_inputs(b, t, 60 + b, cuda)
    drop = DropoutConfig(True, 21, 0.5, 0.5)
    before = fused_transformer_block.launches
    with torch.no_grad():
        got = fused_transformer_block(x, params, 8, 8.0)
        got_tr, saved = fused_block_forward_cuda(x, params, 8, 8.0, drop, save=True)
        torch.cuda.synchronize()
        assert fused_transformer_block.launches == before + 2
        want = fused_transformer_block_reference(x, params, 8, 8.0)
        want_tr = fused_transformer_block_reference(x, params, 8, 8.0, *drop)
        want_saved = fused_block_saved_reference(x, params, 8, 8.0, drop)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((got_tr - want_tr).abs().max()) <= 1e-4
    assert saved.shape == want_saved.shape
    n = x.numel()
    for i, name in enumerate(("q", "k", "v", "ctx", "x1", "lse")):
        part = slice(i * n, (i + 1) * n if i < 5 else None)
        assert float((saved[part] - want_saved[part]).abs().max()) <= 1e-4, name


def test_fused_block_forward_repeats_bit_for_bit(cuda):
    """No atomics and a fixed summation order in kernel #1: two calls give the
    same bits in out and in everything saved, in eval and in training."""
    x, params, _ = _block_inputs(37, 192, 61, cuda)
    for drop in (DropoutConfig(), DropoutConfig(True, 9, 0.5, 0.5)):
        runs = [fused_block_forward_cuda(x, params, 8, 8.0, drop, save=True) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])


def test_fused_block_gradient_at_t256_matches_cpu(cuda):
    """A 4 s window through ``FusedBlockFunction`` on the card (kernels #1 and
    #2) against the same function on the CPU (the twin and autograd through
    it), dropout on: the output, dx and the 16 parameter gradients."""
    x, params, g = _block_inputs(3, 256, 62, "cpu")
    kw = dict(training=True, seed=31, drop_p=0.5, ffn_drop_p=0.5)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [v.to(dev).requires_grad_() for v in (x, *params)]
        out = fused_transformer_block(leaves[0], leaves[1:], 8, 8.0, **kw)
        grads[str(dev)] = [out.detach().cpu()] + [
            v.cpu() for v in torch.autograd.grad(out, leaves, g.to(dev))]
    for i, (a, w) in enumerate(zip(grads[str(cuda)], grads["cpu"])):
        assert _err(a, w) <= 1e-4, (i, _err(a, w))


@pytest.mark.parametrize("b", [16, 6])
def test_fused_block_training_forward_matches_twin(cuda, b):
    """Kernel #1 with dropout draws the twin's masks: B=16 and B=6 take the
    batch tiles 8 and 2."""
    x, params, _ = _block_inputs(b, 192, 3, cuda)
    kw = dict(training=True, seed=77, drop_p=0.5, ffn_drop_p=0.5)
    got = fused_transformer_block(x, params, 8, 8.0, **kw)
    torch.cuda.synchronize()
    want = fused_transformer_block_reference(x, params, 8, 8.0, **kw)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("b,t", [(16, 192), (3, 50)], ids=["full", "ragged"])
@pytest.mark.parametrize("training", [True, False], ids=["dropout", "eval"])
def test_fused_block_backward_matches_autograd(cuda, training, b, t):
    """Kernel #2 (through the autograd Function) against autograd through the
    twin: dx and the 16 parameter gradients.  B=3, T=50 leaves a partial
    32-row tile and a partial warp of keys."""
    x, params, g = _block_inputs(b, t, 4, cuda)
    kw = dict(training=training, seed=5, drop_p=0.5, ffn_drop_p=0.5)
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    before = fused_block_backward.launches
    out = fused_transformer_block(leaves[0], leaves[1:], 8, 8.0, **kw)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert fused_block_backward.launches == before + 1
    ref = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    want_out = fused_transformer_block_reference(ref[0], ref[1:], 8, 8.0, **kw)
    want = torch.autograd.grad(want_out, ref, g)
    assert float((out - want_out).detach().abs().max()) <= 1e-4
    for i, (a, w) in enumerate(zip(got, want)):
        assert _err(a, w) <= 1e-4, (i, _err(a, w))


@pytest.mark.parametrize("hidden,d", [(128, 2), (4, 2), (256, 2), (256, 1)],
                         ids=["128", "4", "256-D2", "256-D1"])
def test_lstm_backward_matches_autograd(cuda, hidden, d):
    """Kernel #4 (through the autograd Function) against autograd through
    the twin: dxw and dwhh, with whh at torch's init scale U(+-1/sqrt(H))."""
    gen = torch.Generator().manual_seed(6)
    lim = hidden ** -0.5
    xw = (0.5 * torch.randn(50, d, 37, 4 * hidden, generator=gen)).to(cuda)
    whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(cuda)
    g = torch.randn(50, d, 37, hidden, generator=gen).to(cuda)
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    before = lstm_scan_backward.launches
    got = torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)
    torch.cuda.synchronize()
    assert lstm_scan_backward.launches == before + 1
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    want = torch.autograd.grad(lstm_scan_reference(a, w), (a, w), g)
    for got_i, want_i in zip(got, want):
        assert _err(got_i, want_i) <= 1e-5


def _lstm_inputs(t, d, b, hidden, seed, cuda):
    """xw, whh at torch's init scale U(+-1/sqrt(H)), and an upstream gradient."""
    gen = torch.Generator().manual_seed(seed)
    lim = hidden ** -0.5
    xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to(cuda)
    whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(cuda)
    g = torch.randn(t, d, b, hidden, generator=gen).to(cuda)
    return xw, whh, g


# (T, D, B): partial batch tiles (B=37, and B=5 or 1 below one tile at every
# H), one direction, a single step (dwhh sums no rows), and 30 rows of dwhh
# (less than one stage of the weight-gradient tile)
LSTM_CASES = [(40, 2, 37), (40, 2, 5), (40, 2, 1), (40, 1, 37), (1, 2, 37), (7, 2, 5)]
LSTM_IDS = ["T40D2B37", "T40D2B5", "T40D2B1", "T40D1B37", "T1D2B37", "T7D2B5"]


@pytest.mark.parametrize("t,d,b", LSTM_CASES, ids=LSTM_IDS)
@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128, 256])
def test_lstm_cluster_kernels_match_twin(cuda, hidden, t, d, b):
    """Kernels #3 and #4 (the clusters of every H) against the twin: h and
    c, then dxw and dwhh against autograd through the twin."""
    _assert_lstm_kernels_match_twin(*_lstm_inputs(t, d, b, hidden, 14, cuda))


@pytest.mark.parametrize("t,d,b", [(40, 2, 37), (40, 1, 37), (192, 2, 128)],
                         ids=["T40D2B37", "T40D1B37", "T192D2B128"])
@pytest.mark.parametrize("hidden", [2, 100, 200])
def test_lstm_kernels_take_any_hidden_size_by_padding(cuda, hidden, t, d, b):
    """An H the kernels are not built for (``--latent_dim 4``'s H=2,
    ``--lstm_units 100``, 200) runs zero-padded to the next built H (4, 128,
    256) and sliced back: h, c, dxw and dwhh against the twin at H itself,
    one launch of each kernel."""
    _assert_lstm_kernels_match_twin(*_lstm_inputs(t, d, b, hidden, 15, cuda))


@pytest.mark.parametrize("t,d,b", LSTM_CASES, ids=LSTM_IDS)
@pytest.mark.parametrize("hidden", [300, 512, 1024])
def test_lstm_wide_kernels_match_twin(cuda, hidden, t, d, b):
    """The wide kernels (H > 256: ``--lstm_units 300``, padded to 320, 512
    and 1024) against the twin at H itself: h, c, dxw and dwhh, one launch of
    each kernel, ragged batches, one direction and a single step."""
    _assert_lstm_kernels_match_twin(*_lstm_inputs(t, d, b, hidden, 18, cuda))


def test_lstm_wide_kernels_match_twin_at_full_batch(cuda):
    """The wide kernels at the shapes of ``--lstm_units 512`` and ``1024`` in
    training (B=128, T=192): both directions packed, where H=1024 streams
    part of each CTA's slice of whh from L2, and H=1024 at D=1 (the
    double_lstm encoders), where each CTA's whole slice is resident."""
    for hidden, d in ((512, 2), (1024, 2), (1024, 1)):
        assert isinstance(lstm_launch_plan(128, d, hidden), WidePlan)
        _assert_lstm_kernels_match_twin(*_lstm_inputs(192, d, 128, hidden, 19, cuda))


def test_lstm_wide_forward_counts_each_launch(cuda):
    """(direction, batch group) pairs past the SMs run in several
    cooperative launches, and ``lstm_scan_packed`` counts each: 2 x SMs + 1
    recurrences at H=320 take several, against the twin."""
    d = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count + 1
    plan = lstm_launch_plan(8, d, 320)
    assert plan.launches_fwd > 1
    _assert_lstm_kernels_match_twin(*_lstm_inputs(4, d, 8, 320, 22, cuda), plan.launches_fwd)


def test_lstm_kernels_match_twin_at_the_zoos_unidirectional_shape(cuda):
    """Kernels #3 and #4 at D=1, B=128, T=192, H=128: one recurrence of the
    double_lstm and lstm encoders at --lstm_units 128 and the full batch."""
    _assert_lstm_kernels_match_twin(*_lstm_inputs(192, 1, 128, 128, 21, cuda))


def _assert_lstm_kernels_match_twin(xw, whh, g, launches=1):
    """h and c against the twin, then dxw and dwhh against autograd through
    it, with ``launches`` of the forward and one count of the backward."""
    with torch.no_grad():
        h, c = lstm_scan_packed(xw, whh, return_c=True)
        torch.cuda.synchronize()
        want_h, want_c = lstm_scan_reference(xw, whh, return_c=True)
    assert float((h - want_h).abs().max()) <= 1e-5
    assert float((c - want_c).abs().max()) <= 1e-5
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    before = (lstm_scan_packed.launches, lstm_scan_backward.launches)
    got = torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)
    torch.cuda.synchronize()
    assert (lstm_scan_packed.launches, lstm_scan_backward.launches) == (before[0] + launches,
                                                                          before[1] + 1)
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    want = torch.autograd.grad(lstm_scan_reference(a, w), (a, w), g)
    for name, got_i, want_i in zip(("dxw", "dwhh"), got, want):
        assert _err(got_i, want_i) <= 1e-5, (name, _err(got_i, want_i))


@pytest.mark.parametrize("hidden", [128, 512])
def test_lstm_cluster_kernels_repeat_bit_for_bit(cuda, hidden):
    """No atomics and a fixed summation order: two runs on the same inputs
    give the same h, c, dxw and dwhh, bit for bit (the clusters at H=128,
    the wide kernels at 512)."""
    xw, whh, g = _lstm_inputs(60, 2, 130, hidden, 16, cuda)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            h, c = lstm_scan_packed(xw, whh, return_c=True)
        a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        runs.append((h, c, *torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)))
    torch.cuda.synchronize()
    for name, first, second in zip(("h", "c", "dxw", "dwhh"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.parametrize("d", [2, 1])
def test_lstm_mid_kernels_repeat_bit_for_bit(cuda, d):
    """The H=256 kernels at B=128, T=192 (tiles of 24 rows at D=2, 16 at
    D=1): a fixed order of every sum, so two runs give the same h, c, dxw
    and dwhh, bit for bit."""
    xw, whh, g = _lstm_inputs(192, d, 128, 256, 23, cuda)
    assert lstm_launch_plan(128, d, 256).batch_tile == {2: 24, 1: 16}[d]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            h, c = lstm_scan_packed(xw, whh, return_c=True)
        a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        runs.append((h, c, *torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)))
    torch.cuda.synchronize()
    for name, first, second in zip(("h", "c", "dxw", "dwhh"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.parametrize("d", [2, 1])
def test_lstm_mid_plan_is_one_wave_on_the_card(cuda, d):
    """At B=128 every cluster of the H=256 plan is co-resident: the card
    holds at least as many clusters of each kernel (at the plan's tile) as
    the plan launches, and the plan claims one wave."""
    plan = lstm_launch_plan(128, d, 256)
    assert isinstance(plan, MidPlan) and plan.waves == 1
    for kind in ("fwd", "bwd"):
        assert mid_coresident(kind, plan) >= plan.ctas // plan.cluster, kind


def test_lstm_mid_kernel_refuses_a_grid_beyond_its_waves(cuda):
    """The H=256 entry points check the plan: a tile they are not built
    for (20 rows) or the wrong shared-memory size is refused with
    cudaErrorInvalidValue; a plan claiming one wave for more clusters than
    the card holds (B=2,048, D=2: 128 clusters of 32-row tiles) is refused
    as too large, and nothing launches."""
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    xw, whh, g = _lstm_inputs(2, 2, 2048, 256, 24, cuda)
    h = torch.empty(2, 2, 2048, 256, device=cuda)
    plan = mid_plan(2048, 2, MID_TILES[-1])
    assert plan.waves > 1
    cases = ((plan.batch_tile, plan.smem_fwd, plan.smem_bwd, 1, "cooperative"),
             (20, plan.smem_fwd, plan.smem_bwd, plan.waves, "invalid argument"),
             (plan.batch_tile, plan.smem_fwd + 4, plan.smem_bwd + 4, plan.waves,
              "invalid argument"))
    for bt, s_fwd, s_bwd, waves, want in cases:
        fwd = lib.tce_lstm_scan_fwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), None, None,
                                    2, 2, 2048, 256, plan.cluster, bt, waves, plan.threads,
                                    s_fwd, None, None, stream)
        bwd = lib.tce_lstm_scan_bwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), g.data_ptr(),
                                    xw.data_ptr(), 2, 2, 2048, 256, plan.cluster, bt, waves,
                                    plan.threads, s_bwd, None, None, stream)
        for rc in (fwd, bwd):
            assert want in lib.tce_error_string(rc).decode(), (bt, waves, rc)
    torch.cuda.synchronize()


def test_lstm_kernel_refuses_a_plan_it_cannot_run(cuda):
    """The C entry points check the plan they are given: the plan of
    another H, or the wrong shared-memory size, is refused with
    cudaErrorInvalidValue and launches nothing."""
    xw, whh, g = _lstm_inputs(4, 2, 8, 128, 17, cuda)
    h = torch.empty(4, 2, 8, 128, device=cuda)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    plan = lstm_launch_plan(8, 2, 128)
    wrong = lstm_launch_plan(8, 2, 64)
    for p in (wrong, plan._replace(smem_fwd=plan.smem_fwd + 4, smem_bwd=plan.smem_bwd + 4)):
        fwd = lib.tce_lstm_scan_fwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), None, None,
                                    4, 2, 8, 128, p.cluster, p.batch_tile, 1, p.threads,
                                    p.smem_fwd, None, None, stream)
        bwd = lib.tce_lstm_scan_bwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), g.data_ptr(),
                                    xw.data_ptr(), 4, 2, 8, 128, p.cluster, p.batch_tile, 1,
                                    p.threads, p.smem_bwd, None, None, stream)
        assert (fwd, bwd) == (1, 1), p  # cudaErrorInvalidValue
    # the wide kernels: resident rows that are not whole chunks, the wrong
    # shared-memory size, no state scratch, or batch groups of which one is
    # empty (7 groups of 2 rows for B=8)
    xw, whh, g = _lstm_inputs(4, 2, 8, 512, 17, cuda)
    h = torch.empty(4, 2, 8, 512, device=cuda)
    state = torch.empty(2, 8, 512, device=cuda)
    arrived = torch.zeros(2 * 8, dtype=torch.int32, device=cuda)
    plan = lstm_launch_plan(8, 2, 512)
    g_fwd, g_bwd = plan.groups_fwd, plan.groups_bwd
    for r_fwd, r_bwd, s_fwd, s_bwd, st, groups in (
            (8, 8, plan.smem_fwd, plan.smem_bwd, state, None),
            (plan.resident_fwd, plan.resident_bwd, plan.smem_fwd + 4, plan.smem_bwd + 4, state,
             None),
            (plan.resident_fwd, plan.resident_bwd, plan.smem_fwd, plan.smem_bwd, None, None),
            (plan.resident_fwd, plan.resident_bwd, plan.smem_fwd, plan.smem_bwd, state, 7)):
        ptr = None if st is None else st.data_ptr()
        fwd = lib.tce_lstm_scan_fwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), None, None,
                                    4, 2, 8, 512, plan.units_fwd, r_fwd, groups or g_fwd,
                                    plan.threads, s_fwd, ptr, arrived.data_ptr(), stream)
        bwd = lib.tce_lstm_scan_bwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), g.data_ptr(),
                                    xw.data_ptr(), 4, 2, 8, 512, plan.units_bwd, r_bwd,
                                    groups or g_bwd, plan.threads, s_bwd, ptr,
                                    arrived.data_ptr(), stream)
        assert (fwd, bwd) == (1, 1), (r_fwd, s_fwd, groups)
    torch.cuda.synchronize()


def test_lstm_wide_kernel_refuses_a_grid_that_cannot_be_co_resident(cuda):
    """A cooperative grid larger than the card holds at once is refused by
    the launch (it never hangs on the step barrier): H=2048 at 4 units a CTA
    is 512 CTAs of one direction, each with all of its slice (192 KiB with
    its padding) in shared memory, so one a SM."""
    xw, whh, _ = _lstm_inputs(4, 1, 8, 2048, 20, cuda)
    wf = whh.unflatten(-1, (4, 2048)).transpose(-1, -2).contiguous()
    h = torch.empty(4, 1, 8, 2048, device=cuda)
    state = torch.empty(1, 8, 2048, device=cuda)
    arrived = torch.zeros(1, dtype=torch.int32, device=cuda)
    # N = 16 columns, 8 rows in one group: tiles of 16 rows x 16 columns
    smem = wide_smem_bytes(16, 2048, 16, 16, 0, WIDE_KC["fwd"])
    lib = _build.load()
    rc = lib.tce_lstm_scan_fwd(xw.data_ptr(), wf.data_ptr(), h.data_ptr(), None, None, 4, 1,
                               8, 2048, 4, 2048, 1, 256, smem, state.data_ptr(),
                               arrived.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert "cooperative" in lib.tce_error_string(rc).decode(), rc
    torch.cuda.synchronize()


def test_gradients_flow_through_the_kernels_to_the_input(cuda):
    """A loss through the block and the LSTM on the card gives x a gradient
    that matches the CPU's (before the backward kernels, the kernels
    returned tensors without a grad_fn and x.grad stayed None)."""
    gen = torch.Generator().manual_seed(7)
    x_cpu = torch.randn(4, 64, 64, generator=gen)
    x_cpu[..., :2] *= 3.0
    _, params_cpu, _ = _block_inputs(1, 1, 8, "cpu")
    lstm = LSTM(64, 16, bidirectional=True)
    for p in lstm.parameters():
        torch.nn.init.uniform_(p, -0.25, 0.25, generator=gen)

    def loss(x, params, lstm):
        y = fused_transformer_block(x, params, 8, 8.0)
        return (lstm(y) ** 2).sum()

    x_gpu = x_cpu.to(cuda).requires_grad_()
    loss(x_gpu, [p.to(cuda) for p in params_cpu], lstm.to(cuda)).backward()
    assert x_gpu.grad is not None
    x_cpu.requires_grad_()
    loss(x_cpu, params_cpu, lstm.cpu()).backward()
    assert _err(x_gpu.grad.cpu(), x_cpu.grad) <= 1e-4


def _conv_inputs(b, t, k, seed, cuda, c=64):
    """x, w [C, C, K] at torch's init scale, b, a perturbed [T, C] LayerNorm
    affine, and an upstream gradient."""
    gen = torch.Generator().manual_seed(seed)
    lim = 1.0 / (c * k) ** 0.5
    x = torch.randn(b, t, c, generator=gen)
    w = (torch.rand(c, c, k, generator=gen) * 2 - 1) * lim
    bb = (torch.rand(c, generator=gen) * 2 - 1) * lim
    scale = 1 + 0.2 * torch.randn(t, c, generator=gen)
    bias = 0.2 * torch.randn(t, c, generator=gen)
    g = torch.randn(b, t, c, generator=gen)
    return [v.to(cuda) for v in (x, w, bb, scale, bias, g)]


# (B, T, K): ragged batch tiles (B=6 and 5 take tiles 2 and 1), odd K, the
# flagship's K=64 at T=192 and at the encoders' default T=320 (two row passes)
CONV_CASES = [(6, 192, 64), (5, 320, 64), (6, 50, 7), (5, 192, 32)]
CONV_IDS = ["B6T192K64", "B5T320K64", "B6T50K7", "B5T192K32"]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("b,t,k", CONV_CASES, ids=CONV_IDS)
def test_fused_conv_forward_matches_twin(cuda, b, t, k, training):
    """Kernel #5 against its plain twin; in training the same seed draws the
    twin's mask."""
    x, w, bb, scale, bias, _ = _conv_inputs(b, t, k, 9, cuda)
    before = fused_basic_block.launches
    got = fused_basic_block(x, w, bb, scale, bias, 4321, k, 0.2, training)
    torch.cuda.synchronize()
    assert fused_basic_block.launches == before + 1
    want = fused_basic_block_reference(x, w, bb, scale, bias, 4321, k, 0.2, training)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("b,t,k", CONV_CASES, ids=CONV_IDS)
def test_fused_conv_backward_matches_autograd(cuda, b, t, k, training):
    """Kernel #6 (and #7 for its dx) through the autograd Function against
    autograd through the twin: dx, dw, db, dscale, dbias."""
    x, w, bb, scale, bias, g = _conv_inputs(b, t, k, 10, cuda)
    leaves = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
    before = (fused_basic_block.launches, fused_conv_backward.launches, conv1d_same.launches)
    out = fused_basic_block(*leaves, 99, k, 0.2, training)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    after = (fused_basic_block.launches, fused_conv_backward.launches, conv1d_same.launches)
    assert after == tuple(n + 1 for n in before)
    ref = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
    want_out = fused_basic_block_reference(*ref, 99, k, 0.2, training)
    want = torch.autograd.grad(want_out, ref, g)
    assert float((out - want_out).detach().abs().max()) <= 1e-4
    for name, a, r in zip(("dx", "dw", "db", "dscale", "dbias"), got, want):
        assert _err(a, r) <= 1e-4, (name, _err(a, r))


@pytest.mark.parametrize("t,k,padding", [(192, 64, None), (320, 32, None), (50, 7, (2, 4))])
def test_conv1d_kernel_matches_conv1d(cuda, t, k, padding):
    """Kernel #7, the conv alone, against F.conv1d (TF32 off), with torch's
    'same' padding and with a lopsided one."""
    x, w, *_ = _conv_inputs(6, t, k, 11, cuda)
    before = conv1d_same.launches
    got = conv1d_same(x, w, padding)
    torch.cuda.synchronize()
    assert conv1d_same.launches == before + 1
    pad = padding if padding is not None else ((k - 1) // 2, k - 1 - (k - 1) // 2)
    want = conv1d_reference(x, w, pad)
    assert float((got - want).abs().max()) <= 1e-4


def test_fused_conv_takes_a_transposed_input(cuda):
    """The encoders hand their first block the 1x1 conv's output, a
    transposed view of [B, C, T]: the block takes it and its gradient reaches
    the view."""
    x, w, bb, scale, bias, g = _conv_inputs(4, 192, 64, 13, cuda)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
    assert not xt.is_contiguous()
    out = fused_basic_block(xt, w, bb, scale, bias, 7, 64, 0.2, True)
    (dx,) = torch.autograd.grad(out, xt, g)
    xr = x.clone().requires_grad_()
    want = fused_basic_block_reference(xr, w, bb, scale, bias, 7, 64, 0.2, True)
    (dxr,) = torch.autograd.grad(want, xr, g)
    assert float((out - want).detach().abs().max()) <= 1e-4
    assert _err(dx, dxr) <= 1e-4


def test_fused_conv_refuses_other_widths_and_long_windows(cuda):
    x, w, bb, scale, bias, _ = _conv_inputs(2, 64, 8, 12, cuda, c=32)
    before = (fused_basic_block.launches, conv1d_same.launches)
    with pytest.raises(ValueError, match="C=64"):
        fused_basic_block(x, w, bb, scale, bias, 0, 8, 0.0, False)
    with pytest.raises(ValueError, match="C=64"):
        conv1d_same(x, w)
    x, w, bb, scale, bias, _ = _conv_inputs(2, 400, 64, 12, cuda)
    with pytest.raises(ValueError, match="T <= 345"):
        fused_basic_block(x, w, bb, scale, bias, 0, 64, 0.0, False)
    with pytest.raises(ValueError, match="no backward kernel"):
        conv1d_same(x.requires_grad_(), w)
    assert (fused_basic_block.launches, conv1d_same.launches) == before


def test_block_backward_at_the_longest_window(cuda):
    """Kernels #1 and #2 at T = MAX_KERNEL_T, where the attention backward's
    CTA fills its shared memory: dx and the parameter gradients against
    autograd through the twin."""
    x, params, g = _block_inputs(2, MAX_KERNEL_T, 63, cuda)
    kw = dict(training=True, seed=13, drop_p=0.5, ffn_drop_p=0.5)
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    got = torch.autograd.grad(fused_transformer_block(leaves[0], leaves[1:], 8, 8.0, **kw),
                              leaves, g)
    torch.cuda.synchronize()
    ref = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    want = torch.autograd.grad(fused_transformer_block_reference(ref[0], ref[1:], 8, 8.0, **kw),
                               ref, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert _err(a, w) <= 1e-4, (i, _err(a, w))


# ---- the bf16 mode: #1 and #2 on the tensor cores --------------------------------
# Both sides round the same operands to bf16 and sum in f32 in another order,
# so an intermediate may flip by one bf16 unit where two sums straddle a
# rounding boundary: bf16 outputs (out, the saved planes, dx) within 8e-3 of
# max |twin| (two units), each f32 parameter gradient within 1e-2 of its own
# largest value (the key bias's, zero in exact arithmetic, of the query
# bias's), the limits of one module in tests/test_torch_port_bf16_block.py.
BF16_OUT_TOL = 8e-3
BF16_GRAD_TOL = 1e-2


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("b,t", [(3, 33), (8, MAX_KERNEL_T)], ids=["B3T33", "B8T1699"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "dropout"])
def test_bf16_block_kernels_match_twins_at_ragged_shapes(cuda, b, t, training):
    """#1 and #2's bf16 kernels on a bf16 x and g against the twins: out,
    what the forward saves, dx and the 16 parameter gradients.  T=33 leaves a
    partial query tile, key step, warp and row tile; T=1,699 is the longest
    window, with B=8 a batch tile of 8."""
    x, params, g = _block_inputs(b, t, 70 + b, cuda)
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    drop = DropoutConfig(training, 17, 0.5, 0.5)
    before = (fused_transformer_block.launches_bf16, fused_block_backward.launches_bf16)
    with torch.no_grad():
        out, saved = fused_block_forward_cuda(xb, params, 8, 8.0, drop, save=True)
        dx, dparams = fused_block_backward(xb, params, gb, saved, 8, 8.0, drop)
        torch.cuda.synchronize()
        assert (fused_transformer_block.launches_bf16,
                fused_block_backward.launches_bf16) == (before[0] + 1, before[1] + 1)
        assert out.dtype == dx.dtype == torch.bfloat16
        assert _rel(out, fused_transformer_block_reference(xb, params, 8, 8.0, *drop)) \
            <= BF16_OUT_TOL
        want_saved = fused_block_saved_reference(xb, params, 8, 8.0, drop)
        n = x.numel()
        for i, name in enumerate(("q", "k", "v", "ctx", "x1", "lse")):
            part = slice(i * n, (i + 1) * n if i < 5 else None)
            assert _rel(saved[part], want_saved[part]) <= BF16_OUT_TOL, name
        del want_saved
        want_dx, want_dp = fused_block_backward_reference(xb, params, gb, 8, 8.0, drop)
    assert _rel(dx, want_dx) <= BF16_OUT_TOL
    for i, (a, w) in enumerate(zip(dparams, want_dp)):
        scale = float(want_dp[5 if i == 6 else i].abs().max())
        assert float((a - w).abs().max()) <= BF16_GRAD_TOL * scale, i


def test_bf16_block_kernels_repeat_bit_for_bit(cuda):
    """No atomics and a fixed summation order in the bf16 kernels: two calls
    give the same bits in out, in everything saved and in every gradient."""
    x, params, g = _block_inputs(37, 192, 72, cuda)
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    for drop in (DropoutConfig(), DropoutConfig(True, 9, 0.5, 0.5)):
        runs = [fused_block_forward_cuda(xb, params, 8, 8.0, drop, save=True)
                for _ in range(2)]
        grads = [fused_block_backward(xb, params, gb, runs[0][1], 8, 8.0, drop)
                 for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        assert torch.equal(grads[0][0], grads[1][0])
        for i, (a, b) in enumerate(zip(grads[0][1], grads[1][1])):
            assert torch.equal(a, b), i


# ---- the weight-gradient tile (csrc/wgrad.cuh) through its callers ----------------

@pytest.mark.parametrize("t", [1, 7, 192, 218, 256, 320])
@pytest.mark.parametrize("b", [1, 5, 37])
def test_block_backward_at_ragged_shapes(cuda, b, t):
    """Kernel #2 at row counts that fill no stage, chunk or key tile evenly
    (B*T from 1 to 11,840; T=256 and 320 are 4 s and 5 s windows, with more
    key tiles than the CTA has warps), dropout on: dx and
    the 16 parameter gradients against autograd through the twin."""
    x, params, g = _block_inputs(b, t, 20 + b, cuda)
    kw = dict(training=True, seed=11, drop_p=0.5, ffn_drop_p=0.5)
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    got = torch.autograd.grad(fused_transformer_block(leaves[0], leaves[1:], 8, 8.0, **kw),
                              leaves, g)
    torch.cuda.synchronize()
    ref = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    want = torch.autograd.grad(fused_transformer_block_reference(ref[0], ref[1:], 8, 8.0, **kw),
                               ref, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert _err(a, w) <= 1e-4, (i, _err(a, w))


# (B, T, K): one tap, an odd K short of a tap group, the speech block's K, the
# longest window at K=64, and sample groups that do not divide B
DW_CASES = [(5, 7, 1), (1, 50, 31), (37, 192, 32), (5, 345, 64), (37, 192, 64)]
DW_IDS = ["B5T7K1", "B1T50K31", "B37T192K32", "B5T345K64", "B37T192K64"]


@pytest.mark.parametrize("b,t,k", DW_CASES, ids=DW_IDS)
def test_conv_backward_at_ragged_shapes(cuda, b, t, k):
    """Kernel #6 where the dW kernel's stages, tap groups and sample groups
    are ragged, dropout on: all five gradients against autograd through the
    twin."""
    x, w, bb, scale, bias, g = _conv_inputs(b, t, k, 30 + k, cuda)
    leaves = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
    got = torch.autograd.grad(fused_basic_block(*leaves, 99, k, 0.2, True), leaves, g)
    torch.cuda.synchronize()
    ref = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
    want = torch.autograd.grad(fused_basic_block_reference(*ref, 99, k, 0.2, True), ref, g)
    for name, a, r in zip(("dx", "dw", "db", "dscale", "dbias"), got, want):
        assert _err(a, r) <= 1e-4, (name, _err(a, r))


def test_block_and_conv_backward_repeat_bit_for_bit(cuda):
    """No atomics and a fixed summation order in kernels #2 and #6: two calls
    on the same inputs give the same bits in every gradient."""
    drop = DropoutConfig(True, 5, 0.5, 0.5)
    x, params, g = _block_inputs(37, 192, 40, cuda)
    _, saved = fused_block_forward_cuda(x, params, 8, 8.0, drop, save=True)
    runs = [fused_block_backward(x, params, g, saved, 8, 8.0, drop) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        assert torch.equal(a, b), i
    cdrop = DropoutConfig(True, 6, 0.2)
    x, w, bb, scale, bias, g = _conv_inputs(37, 192, 64, 41, cuda)
    _, z, stats = fused_conv_forward_cuda(x, w, bb, scale, bias, cdrop, save=True)
    runs = [fused_conv_backward(x, w, scale, bias, g, z, stats, cdrop) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dw", "db", "dscale", "dbias"), *runs):
        assert torch.equal(a, b), name


def test_weight_gradient_entry_points_refuse_what_they_cannot_copy(cuda):
    """The tile copies 16 bytes at a time: a misaligned operand, a width that
    is no multiple of 4 floats, and a window whose attention backward would
    not fit shared memory are refused with cudaErrorInvalidValue (1) and
    launch nothing."""
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    t, d, b, hidden = 6, 2, 5, 8
    h = torch.zeros(t * d * b * hidden + 4, device=cuda)
    dxw = torch.zeros(t * d * b * 4 * hidden + 4, device=cuda)
    dwhh = torch.full((d, hidden, 4 * hidden), 7.0, device=cuda)
    ws = torch.zeros(lib.tce_lstm_dwhh_workspace(t, d, b, hidden), device=cuda)

    def dwhh_rc(h_ptr, dxw_ptr, hid=hidden):
        return lib.tce_lstm_dwhh(h_ptr, dxw_ptr, dwhh.data_ptr(), ws.data_ptr(), t, d, b, hid,
                                 stream)

    assert dwhh_rc(h.data_ptr(), dxw.data_ptr()) == 0
    torch.cuda.synchronize()
    assert float(dwhh.abs().max()) == 0.0  # zeros in, zeros out: it ran
    dwhh.fill_(7.0)
    assert dwhh_rc(h.data_ptr() + 4, dxw.data_ptr()) == 1
    assert dwhh_rc(h.data_ptr(), dxw.data_ptr() + 8) == 1
    assert dwhh_rc(h.data_ptr(), dxw.data_ptr(), hid=6) == 1  # rows of 24 bytes
    torch.cuda.synchronize()
    assert float(dwhh.min()) == 7.0  # nothing was launched

    # the conv's dW: x off a 16-byte boundary
    bsz, tt, k = 2, 16, 8
    x, w, bb, scale, bias, g = _conv_inputs(bsz, tt, k, 50, cuda)
    pad = torch.zeros(bsz * tt * 64 + 4, device=cuda)
    outs = [torch.zeros_like(x), torch.zeros_like(w), torch.zeros(64, device=cuda),
            torch.zeros(2, tt, 64, device=cuda)]
    cws = torch.zeros(lib.tce_fused_conv_bwd_workspace(bsz, tt, k), device=cuda)
    stats = torch.ones(bsz, 2, device=cuda)
    rc = lib.tce_fused_conv_bwd(pad.data_ptr() + 4, g.data_ptr(), x.data_ptr(),
                                stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                *(o.data_ptr() for o in outs), cws.data_ptr(), bsz, tt, 64, k,
                                *drop_args(DropoutConfig(), bsz)[:5], stream)
    assert rc == 1

    # the block's backward at a window no CTA's shared memory holds
    long_t = 4096
    small = torch.zeros(64, device=cuda)
    ptrs = (torch.zeros(16, dtype=torch.int64) + small.data_ptr()).numpy()
    for bf16_mode in (0, 1):
        rc = lib.tce_fused_block_bwd(small.data_ptr(), small.data_ptr(), small.data_ptr(),
                                     ptrs.ctypes.data, small.data_ptr(), ptrs.ctypes.data,
                                     small.data_ptr(), 1, long_t, 64, 8, 256, 0.125,
                                     *drop_args(DropoutConfig(), 1), bf16_mode, stream)
        assert rc == 1, bf16_mode
    torch.cuda.synchronize()


# -- the device-resident chunk store and the host path's pinned ring ----------

@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
    from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture

    root = str(tmp_path_factory.mktemp("store_corpus"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=16)
    return get_train_val_test_files_final(root, 0, "wav2vec_19", f"{root}/fold_split.json", 3)


def _store_dataset(files):
    from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset

    return EEGWindowDataset(files[0], files[4], 64, 64, batch_size=4, shuffle=True,
                            shuffle_percentage=1.0, seed=0)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_chunk_store_on_the_card_equals_the_cpu_store(cuda, small_corpus, store_dtype):
    """Two epochs, prefetch on, under a budget that holds two chunks (so
    chunks are evicted and uploaded again while queued gathers still read
    the previous ones): every batch gathered on the card equals the CPU
    store's, and epoch 0 uploads each chunk once (later uploads depend on
    what the prefetch evicted, so the two stores' counts differ)."""
    import sys

    from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore, gather_batch

    card = DeviceChunkStore(_store_dataset(small_corpus), device=cuda, max_resident=2,
                            store_dtype=store_dtype)
    host = DeviceChunkStore(_store_dataset(small_corpus), device="cpu", prefetch=False,
                            store_dtype=store_dtype)
    n_chunks = len(card.dataset.batches_keys)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, want = [], []
        for epoch in range(2):
            for a, b in zip(card.epoch_batches(), host.epoch_batches(), strict=True):
                idx, subs = (torch.from_numpy(v).to(cuda) for v in a[3:5])
                got.append(gather_batch(*a[:3], idx, subs))
                want.append(gather_batch(*b[:3], torch.from_numpy(b[3]), torch.from_numpy(b[4])))
            if epoch == 0:
                assert card.stats["uploads"] == n_chunks
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert len(got) > 20
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k].cpu(), w[k]), k
    assert card.stats["upload_s"] > 0  # the finished transfers, timed
    card.release()


def test_release_gives_the_memory_back(cuda, small_corpus):
    from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    store = DeviceChunkStore(_store_dataset(small_corpus), device=cuda)
    assert sum(1 for _ in store.epoch_batches()) > 0  # no batch outlives the walk
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert held >= store._resident_bytes > 0
    store.release()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    assert store._pool is None and store._staging is None


def test_host_prefetch_ring_hands_over_every_batch_intact(cuda):
    """The host path's pinned ring (size + 1 slots, a slot refilled once
    its copy's event has completed): 40 batches of differing shapes arrive
    on the card equal to the host arrays they were copied from."""
    from transformer_clip_eeg_tpu_torch.train.loop import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [{"eeg": rng.standard_normal((8 + i % 3, 64, 64)).astype(np.float32),
                "ids": np.arange(i, i + 8 + i % 3, dtype=np.int64)} for i in range(40)]
    out = [{k: v.clone() for k, v in b.items()}
           for b in prefetch_to_device(iter(batches), cuda, size=2)]
    torch.cuda.synchronize()
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
