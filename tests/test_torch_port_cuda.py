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
    DropoutConfig,
    drop_args,
    fused_block_backward,
    fused_block_forward_cuda,
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
    lstm_launch_plan,
    lstm_scan_backward,
    lstm_scan_packed,
    lstm_scan_reference,
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
    with pytest.raises(ValueError, match="T <= 218"):
        fused_transformer_block(torch.zeros(2, 256, e, device=cuda), params, 8, 8.0)
    assert fused_transformer_block.launches == before


@pytest.mark.parametrize("hidden", [128, 4])
def test_lstm_kernel_matches_twin(cuda, hidden):
    gen = torch.Generator().manual_seed(1)
    xw = (0.5 * torch.randn(192, 2, 37, 4 * hidden, generator=gen)).to(cuda)
    whh = (0.1 * torch.randn(2, hidden, 4 * hidden, generator=gen)).to(cuda)
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


@pytest.mark.parametrize("hidden", [128, 4])
def test_lstm_backward_matches_autograd(cuda, hidden):
    """Kernel #4 (through the autograd Function) against autograd through
    the twin: dxw and dwhh, with whh at torch's init scale U(+-1/sqrt(H))."""
    gen = torch.Generator().manual_seed(6)
    lim = hidden ** -0.5
    xw = (0.5 * torch.randn(50, 2, 37, 4 * hidden, generator=gen)).to(cuda)
    whh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(cuda)
    g = torch.randn(50, 2, 37, hidden, generator=gen).to(cuda)
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
@pytest.mark.parametrize("hidden", [4, 8, 16, 32, 64, 128])
def test_lstm_cluster_kernels_match_twin(cuda, hidden, t, d, b):
    """Kernels #3 and #4 (the clusters of every H) against the twin: h and
    c, then dxw and dwhh against autograd through the twin."""
    xw, whh, g = _lstm_inputs(t, d, b, hidden, 14, cuda)
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
    assert (lstm_scan_packed.launches, lstm_scan_backward.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
    want = torch.autograd.grad(lstm_scan_reference(a, w), (a, w), g)
    for name, got_i, want_i in zip(("dxw", "dwhh"), got, want):
        assert _err(got_i, want_i) <= 1e-5, (name, _err(got_i, want_i))


def test_lstm_cluster_kernels_repeat_bit_for_bit(cuda):
    """No atomics and a fixed summation order: two runs on the same inputs
    give the same h, c, dxw and dwhh, bit for bit."""
    xw, whh, g = _lstm_inputs(60, 2, 130, 128, 16, cuda)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            h, c = lstm_scan_packed(xw, whh, return_c=True)
        a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        runs.append((h, c, *torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)))
    torch.cuda.synchronize()
    for name, first, second in zip(("h", "c", "dxw", "dwhh"), *runs):
        assert torch.equal(first, second), name


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
                                    4, 2, 8, 128, p.cluster, p.batch_tile, p.threads,
                                    p.smem_fwd, stream)
        bwd = lib.tce_lstm_scan_bwd(xw.data_ptr(), whh.data_ptr(), h.data_ptr(), g.data_ptr(),
                                    xw.data_ptr(), 4, 2, 8, 128, p.cluster, p.batch_tile,
                                    p.threads, p.smem_bwd, stream)
        assert (fwd, bwd) == (1, 1), p  # cudaErrorInvalidValue


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


# ---- the weight-gradient tile (csrc/wgrad.cuh) through its callers ----------------

@pytest.mark.parametrize("t", [1, 7, 192, 218])
@pytest.mark.parametrize("b", [1, 5, 37])
def test_block_backward_at_ragged_shapes(cuda, b, t):
    """Kernel #2 at row counts that fill no stage, chunk or key tile evenly
    (B*T from 1 to 8,066; T=218 is the longest window), dropout on: dx and
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
    rc = lib.tce_fused_block_bwd(small.data_ptr(), small.data_ptr(), small.data_ptr(),
                                 ptrs.ctypes.data, small.data_ptr(), ptrs.ctypes.data,
                                 small.data_ptr(), 1, long_t, 64, 8, 256, 0.125,
                                 *drop_args(DropoutConfig(), 1), stream)
    assert rc == 1
    torch.cuda.synchronize()
