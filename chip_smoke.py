"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU, end to end.

    python3 chip_smoke.py

1. Requires a CUDA card (exits non-zero without one) and prints its name
   and power limit as nvidia-smi reports them.  TF32 is turned off for
   matmuls and cuDNN convolutions: every comparison below is in f32.
2. Builds the port's kernels from ``transformer_clip_eeg_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch twin on the card at the
   flagship's shapes (seeded inputs): the block forward in eval and in
   training mode (same seed, so the same dropout masks), the LSTM forward,
   and the two backward kernels against autograd through the twins.  Times
   kernel, plain twin and the nearest single PyTorch call with CUDA events
   (median of 20 runs).  For the block's backward (#2) also its parts timed
   apart under ``torch.profiler`` (row kernels, attention, the weight
   gradients' products with their TFLOP/s, sums), the device launches per
   call, a bit-for-bit repeat and what ``ptxas -v`` reported.  For the LSTM kernels (one thread-block cluster per
   recurrence) also the launch plan, microseconds per step, what ``ptxas
   -v`` reported (registers, spills), the backward's recurrence and its
   dwhh reduction timed apart, and H=128 under its other plan (clusters of
   8), checked and timed beside the default.
4. Builds the flagship model (``TrainConfig()``: EEGConformerInterleaved
   depth 10, convLSTM, clip_sim_no_latent_proj) with seeded weights, serves
   it over HTTP on localhost, answers a request on every route, checks the
   answers, and checks that the serving path launched the kernels: 10 fused
   blocks per EEG chunk and 2 LSTM recurrences per speech chunk.  8 windows
   are compared with a CPU session holding the same weights.
   Then times one full 128-window chunk through each embedder (host clock)
   and profiles it (``torch.profiler``): device time per chunk, the device's
   idle share and the operations that take the most device time.
5. Trains the flagship at full width through the port's CLI
   (``cli.train``, the function ``cli.main`` runs): a synthetic SparrKULee
   fixture with 1024-dim wav2vec-19 features, 2 epochs at batch 128, every
   other flag at its default.  Checks ``loss.txt``, the checkpoint, the
   memory bank and the exact kernel launches (10 block forwards, 10 block
   backwards, 2 LSTM forwards and 2 LSTM backwards per train step; 10 and
   2 forwards per validation step).  Then one step at batch 8 with dropout
   on, card against CPU (same weights, batch and seed); the trained run
   served from its results directory against the trainer's model; the
   median step time of epoch 2 and a ``torch.profiler`` pass over 3 steps
   (a ``{"train": ...}`` line).
6. The conv kernels at the flagship's shapes (B=128, T=192, C=64): the
   fused BasicBlock forward (#5) against its plain twin in eval and in
   training (dropout 0.2, fixed seed) for K=64 (EEG) and K=32 (speech), its
   backward (#6) against autograd through the twin (all five gradients; its
   parts timed apart, launches per call, a bit-for-bit repeat and ``ptxas``
   as for #2), and the conv alone (#7) against ``F.conv1d``; each timed beside its plain twin
   and a yardstick (the port's unfused ``BasicBlock``, its backward, and
   ``F.conv1d``; cuDNN with TF32 off).
7. The fused path: the flagship with ``fused=True`` on its 11 square
   BasicBlocks (10 EEG blocks at K=64, the speech block at K=32).  8 windows
   on the card against the same model unfused on the card and against a CPU
   copy; one train step at batch 8 with dropout on, card against CPU; the
   exact launches (10 #5 per EEG chunk, 1 per speech chunk; 11 #5, 11 #6 and
   11 #7 per train step); the median step time at batch 128 on a batch
   already on the card, fused and unfused in turns, and a ``torch.profiler``
   pass over 3 fused steps.  The default serving and training paths above
   launch none of #5-#7.
8. Prints one JSON line of per-kernel numbers, then, last, the
   ``{"ok": true, "device": ...}`` line.

Any failure raises and exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
          "CUDA card", file=sys.stderr)
    sys.exit(1)

from transformer_clip_eeg_tpu_torch import _build, cli  # noqa: E402
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture  # noqa: E402
from transformer_clip_eeg_tpu_torch.models.encoders import BasicBlock  # noqa: E402
from transformer_clip_eeg_tpu_torch.models.registry import (  # noqa: E402
    build_model_from_config as build_model,
)
from transformer_clip_eeg_tpu_torch.ops.dropout import (  # noqa: E402
    fold_seed,
    set_dropout_seeds,
)
from transformer_clip_eeg_tpu_torch.ops.fused_block import (  # noqa: E402
    DropoutConfig,
    fused_block_backward,
    fused_block_forward_cuda,
    fused_transformer_block,
    fused_transformer_block_reference,
)
from transformer_clip_eeg_tpu_torch.ops.fused_conv import (  # noqa: E402
    conv1d_reference,
    conv1d_same,
    fused_basic_block,
    fused_basic_block_reference,
    fused_conv_backward,
    fused_conv_forward_cuda,
)
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (  # noqa: E402
    _backward_recurrence as lstm_backward_recurrence,
    _dwhh as lstm_dwhh,
    _launch_forward as lstm_forward_cuda,
    lstm_launch_plan,
    lstm_scan_backward,
    lstm_scan_packed,
    lstm_scan_reference,
)
from transformer_clip_eeg_tpu_torch.serve import (  # noqa: E402
    InferenceSession,
    RetrievalIndex,
    build_model_from_config,
    match_mismatch_decide,
)
from transformer_clip_eeg_tpu_torch.server import (  # noqa: E402
    NPY_CONTENT_TYPE,
    EmbeddingService,
    make_server,
)
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.loop import batch_iterator  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.steps import train_step  # noqa: E402

# H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BLOCK_TOL = 1e-4   # f32 sums of 64-256 terms in another order than cuBLAS
LSTM_TOL = 1e-5    # 192 contracting steps of f32 gate math
# backward kernels: max abs error over max(1, max |reference|) per gradient.
# The block's dW sums 24,576 rows in another order than autograd's; the
# LSTM's backward carries a 4H-term dot product through 192 reverse steps
BLOCK_BWD_TOL = 1e-4
LSTM_BWD_TOL = 1e-5
# the conv kernels: K*C = 4,096-term f32 sums in another order than cuDNN's,
# then a LayerNorm over 12,288 values; the backward's dW sums 24,576 rows
CONV_TOL = 1e-4
CONV_BWD_TOL = 1e-4  # of max(1, max |reference|), per gradient
SERVE_TOL = 1e-3   # whole model, GPU vs CPU, after L2 normalisation
STEP_TOL = 1e-3    # one whole train step, card vs CPU, gradients and losses
STEP_GRAD_FLOOR = 1e-4  # of the largest gradient: the least scale a leaf is held to
BANK_SIZE = 1000   # memory-bank rows; unused by serving, carried as state
REPS = 20
FLAGSHIP_DROP = DropoutConfig(True, 1234, 0.5, 0.5)  # the block's rates in training
CONV_DROP = DropoutConfig(True, 4321, 0.2)  # the conv blocks' rate in training
N_FUSED_BLOCKS = 11  # the flagship's square BasicBlocks: 10 EEG (K=64), 1 speech (K=32)
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_run")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def block_case(gen: torch.Generator):
    """Flagship block inputs on the card: x [128, 192, 64] and the 16
    parameters (torch's default init, LayerNorms perturbed)."""
    b, t, e, f = 128, 192, 64, 256
    dev = "cuda"

    def u(*shape, fan_in):
        lim = 1.0 / fan_in ** 0.5
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * lim).to(dev)

    def ln(n):
        return ((1 + 0.1 * torch.randn(n, generator=gen)).to(dev),
                (0.1 * torch.randn(n, generator=gen)).to(dev))

    g1, be1 = ln(e)
    g2, be2 = ln(e)
    wq, wk, wv, wo = (u(e, e, fan_in=e) for _ in range(4))
    bq, bk, bv, bo = (u(e, fan_in=e) for _ in range(4))
    w1, bb1 = u(f, e, fan_in=e), u(f, fan_in=e)
    w2, bb2 = u(e, f, fan_in=f), u(e, fan_in=f)
    params = (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo, g2, be2, w1, bb1, w2, bb2)
    return torch.randn(b, t, e, generator=gen).to(dev), params


def library_layer(params, e=64, h=8, f=256, scale=8.0):
    """The nearest single torch call: a pre-LN TransformerEncoderLayer with
    the block's weights.  Its attention divides by sqrt(head dim); folding
    sqrt(d)/sqrt(E) into the Q projection makes it compute this block's
    function exactly."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo, g2, be2, w1, bb1, w2, bb2) = params
    lib = torch.nn.TransformerEncoderLayer(
        e, h, f, dropout=0.0, activation="gelu", batch_first=True,
        norm_first=True, device="cuda",
    )
    q_fold = (e // h) ** 0.5 / scale
    with torch.no_grad():
        lib.self_attn.in_proj_weight.copy_(torch.cat([wq * q_fold, wk, wv]))
        lib.self_attn.in_proj_bias.copy_(torch.cat([bq * q_fold, bk, bv]))
        lib.self_attn.out_proj.weight.copy_(wo)
        lib.self_attn.out_proj.bias.copy_(bo)
        lib.linear1.weight.copy_(w1)
        lib.linear1.bias.copy_(bb1)
        lib.linear2.weight.copy_(w2)
        lib.linear2.bias.copy_(bb2)
        lib.norm1.weight.copy_(g1)
        lib.norm1.bias.copy_(be1)
        lib.norm2.weight.copy_(g2)
        lib.norm2.bias.copy_(be2)
    return lib


def block_flops(b, t, e=64, f=256):
    """Forward products of the block: QKV, scores, P V, out-projection, FFN."""
    return b * (2 * t * e * e * 4 + 2 * 2 * t * t * e + 2 * 2 * t * e * f)


def check_block(x, params) -> dict:
    b, t, e = x.shape
    h, f = 8, 256
    scale = e ** 0.5
    with torch.inference_mode():
        got = fused_transformer_block(x, params, h, scale)
        torch.cuda.synchronize()
        want = fused_transformer_block_reference(x, params, h, scale)
        err = float((got - want).abs().max())
        log(f"fused_transformer_block x{tuple(x.shape)}: max_abs_err {err:.3e} "
            f"(tol {BLOCK_TOL:g})")
        if not err <= BLOCK_TOL:
            raise AssertionError(f"fused block disagrees with its twin: {err}")

        lib = library_layer(params).eval()
        lib_err = float((lib(x) - want).abs().max())

        # training mode: the same seed draws the twin's masks
        got_tr = fused_transformer_block(x, params, h, scale, training=True,
                                         seed=FLAGSHIP_DROP.seed, drop_p=0.5, ffn_drop_p=0.5)
        torch.cuda.synchronize()
        want_tr = fused_transformer_block_reference(x, params, h, scale, *FLAGSHIP_DROP)
        err_tr = float((got_tr - want_tr).abs().max())
        log(f"fused_transformer_block training (drop 0.5/0.5): max_abs_err {err_tr:.3e} "
            f"(tol {BLOCK_TOL:g})")
        if not err_tr <= BLOCK_TOL:
            raise AssertionError(f"fused block in training mode disagrees with its twin: {err_tr}")
        ms_tr = time_ms(lambda: fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP,
                                                         save=True))

        ms = time_ms(lambda: fused_transformer_block(x, params, h, scale))
        plain_ms = time_ms(lambda: fused_transformer_block_reference(x, params, h, scale))
        library_ms = time_ms(lambda: lib(x))

    flops = block_flops(b, t)
    nbytes = 2 * x.numel() * 4 + sum(p.numel() for p in params) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  kernel {ms:.4f} ms (training, saving for the backward: {ms_tr:.4f} ms), "
        f"plain {plain_ms:.4f} ms, TransformerEncoderLayer "
        f"{library_ms:.4f} ms (its max_abs_err {lib_err:.3e}), bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "fused_transformer_block", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:458",
        "max_abs_err": max(err, err_tr), "max_abs_err_eval": err,
        "max_abs_err_training": err_tr, "tol": BLOCK_TOL, "ms": ms, "kernel_ms": ms,
        "training_ms": ms_tr,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "torch.nn.TransformerEncoderLayer(norm_first=True), eval",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"x": list(x.shape), "heads": h, "ffn": f},
    }


def ptxas_usage(kind: str, hidden: int) -> dict:
    """What ``ptxas -v`` reported for ``lstm_{kind}_cluster<hidden>``:
    registers, spill stores and loads, stack bytes."""
    name = f"lstm_{kind}_clusterILi{hidden}E"
    return ptxas_of(name)[name]


def plan_text(plan) -> str:
    return (f"clusters of {plan.cluster} CTAs x {plan.batch_tile} rows, {plan.ctas} CTAs of "
            f"{plan.threads} threads")


def check_lstm(gen: torch.Generator) -> dict:
    """Both of the speech encoder's recurrences: H=128 (input 64) and H=4
    (input 256), forward and reverse packed, batch 128, T=192."""
    t, d, b = 192, 2, 128
    dev = "cuda"
    shapes = []
    with torch.inference_mode():
        for hidden, in_dim in ((128, 64), (4, 256)):
            lim = 1.0 / hidden ** 0.5
            xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to(dev)
            whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(dev)
            got = lstm_scan_packed(xw, whh)
            torch.cuda.synchronize()
            want = lstm_scan_reference(xw, whh)
            err = float((got - want).abs().max())
            log(f"lstm_scan_packed xw{tuple(xw.shape)}: max_abs_err {err:.3e} "
                f"(tol {LSTM_TOL:g})")
            if not err <= LSTM_TOL:
                raise AssertionError(f"LSTM recurrence disagrees with its twin: {err}")
            # yardstick: cuDNN's biLSTM, input projection included
            lib = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True,
                                device=dev).eval()
            x = torch.randn(b, t, in_dim, generator=gen).to(dev)
            ms = time_ms(lambda: lstm_scan_packed(xw, whh))
            plain_ms = time_ms(lambda: lstm_scan_reference(xw, whh))
            library_ms = time_ms(lambda: lib(x))
            flops = 2 * hidden * 4 * hidden * t * b * d
            nbytes = (xw.numel() + whh.numel() + t * d * b * hidden) * 4
            bound_ms, bound_by = bound(flops, nbytes)
            plan = lstm_launch_plan(b, d, hidden)
            usage = ptxas_usage("fwd", hidden)
            log(f"  H={hidden}: kernel {ms:.4f} ms ({ms / t * 1e3:.3f} us/step), plain "
                f"{plain_ms:.4f} ms, nn.LSTM {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); {plan_text(plan)}; ptxas {usage}")
            shape = {
                "hidden": hidden, "xw": list(xw.shape), "max_abs_err": err, "ms": ms,
                "us_per_step": ms / t * 1e3, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "plan": plan._asdict(), "ptxas": usage,
            }
            shapes.append(shape)
    total = lambda key: sum(s[key] for s in shapes)  # noqa: E731
    return {
        "name": "lstm_scan_packed", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_lstm.py:219",
        "max_abs_err": max(s["max_abs_err"] for s in shapes), "tol": LSTM_TOL,
        "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"),
        "library_call": "torch.nn.LSTM(bidirectional=True), input projection included",
        "bound_ms": total("bound_ms"),
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "times_are": "sums over the two recurrences of one speech chunk",
        "shapes": shapes,
    }


def grad_err(got, want) -> float:
    """max abs error over max(1, max |want|): relative for large gradients,
    absolute for ones that are zero in exact arithmetic (the key bias's)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def check_block_backward(x, params, gen: torch.Generator) -> dict:
    """Kernel #2 through the autograd Function against autograd through the
    twin, in training mode at the flagship's rates: dx and the 16 dparams."""
    b, t, e = x.shape
    h, scale = 8, e ** 0.5
    g = torch.randn(b, t, e, generator=gen).to("cuda")
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    out = fused_transformer_block(leaves[0], leaves[1:], h, scale, training=True,
                                  seed=FLAGSHIP_DROP.seed, drop_p=0.5, ffn_drop_p=0.5)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    ref = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    want_out = fused_transformer_block_reference(ref[0], ref[1:], h, scale, *FLAGSHIP_DROP)
    want = torch.autograd.grad(want_out, ref, g, retain_graph=True)
    errs = [grad_err(a, w) for a, w in zip(got, want)]
    abs_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    log(f"fused_block_backward (training, drop 0.5/0.5): worst gradient error "
        f"{max(errs):.3e} (tol {BLOCK_BWD_TOL:g} x max(1, max|ref|)), max_abs_err "
        f"{abs_err:.3e}; per leaf {[f'{v:.1e}' for v in errs]}")
    if not max(errs) <= BLOCK_BWD_TOL:
        raise AssertionError(f"block backward disagrees with autograd through its twin: {errs}")

    _, saved = fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP, save=True)

    def run():
        dx, dparams = fused_block_backward(x, params, g, saved, h, scale, FLAGSHIP_DROP)
        return (dx, *dparams)

    assert_repeats("fused_block_backward", run)
    ms = time_ms(run)
    parts = kernel_parts(run, {"rows": ("ffn_bwd_kernel", "qkv_bwd_kernel"),
                               "attention": ("attn_bwd_kernel",),
                               "dw": ("products_kernel",), "sums": ("sums_kernel",)})
    dw_flops = 2.0 * b * t * (2 * e * 256 + 4 * e * e)
    dw_tflops = dw_flops / (parts["parts_ms"]["dw"] * 1e-3) / 1e12
    usage = ptxas_of("ffn_bwd_kernel", "attn_bwd_kernel", "qkv_bwd_kernel", "products_kernel",
                     "sums_kernel")
    log(f"  parts (device ms per call, torch.profiler): {json.dumps(parts['parts_ms'])}; "
        f"{parts['launches_per_call']:g} device launches per call; dW products "
        f"{dw_flops / 1e9:.3f} GFLOP at {dw_tflops:.2f} TFLOP/s (f32 peak "
        f"{PEAK_F32_FLOPS / 1e12:g}); ptxas {json.dumps(usage)}")
    if parts["launches_per_call"] > 6:
        raise AssertionError(f"fused_block_backward takes {parts['launches_per_call']} "
                             f"launches a call, want at most 6")
    plain_ms = time_ms(lambda: torch.autograd.grad(want_out, ref, g, retain_graph=True))
    lib = library_layer(params).train()
    xl = x.clone().requires_grad_()
    lib_leaves = [xl] + list(lib.parameters())
    lib_out = lib(xl)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g, retain_graph=True))
    # dX and dW for each forward product: twice the forward's operations;
    # bytes: x, g, the saved activations and the parameters in, dx and dparams out
    flops = 2 * block_flops(b, t)
    n_par = sum(p.numel() for p in params)
    nbytes = 4 * (2 * x.numel() + saved.numel() + n_par + x.numel() + n_par)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  kernel {ms:.4f} ms, plain (autograd through the twin) {plain_ms:.4f} ms, "
        f"TransformerEncoderLayer backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "fused_block_backward", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block_bwd.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:498",
        "max_abs_err": abs_err, "max_grad_err": max(errs), "tol": BLOCK_BWD_TOL,
        "tol_is": "max abs error / max(1, max|ref|), per gradient",
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "backward of torch.nn.TransformerEncoderLayer(norm_first=True)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "parts_ms": parts["parts_ms"], "parts_launches": parts["parts_launches"],
        "device_launches_per_call": parts["launches_per_call"],
        "dw_tflops": dw_tflops, "repeats_bit_for_bit": True, "ptxas": usage,
        "shape": {"x": list(x.shape), "heads": h, "ffn": 256, "drop": [0.5, 0.5]},
    }


def check_lstm_backward(gen: torch.Generator) -> dict:
    """Kernel #4 through the autograd Function against autograd through the
    twin, for both of the speech encoder's recurrences (H=128 and H=4)."""
    t, d, b = 192, 2, 128
    dev = "cuda"
    shapes = []
    for hidden, in_dim in ((128, 64), (4, 256)):
        lim = 1.0 / hidden ** 0.5
        xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to(dev)
        whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(dev)
        g = torch.randn(t, d, b, hidden, generator=gen).to(dev)
        a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        got = torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)
        torch.cuda.synchronize()
        ra, rw = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        ref_h = lstm_scan_reference(ra, rw)
        want = torch.autograd.grad(ref_h, (ra, rw), g, retain_graph=True)
        errs = [grad_err(u, v) for u, v in zip(got, want)]
        abs_err = max(float((u - v).abs().max()) for u, v in zip(got, want))
        log(f"lstm_scan_backward H={hidden}: dxw error {errs[0]:.3e}, dwhh error "
            f"{errs[1]:.3e} (tol {LSTM_BWD_TOL:g} x max(1, max|ref|)), max_abs_err {abs_err:.3e}")
        if not max(errs) <= LSTM_BWD_TOL:
            raise AssertionError(f"LSTM backward disagrees with autograd through its twin: {errs}")
        h, c, gates = lstm_forward_cuda(xw, whh, return_c=True, save_gates=True)
        ms = time_ms(lambda: lstm_scan_backward(whh, h, c, gates, g))
        # its two parts apart: the recurrence (dxw) and the dwhh reduction
        dxw = lstm_backward_recurrence(whh, c, gates, g)
        recurrence_ms = time_ms(lambda: lstm_backward_recurrence(whh, c, gates, g))
        dwhh_ms = time_ms(lambda: lstm_dwhh(h, dxw))
        dwhh_tflops = 2.0 * (t - 1) * d * b * hidden * 4 * hidden / (dwhh_ms * 1e-3) / 1e12
        plan = lstm_launch_plan(b, d, hidden)
        usage = ptxas_usage("bwd", hidden)
        plain_ms = time_ms(lambda: torch.autograd.grad(ref_h, (ra, rw), g, retain_graph=True),
                           reps=5, warmup=1)
        lib = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True, device=dev)
        xl = torch.randn(b, t, in_dim, generator=gen).to(dev).requires_grad_()
        lib_leaves = [xl] + list(lib.parameters())
        lib_out, _ = lib(xl)
        g_lib = torch.randn(b, t, 2 * hidden, generator=gen).to(dev)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g_lib,
                                                         retain_graph=True))
        rows = t * d * b
        flops = 2 * rows * 4 * hidden * hidden * 2  # dpre whh^T and h_prev^T dpre
        nbytes = 4 * (2 * rows * 4 * hidden + 3 * rows * hidden + 2 * whh.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  H={hidden}: kernel {ms:.4f} ms ({ms / t * 1e3:.3f} us/step): recurrence "
            f"{recurrence_ms:.4f} ms ({recurrence_ms / t * 1e3:.3f} us/step), dwhh "
            f"{dwhh_ms:.4f} ms ({dwhh_tflops:.2f} TFLOP/s, two launches); plain {plain_ms:.4f} ms, nn.LSTM backward {library_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}); {plan_text(plan)}; ptxas {usage}")
        shape = {
            "hidden": hidden, "xw": list(xw.shape), "max_abs_err": abs_err,
            "max_grad_err": max(errs), "ms": ms, "us_per_step": ms / t * 1e3,
            "recurrence_ms": recurrence_ms, "recurrence_us_per_step": recurrence_ms / t * 1e3,
            "dwhh_ms": dwhh_ms, "dwhh_tflops": dwhh_tflops, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan._asdict(),
            "ptxas": usage,
        }
        shapes.append(shape)
    total = lambda key: sum(s[key] for s in shapes)  # noqa: E731
    return {
        "name": "lstm_scan_backward", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/lstm_scan_bwd.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_lstm.py:290",
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_grad_err": max(s["max_grad_err"] for s in shapes), "tol": LSTM_BWD_TOL,
        "tol_is": "max abs error / max(1, max|ref|), per gradient",
        "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"),
        "library_call": "backward of torch.nn.LSTM(bidirectional=True), input "
                        "projection's gradients included",
        "bound_ms": total("bound_ms"),
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "times_are": "sums over the two recurrences of one train step",
        "shapes": shapes,
    }


def conv_case(gen: torch.Generator, k: int, b: int = 128, t: int = 192, c: int = 64):
    """Flagship conv-block inputs on the card: x [128, 192, 64], w [64, 64, K]
    and b at torch's init scale, a perturbed [T, C] LayerNorm affine, and an
    upstream gradient."""
    lim = 1.0 / (c * k) ** 0.5
    x = torch.randn(b, t, c, generator=gen)
    w = (torch.rand(c, c, k, generator=gen) * 2 - 1) * lim
    bb = (torch.rand(c, generator=gen) * 2 - 1) * lim
    scale = 1 + 0.1 * torch.randn(t, c, generator=gen)
    bias = 0.1 * torch.randn(t, c, generator=gen)
    g = torch.randn(b, t, c, generator=gen)
    return [v.to("cuda") for v in (x, w, bb, scale, bias, g)]


def unfused_block(w, bb, scale, bias) -> BasicBlock:
    """The port's unfused BasicBlock (cuDNN conv, LayerNorm, GELU) holding
    the same parameters: the yardstick of kernels #5 and #6."""
    c, _, k = w.shape
    block = BasicBlock(c, c, k, scale.shape[0], CONV_DROP.drop_p).to("cuda")
    with torch.no_grad():
        for dst, src in ((block.conv.weight, w), (block.conv.bias, bb),
                         (block.normalization.weight, scale), (block.normalization.bias, bias)):
            dst.copy_(src)
    return block


def conv_flops(x, k) -> float:
    b, t, c = x.shape
    return 2.0 * b * t * k * c * c


def check_conv(gen: torch.Generator):
    """Kernels #5, #6 and #7 at the flagship's shapes, for the EEG blocks'
    K=64 and the speech block's K=32: one dict each, whose top-level numbers
    are K=64's (10 of a step's 11 launches) and whose ``shapes`` hold both."""
    fwd, bwd, alone = [], [], []
    for k in (64, 32):
        x, w, bb, scale, bias, g = conv_case(gen, k)
        b, t, c = x.shape
        lib = unfused_block(w, bb, scale, bias)
        with torch.inference_mode():
            errs = {}
            for mode, drop in (("eval", DropoutConfig()), ("training", CONV_DROP)):
                got = fused_basic_block(x, w, bb, scale, bias, drop.seed, k, drop.drop_p,
                                        drop.training)
                torch.cuda.synchronize()
                want = fused_basic_block_reference(x, w, bb, scale, bias, drop.seed, k,
                                                   drop.drop_p, drop.training)
                errs[mode] = float((got - want).abs().max())
            lib_err = float((lib.eval()(x) - fused_basic_block_reference(
                x, w, bb, scale, bias, 0, k, 0.0, False)).abs().max())
            log(f"fused_basic_block K={k} x{tuple(x.shape)}: max_abs_err eval "
                f"{errs['eval']:.3e}, training (drop 0.2) {errs['training']:.3e} "
                f"(tol {CONV_TOL:g}); unfused BasicBlock {lib_err:.3e}")
            if not max(errs.values()) <= CONV_TOL:
                raise AssertionError(f"fused conv block disagrees with its twin: {errs}")
            ms = time_ms(lambda: fused_basic_block(x, w, bb, scale, bias, 0, k, 0.0, False))
            ms_tr = time_ms(lambda: fused_conv_forward_cuda(x, w, bb, scale, bias, CONV_DROP,
                                                            save=True))
            plain_ms = time_ms(lambda: fused_basic_block_reference(x, w, bb, scale, bias, 0, k,
                                                                   0.0, False))
            library_ms = time_ms(lambda: lib(x))
        nbytes = 4 * (2 * x.numel() + w.numel() + c + 2 * t * c)
        bound_ms, bound_by = bound(conv_flops(x, k), nbytes)
        log(f"  kernel {ms:.4f} ms (training, saving for the backward: {ms_tr:.4f} ms), "
            f"plain {plain_ms:.4f} ms, unfused BasicBlock {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {conv_flops(x, k) / 1e9:.3f} GFLOP)")
        fwd.append({"k": k, "x": list(x.shape), "max_abs_err_eval": errs["eval"],
                    "max_abs_err_training": errs["training"], "ms": ms, "training_ms": ms_tr,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                    "bound_by": bound_by})

        # #6 through the autograd Function against autograd through the twin
        leaves = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
        out = fused_basic_block(*leaves, CONV_DROP.seed, k, CONV_DROP.drop_p, True)
        got = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        ref = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
        want_out = fused_basic_block_reference(*ref, CONV_DROP.seed, k, CONV_DROP.drop_p, True)
        want = torch.autograd.grad(want_out, ref, g, retain_graph=True)
        names = ("dx", "dw", "db", "dscale", "dbias")
        gerrs = {n: grad_err(a, r) for n, a, r in zip(names, got, want)}
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        log(f"fused_conv_backward K={k} (training, drop 0.2): gradient errors "
            f"{ {n: f'{v:.1e}' for n, v in gerrs.items()} } (tol {CONV_BWD_TOL:g} x max(1, "
            f"max|ref|)), max_abs_err {abs_err:.3e}")
        if not max(gerrs.values()) <= CONV_BWD_TOL:
            raise AssertionError(f"conv backward disagrees with autograd through its twin: "
                                 f"{gerrs}")
        _, z, stats = fused_conv_forward_cuda(x, w, bb, scale, bias, CONV_DROP, save=True)
        run = lambda: fused_conv_backward(x, w, scale, bias, g, z, stats, CONV_DROP)  # noqa: E731
        assert_repeats(f"fused_conv_backward K={k}", run)
        ms = time_ms(run)
        # the rest is dx: #7 on dconv and the copies that flip and re-lay its weights
        parts = kernel_parts(run, {"rows": ("conv_bwd_rows_kernel",),
                                   "dw": ("dw_partial_kernel",), "sums": ("sums_kernel",)},
                             rest="dx")
        own = parts["launches_per_call"] - parts["parts_launches"]["dx"]
        dw_tflops = conv_flops(x, k) / (parts["parts_ms"]["dw"] * 1e-3) / 1e12
        usage = ptxas_of("conv_bwd_rows_kernel", "dw_partial_kernel", "sums_kernel")
        log(f"  parts (device ms per call, torch.profiler): {json.dumps(parts['parts_ms'])}; "
            f"{own:g} device launches per call without dx, {parts['launches_per_call']:g} "
            f"with; dW {conv_flops(x, k) / 1e9:.3f} GFLOP at {dw_tflops:.2f} TFLOP/s (f32 "
            f"peak {PEAK_F32_FLOPS / 1e12:g}); ptxas {json.dumps(usage)}")
        if own > 5:
            raise AssertionError(f"fused_conv_backward takes {own} launches a call without "
                                 f"its dx, want at most 5")
        plain_ms = time_ms(lambda: torch.autograd.grad(want_out, ref, g, retain_graph=True))
        lib.train()
        lib.dropout.dropout_seed = CONV_DROP.seed
        xl = x.clone().requires_grad_()
        lib_leaves = [xl] + list(lib.parameters())
        lib_out = lib(xl)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g,
                                                         retain_graph=True))
        # dW and dx; bytes: x, g, z, stats and the parameters in, the gradients out
        flops = 2 * conv_flops(x, k)
        nbytes = 4 * (4 * x.numel() + 2 * b + 2 * (w.numel() + c + 2 * t * c))
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  kernel (dx by #7 included) {ms:.4f} ms, plain (autograd through the twin) "
            f"{plain_ms:.4f} ms, unfused BasicBlock backward {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.3f} GFLOP)")
        bwd.append({"k": k, "x": list(x.shape), "max_abs_err": abs_err,
                    "max_grad_err": max(gerrs.values()), "grad_err": gerrs, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "parts_ms": parts["parts_ms"],
                    "parts_launches": parts["parts_launches"],
                    "device_launches_per_call": parts["launches_per_call"],
                    "device_launches_without_dx": own,
                    "dw_tflops": dw_tflops, "repeats_bit_for_bit": True, "ptxas": usage})

        # #7, the conv alone, against F.conv1d
        with torch.inference_mode():
            lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
            got = conv1d_same(x, w)
            torch.cuda.synchronize()
            err = float((got - conv1d_reference(x, w, (lo, hi))).abs().max())
            log(f"conv1d_same K={k}: max_abs_err against F.conv1d {err:.3e} (tol {CONV_TOL:g})")
            if not err <= CONV_TOL:
                raise AssertionError(f"conv1d_same disagrees with F.conv1d: {err}")
            xcp = torch.nn.functional.pad(x.transpose(1, 2), (lo, hi)).contiguous()
            ms = time_ms(lambda: conv1d_same(x, w))
            plain_ms = time_ms(lambda: conv1d_reference(x, w, (lo, hi)))
            library_ms = time_ms(lambda: torch.nn.functional.conv1d(xcp, w))
        bound_ms, bound_by = bound(conv_flops(x, k), 4 * (2 * x.numel() + w.numel()))
        log(f"  kernel {ms:.4f} ms, plain (pad + F.conv1d + transposes) {plain_ms:.4f} ms, "
            f"F.conv1d on the padded [B, C, T] input {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        alone.append({"k": k, "x": list(x.shape), "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by})
        del x, w, bb, scale, bias, g, lib, leaves, out, got, ref, want_out, want, z, stats
        torch.cuda.empty_cache()

    def entry(name, source, replaces, shapes, tol, library_call, **extra):
        top = shapes[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": max(s.get("max_abs_err", 0.0) for s in shapes), "tol": tol,
                "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
                "library_ms": top["library_ms"], "library_call": library_call,
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "times_are": "K=64 (the EEG blocks), per launch; shapes holds K=32",
                "shapes": shapes, **extra}

    for s in fwd:
        s["max_abs_err"] = max(s["max_abs_err_eval"], s["max_abs_err_training"])
    return [
        entry("fused_basic_block", "transformer_clip_eeg_tpu_torch/csrc/fused_conv.cu",
              "transformer_clip_eeg_tpu/ops/pallas_conv.py:267", fwd, CONV_TOL,
              "the port's unfused BasicBlock in eval (cuDNN conv, layer_norm, gelu)",
              training_ms=fwd[0]["training_ms"]),
        entry("fused_conv_backward", "transformer_clip_eeg_tpu_torch/csrc/fused_conv_bwd.cu",
              "transformer_clip_eeg_tpu/ops/pallas_conv.py:308", bwd, CONV_BWD_TOL,
              "backward of the port's unfused BasicBlock in training",
              max_grad_err=max(s["max_grad_err"] for s in bwd),
              tol_is="max abs error / max(1, max|ref|), per gradient"),
        entry("conv1d_same", "transformer_clip_eeg_tpu_torch/csrc/fused_conv.cu",
              "scripts/bench_conv_algo.py:74", alone, CONV_TOL,
              "torch.nn.functional.conv1d on the padded [B, C, T] input"),
    ]


def _post(url, payload=None, body=None, headers=None):
    data = body if body is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
    if ctype.startswith(NPY_CONTENT_TYPE):
        return np.load(io.BytesIO(raw))
    return json.loads(raw)


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _check_embeddings(name: str, emb: np.ndarray, n: int, dim: int) -> None:
    if emb.shape != (n, dim):
        raise AssertionError(f"{name}: shape {emb.shape}, want {(n, dim)}")
    if not np.isfinite(emb).all():
        raise AssertionError(f"{name}: non-finite values")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    if norm_err > 1e-4:
        raise AssertionError(f"{name}: norms off by {norm_err}")


def _device_us(evt) -> float:
    val = getattr(evt, "self_device_time_total", None)
    return float(val if val is not None else evt.self_cuda_time_total)


def profile_calls(fn, reps: int, top: int = 8) -> dict:
    """Where the time of ``reps`` calls of ``fn()`` goes, under
    ``torch.profiler``: host clock per call, device time per call summed
    over every device operation, the device operations (kernels, copies) per
    call, the device's idle share of the window, and the ``top`` operations
    that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side records only (kernels, copies); the CPU operator that
    # launched a kernel reports the same time again and is left out
    rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and not evt.key.startswith("Activity Buffer")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    device_us = sum(r[1] for r in rows)
    return {
        "reps": reps,
        "host_ms_per_call": wall_s / reps * 1e3,
        "device_ms_per_call": device_us / reps / 1e3,
        "device_ops_per_call": sum(r[2] for r in rows) / reps,
        "device_idle_share": max(0.0, 1 - device_us / 1e6 / wall_s),
        "top_ops": [
            {"op": key[:80], "device_ms_per_call": us / reps / 1e3,
             "share_of_device": us / device_us, "calls_per_call": count / reps}
            for key, us, count in rows[:top]
        ],
    }


def kernel_parts(fn, parts: dict, rest: str = "", reps: int = 5) -> dict:
    """The device time and the device launches of one call of ``fn()`` by
    part, under ``torch.profiler``: ``parts`` maps a part's name to the
    kernel names (substrings) that make it up; any other device operation
    goes to the part ``rest``, or fails the run when there is none."""
    prof = profile_calls(fn, reps, top=64)
    names = list(parts) + ([rest] if rest else [])
    ms, launches = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for op in prof["top_ops"]:
        hits = [name for name, keys in parts.items() if any(k in op["op"] for k in keys)]
        if len(hits) > 1 or not (hits or rest):
            raise AssertionError(f"device operation {op['op']!r} belongs to parts {hits}")
        part = hits[0] if hits else rest
        ms[part] += op["device_ms_per_call"]
        launches[part] += op["calls_per_call"]
    return {"parts_ms": ms, "parts_launches": launches,
            "launches_per_call": prof["device_ops_per_call"]}


def ptxas_of(*names: str) -> dict:
    """What ``ptxas -v`` reported for the kernels whose mangled name holds one
    of ``names``, by that name (of a kernel compiled into several translation
    units, the copy with the most registers)."""
    out = {}
    for mangled, usage in _build.ptxas_usage().items():
        for name in names:
            if name in mangled and usage["registers"] >= out.get(name, usage)["registers"]:
                out[name] = usage
    if sorted(out) != sorted(names):
        raise AssertionError(f"ptxas -v reported {sorted(out)}, want {sorted(names)}")
    return out


def assert_repeats(name: str, run) -> None:
    """Two calls of ``run()`` (a tuple of tensors) give the same bits."""
    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs between two calls")
    log(f"{name}: two calls give the same bits in all {len(first)} outputs")


def profile_chunk(name: str, fn, windows: np.ndarray, reps: int = 5) -> dict:
    """One full chunk through an embedder, ``reps`` times (copies included)."""
    return {"embedder": name, **profile_calls(lambda: fn(windows), reps)}


def serve_path() -> dict:
    cfg = TrainConfig()  # the flagship run's defaults
    t_win, sp_dim = cfg.window_length, cfg.speech_dimension
    t0 = time.perf_counter()
    model = build_model_from_config(cfg, bank_size=BANK_SIZE, device="cuda", seed=0)
    session = InferenceSession(model, chunk=128, device="cuda")
    dim = model.eegModel.get_output_dim(t_win)
    index = RetrievalIndex(dim, capacity=4096, device="cuda")
    service = EmbeddingService(session, index, info={
        "model_arch": cfg.model_arch, "eeg_encoder": cfg.eeg_encoder,
        "speech_encoder": cfg.speech_encoder, "window_length": t_win,
    })
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    log(f"serving the flagship model ({sum(p.numel() for p in model.parameters())} "
        f"parameters, embedding dim {dim}) at {url}, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    eeg = rng.standard_normal((300, t_win, 64)).astype(np.float32)
    speech = rng.standard_normal((130, t_win, sp_dim)).astype(np.float32)
    mm_eeg, cand_a, cand_b = eeg[:4], speech[:4], speech[4:8]
    npy_headers = {"Content-Type": NPY_CONTENT_TYPE, "Accept": NPY_CONTENT_TYPE}
    timings = {}
    try:
        for f in COUNTERS:
            f.launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        t1 = time.perf_counter()
        eeg_emb = _post(f"{url}/v1/embed/eeg?normalize=1", body=_npy(eeg),
                        headers=npy_headers)
        t2 = time.perf_counter()
        sp_emb = _post(f"{url}/v1/embed/speech", body=_npy(speech), headers=npy_headers)
        t3 = time.perf_counter()
        added = _post(f"{url}/v1/retrieval/add", {"embeddings": sp_emb.tolist()})
        top = _post(f"{url}/v1/retrieval/topk?k=5", body=_npy(eeg_emb[:16]),
                    headers={"Content-Type": NPY_CONTENT_TYPE})
        t4 = time.perf_counter()
        mm = _post(f"{url}/v1/match_mismatch", {
            "eeg": mm_eeg.tolist(), "cand_a": cand_a.tolist(), "cand_b": cand_b.tolist(),
        })
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in COUNTERS}
        timings = {
            "healthz_s": t1 - t0, "embed_eeg_300_s": t2 - t1,
            "embed_speech_130_s": t3 - t2, "retrieval_add_topk_s": t4 - t3,
            "match_mismatch_4_s": t5 - t4,
        }
        log(f"routes answered; host seconds per request: {json.dumps(timings)}")

        # what the routes should have launched: 300 + 4 EEG windows are 3 + 1
        # chunks of 128; 130 + 4 + 4 speech windows are 2 + 1 + 1 chunks; no
        # backward and no conv kernel (the conv blocks are unfused by default)
        want = dict.fromkeys(launches, 0)
        want.update(fused_transformer_block=10 * 4, lstm_scan_packed=2 * 4)
        if launches != want:
            raise AssertionError(f"kernel launches on the serving path {launches}, "
                                 f"want {want}")
        log(f"kernel launches on the serving path: {launches}")

        if health.get("status") != "ok" or health.get("index_capacity") != 4096:
            raise AssertionError(f"bad /healthz answer {health}")
        _check_embeddings("embed/eeg", eeg_emb, 300, dim)
        _check_embeddings("embed/speech", sp_emb, 130, dim)
        if added["ids"] != list(range(130)) or added["size"] != 130:
            raise AssertionError(f"bad /v1/retrieval/add answer: size {added['size']}")
        sims = eeg_emb[:16] @ sp_emb.T
        want_ids = np.argsort(-sims, axis=1, kind="stable")[:, :5]
        got_ids = np.asarray(top["ids"])
        got_scores = np.asarray(top["scores"])
        want_scores = np.take_along_axis(sims, want_ids, 1)
        if float(np.abs(got_scores - want_scores).max()) > 1e-4:
            raise AssertionError("top-k scores disagree with numpy")
        if not np.array_equal(got_ids, want_ids):
            # ids may differ only where scores tie to within the tolerance
            gap = np.abs(np.take_along_axis(sims, got_ids, 1) - want_scores).max()
            if gap > 1e-5:
                raise AssertionError("top-k ids disagree with numpy")

        # the same answers straight from the session (no HTTP)
        direct = session.embed_eeg(eeg, normalize=True)
        http_err = float(np.abs(direct - eeg_emb).max())
        emb_mm = session.embed_eeg(mm_eeg)
        want_dec = match_mismatch_decide(emb_mm, session.embed_speech(cand_a),
                                         session.embed_speech(cand_b))
        if mm["decisions"] != want_dec.tolist():
            raise AssertionError(f"match_mismatch {mm['decisions']} != {want_dec}")
        if http_err > 1e-5:
            raise AssertionError(f"HTTP and direct EEG embeddings differ by {http_err}")

        # 8 windows against a CPU session holding the same weights
        cpu_model = build_model_from_config(cfg, bank_size=BANK_SIZE, device="cpu", seed=0)
        cpu_session = InferenceSession(cpu_model, chunk=8, device="cpu")
        eeg_err = float(np.abs(cpu_session.embed_eeg(eeg[:8]) - session.embed_eeg(eeg[:8])).max())
        sp_err = float(np.abs(cpu_session.embed_speech(speech[:8])
                              - session.embed_speech(speech[:8])).max())
        log(f"card vs CPU session, 8 windows: eeg max_abs_err {eeg_err:.3e}, speech "
            f"{sp_err:.3e} (tol {SERVE_TOL:g})")
        if not (eeg_err <= SERVE_TOL and sp_err <= SERVE_TOL):
            raise AssertionError("card and CPU sessions disagree")

        # steady-state time of one full chunk through each embedder
        chunk_eeg, chunk_sp = eeg[:128], speech[:128]
        for _ in range(2):
            session.embed_eeg(chunk_eeg)
            session.embed_speech(chunk_sp)
        reps = {"eeg": [], "speech": []}
        for _ in range(10):
            t0 = time.perf_counter()
            session.embed_eeg(chunk_eeg)
            reps["eeg"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            session.embed_speech(chunk_sp)
            reps["speech"].append(time.perf_counter() - t0)
        chunk_ms = {k: statistics.median(v) * 1e3 for k, v in reps.items()}
        log(f"one 128-window chunk, host clock incl. copies, median of 10: "
            f"eeg {chunk_ms['eeg']:.3f} ms, speech {chunk_ms['speech']:.3f} ms")
        profiles = [profile_chunk("eeg", session.embed_eeg, chunk_eeg),
                    profile_chunk("speech", session.embed_speech, chunk_sp)]
        for p in profiles:
            log(json.dumps({"profile": p}))
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(timeout=30)
    return {"launches": launches, "http_s": timings, "chunk_ms": chunk_ms,
            "cpu_err": {"eeg": eeg_err, "speech": sp_err}}


# loss.txt of a 2-epoch run, line by line: the JAX trainer's formats
LOSS_LINES = [r"number of parameters \d+",
              r"no model found at .*, training from scratch"] + [
    line.replace("{e}", str(e)) for e in range(2) for line in (
        r"train epoch {e} batch 0 loss_ce (\S+) loss average eeg (\S+)",
        r"epoch {e} done in \d+\.\ds \(\d+ pairs/s\)",
        r'epoch {e} phases \{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+\}',
        r"validation epoch {e}: mean loss ce : (\S+), mean loss average: (\S+), "
        r"mean loss total: (\S+)",
    )] + [r"training done: best val loss_ce \S+ at epoch \d"]
COUNTERS = (fused_transformer_block, fused_block_backward, lstm_scan_packed,
            lstm_scan_backward, fused_basic_block, fused_conv_backward, conv1d_same)


def set_fused(model, on: bool = True) -> int:
    """``fused`` on every BasicBlock of ``model``; returns how many take the
    fused path (those that are square and undilated, when ``on``)."""
    n = 0
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.fused = on
            n += m.takes_fused_path
    return n


def card_vs_cpu_step(cfg, host_batch, fused: bool = False) -> dict:
    """One training step's forward and gradients at batch 8, dropout on, on
    the card and on the CPU: same weights (seed 0), same batch, same step
    seed, so the same masks.  Compares the losses, every gradient and the
    bank's rows after the step's EMA update.  ``fused`` sets ``fused`` on the
    BasicBlocks of both models."""
    out = {}
    ids = host_batch["ids"][:8]
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, cfg.bank_size, device=dev, seed=0).train()
        set_fused(model, fused)
        set_dropout_seeds(model, fold_seed(99, 0))
        batch = [torch.from_numpy(host_batch[k][:8]).to(dev) for k in ("eeg", "speech", "ids")]
        losses = model(*batch)
        params = list(model.parameters())
        grads = torch.autograd.grad(losses[2], params, allow_unused=True)
        out[dev] = {
            "losses": [float(v.detach()) for v in losses],
            "grads": [torch.zeros_like(p) if g is None else g.detach().cpu()
                      for g, p in zip(grads, params)],
            "names": [n for n, _ in model.named_parameters()],
            "bank": model.eegMemoryBank.memory[torch.from_numpy(ids).to(dev)].cpu(),
        }
    gpu, cpu = out["cuda"], out["cpu"]
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(gpu["losses"], cpu["losses"]))
    # each leaf relative to its own largest gradient; the floor only keeps a
    # leaf that is zero in exact arithmetic (each block's key bias) finite
    top = max(float(g.abs().max()) for g in cpu["grads"])
    errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), STEP_GRAD_FLOOR * top)
            for n, a, b in zip(cpu["names"], gpu["grads"], cpu["grads"])}
    grad_err = max(errs.values())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:6]
    bank_err = float((gpu["bank"] - cpu["bank"]).abs().max())
    log(f"one train step at batch 8, dropout on{', conv blocks fused' if fused else ''}, "
        f"card vs CPU: losses {gpu['losses']} vs "
        f"{cpu['losses']} (err {loss_err:.2e}); worst gradient error {grad_err:.2e} "
        f"(max abs error over max(leaf max, {STEP_GRAD_FLOOR:g} x largest gradient)), worst "
        f"leaves {[(n, f'{v:.1e}') for n, v in worst]}; bank rows {bank_err:.2e} "
        f"(tol {STEP_TOL:g})")
    if not (loss_err <= STEP_TOL and grad_err <= STEP_TOL and bank_err <= STEP_TOL):
        raise AssertionError("the card's train step disagrees with the CPU's")
    return {"loss_err": loss_err, "grad_err": grad_err, "bank_err": bank_err,
            "grad_floor": STEP_GRAD_FLOOR * top, "grad_err_by_leaf": errs,
            "n_grads": len(gpu["grads"]), "losses_card": gpu["losses"],
            "losses_cpu": cpu["losses"]}


def train_path() -> dict:
    """The flagship trained at full width through the port's CLI."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    data_dir, results = os.path.join(RUN_DIR, "data"), os.path.join(RUN_DIR, "results")
    try:
        t0 = time.perf_counter()
        # 6 stories: the default --run 4 validates on fold 4, which the
        # fixture's round robin over stories[:-1] fills only from 5 stories
        # on; 400 s per story is one chunk of 133 windows at batch 128
        make_fixture(data_dir, n_stories=6, n_subjects=3, story_seconds=400, speech_dim=1024)
        log(f"fixture written in {time.perf_counter() - t0:.1f} s")
        for f in COUNTERS:
            f.launches = 0
        t0 = time.perf_counter()
        trainer = cli.train(["--data_dir", data_dir, "--epochs", "2", "--skip_eval", "yes",
                             "--results_folder", results], device="cuda")
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in COUNTERS}
        train_s = time.perf_counter() - t0
        cfg, history = trainer.cfg, trainer.history

        def steps(ds):
            return sum(c["eeg"].shape[0] for c in ds.chunks.values() if "eeg" in c)

        n_train, n_val = steps(trainer.train_dataset), steps(trainer.val_dataset)
        want = {"fused_transformer_block": 2 * 10 * (n_train + n_val),
                "fused_block_backward": 2 * 10 * n_train,
                "lstm_scan_packed": 2 * 2 * (n_train + n_val),
                "lstm_scan_backward": 2 * 2 * n_train,
                "fused_basic_block": 0, "fused_conv_backward": 0, "conv1d_same": 0}
        log(f"trained 2 epochs ({n_train} train and {n_val} validation steps each) in "
            f"{train_s:.1f} s; kernel launches {launches}")
        if launches != want or [len(h["step_s"]) for h in history] != [n_train] * 2:
            raise AssertionError(f"launches on the training path {launches}, want {want}")

        lines = open(trainer.loss_file).read().splitlines()
        values = []
        for line, fmt in zip(lines, LOSS_LINES):
            m = re.fullmatch(fmt, line)
            if m is None:
                raise AssertionError(f"loss.txt line {line!r} does not match {fmt!r}")
            values += [float(v) for v in m.groups()]
        if len(lines) != len(LOSS_LINES) or not all(np.isfinite(values)):
            raise AssertionError(f"loss.txt: {len(lines)} lines, losses {values}")
        ckpt_dir = trainer.checkpoint_dir
        for name in ("model_ckpt.pt", "best_meta.json"):
            if not os.path.exists(os.path.join(ckpt_dir, name)):
                raise AssertionError(f"no {name} in {ckpt_dir}")
        bank0 = build_model(cfg, cfg.bank_size, device="cpu", seed=cfg.seed).eegMemoryBank.memory
        moved = int((trainer.model.eegMemoryBank.memory.cpu() != bank0).any(dim=1).sum())
        if moved == 0:
            raise AssertionError("training left the memory bank as it was")
        log(f"loss.txt has the {len(lines)} expected lines, losses finite; checkpoint and "
            f"best_meta.json written; {moved} of {bank0.shape[0]} bank rows moved")

        # serve what was trained
        rng = np.random.default_rng(4)
        eeg = rng.standard_normal((8, cfg.window_length, 64)).astype(np.float32)
        speech = rng.standard_normal((8, cfg.window_length, 1024)).astype(np.float32)
        served = InferenceSession.from_results_dir(trainer.results_dir, device="cuda")
        live = InferenceSession(trainer.model, device="cuda")
        serve_err = max(float(np.abs(served.embed_eeg(eeg) - live.embed_eeg(eeg)).max()),
                        float(np.abs(served.embed_speech(speech) - live.embed_speech(speech)).max()))
        log(f"from_results_dir vs the trainer's model, 8 windows: max_abs_err {serve_err:.2e}")
        if not serve_err <= 1e-5:
            raise AssertionError("the served checkpoint is not the trained model")

        host_batch = next(batch_iterator(trainer.train_dataset))
        step = card_vs_cpu_step(cfg, host_batch)

        # step time: epoch 2's steps, host clock (the last closed by the drain)
        step_s = history[1]["step_s"]
        step_ms = statistics.median(step_s) * 1e3
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in host_batch.items()}
        run_step = lambda: train_step(trainer.model, trainer.optimizer, batch,  # noqa: E731
                                      cfg.seed + 1, False)
        run_step()
        profile = profile_calls(run_step, reps=3)
        train = {
            "config": "TrainConfig() defaults at full width, --epochs 2", "batch": cfg.batch_size,
            "train_steps_per_epoch": n_train, "val_steps_per_epoch": n_val,
            "step_ms_median_epoch2": step_ms, "step_ms_all_epoch2": [v * 1e3 for v in step_s],
            "pairs_per_s_epoch2": cfg.batch_size / (step_ms / 1e3),
            "epoch_pairs_per_s": [h["train_pairs_per_s"] for h in history],
            "val_loss_ce": [h["val_loss_ce"] for h in history],
            "launches": launches, "card_vs_cpu_step": step, "serve_err": serve_err,
            "profile_3_steps": profile,
        }
        log(json.dumps({"train": train}))
        return train, cfg, host_batch
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)


def fused_path(cfg, host_batch) -> dict:
    """The flagship with its 11 square BasicBlocks fused: embeddings against
    the unfused model and a CPU copy, one step card vs CPU, the exact
    launches per chunk and per step, and the step time fused and unfused."""
    rng = np.random.default_rng(5)
    eeg = rng.standard_normal((128, cfg.window_length, 64)).astype(np.float32)
    speech = rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)
                                 ).astype(np.float32)
    models = {}
    for name, dev, fused in (("fused", "cuda", True), ("unfused", "cuda", False),
                             ("cpu", "cpu", True)):
        models[name] = build_model(cfg, cfg.bank_size, device=dev, seed=0)
        n = set_fused(models[name], fused)
        if n != (N_FUSED_BLOCKS if fused else 0):
            raise AssertionError(f"{name}: {n} BasicBlocks take the fused path")
    sessions = {name: InferenceSession(m, chunk=8 if name == "cpu" else 128,
                                       device="cpu" if name == "cpu" else "cuda")
                for name, m in models.items()}
    emb = {name: (sess.embed_eeg(eeg[:8]), sess.embed_speech(speech[:8]))
           for name, sess in sessions.items()}
    emb_err = {f"{other}_{i}": float(np.abs(emb["fused"][j] - emb[other][j]).max())
               for other in ("unfused", "cpu") for j, i in enumerate(("eeg", "speech"))}
    log(f"fused conv blocks, 8 windows: card fused vs card unfused and vs CPU fused, "
        f"max_abs_err {emb_err} (tol {SERVE_TOL:g})")
    if not max(emb_err.values()) <= SERVE_TOL:
        raise AssertionError("the fused model's embeddings disagree")

    launches = {}
    for what, fn, x in (("eeg_chunk", sessions["fused"].embed_eeg, eeg),
                        ("speech_chunk", sessions["fused"].embed_speech, speech)):
        for f in COUNTERS:
            f.launches = 0
        fn(x)
        torch.cuda.synchronize()
        launches[what] = {f.__name__: f.launches for f in COUNTERS}
    step = card_vs_cpu_step(cfg, host_batch, fused=True)

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host_batch.items()}
    runs = {}
    for name in ("fused", "unfused"):
        model = models[name]
        opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
                             cfg.beta2, cfg.weight_decay, cfg.amsgrad_b)
        runs[name] = lambda model=model, opt=opt: train_step(model, opt, batch, cfg.seed,
                                                             False)
    for f in COUNTERS:
        f.launches = 0
    runs["fused"]()
    torch.cuda.synchronize()
    launches["train_step"] = {f.__name__: f.launches for f in COUNTERS}
    want = {
        "eeg_chunk": {"fused_transformer_block": 10, "lstm_scan_packed": 0,
                      "fused_basic_block": 10},
        "speech_chunk": {"fused_transformer_block": 0, "lstm_scan_packed": 2,
                         "fused_basic_block": 1},
        "train_step": {"fused_transformer_block": 10, "fused_block_backward": 10,
                       "lstm_scan_packed": 2, "lstm_scan_backward": 2,
                       "fused_basic_block": N_FUSED_BLOCKS,
                       "fused_conv_backward": N_FUSED_BLOCKS, "conv1d_same": N_FUSED_BLOCKS},
    }
    for what, counts in want.items():
        full = dict.fromkeys(launches[what], 0)
        full.update(counts)
        if launches[what] != full:
            raise AssertionError(f"launches on the fused path, {what}: {launches[what]}, "
                                 f"want {full}")
    log(f"kernel launches on the fused path: {launches}")

    # step time on a batch already on the card, fused and unfused in turns
    for run in runs.values():
        run()
    times = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused") * 5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    log(f"train step at batch 128 on a batch on the card, host clock, median of 10: fused "
        f"{step_ms['fused']:.3f} ms, unfused {step_ms['unfused']:.3f} ms")
    profile = profile_calls(runs["fused"], reps=3)
    result = {"launches": launches, "embedding_err": emb_err, "card_vs_cpu_step": step,
              "step_ms_median": step_ms, "step_ms_all": times,
              "profile_3_fused_steps": profile}
    log(json.dumps({"fused_path": result}))
    return result


def main() -> int:
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    x, params = block_case(gen)
    block = check_block(x, params)
    block_bwd = check_block_backward(x, params, gen)
    del x, params
    lstm = check_lstm(gen)
    lstm_bwd = check_lstm_backward(gen)
    convs = check_conv(gen)
    torch.cuda.empty_cache()
    serve = serve_path()
    log(json.dumps({"serve": serve}))
    train, cfg, host_batch = train_path()
    fused = fused_path(cfg, host_batch)
    kernels = [block, block_bwd, lstm, lstm_bwd]
    for k in kernels:
        k["launches"] = train["launches"][k["name"]]
        k["launches_by_path"] = {"serve": serve["launches"][k["name"]],
                                 "train": train["launches"][k["name"]]}
    # #5-#7 run on the fused path; the default paths launch none of them
    for k in convs:
        k["launches"] = fused["launches"]["train_step"][k["name"]]
        k["launches_by_path"] = {
            "serve": serve["launches"][k["name"]], "train": train["launches"][k["name"]],
            **{f"fused_{what}": counts[k["name"]]
               for what, counts in fused["launches"].items()}}
    kernels += convs
    log(f"chip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
