"""Times the wide LSTM kernels (#3's forward, #4's recurrence) at each of
several plans (units a CTA x batch groups), at batch 128, T=192, on one CUDA
card.

For each (H, D) and each kernel the candidates are the ``--top`` cheapest
plans by the cost model of ``ops.lstm_scan.wide_candidates``, the first of
them the one ``lstm_launch_plan`` picks (``chosen``).  Each plan is
held against the plain twin on the same inputs (forward ``h``: max abs
error; ``dxw``: max abs error over max(1, max|twin|)) and timed by CUDA
events, the median of 20 calls; the backward's candidates run on the
forward's outputs under the chosen plan.  Prints the card's name and power
limit, then one JSON line per (H, D, kernel, plan).  Run: ``python -m
transformer_clip_eeg_tpu_torch.tools.lstm_wide_units`` (``--shapes
512x1,1024x1`` to choose the (H, D) pairs).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from transformer_clip_eeg_tpu_torch import _build
from transformer_clip_eeg_tpu_torch.ops import lstm_scan as port

SHAPES = "512x1,512x2,320x2,1024x1,1024x2"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES, help="HxD pairs, comma-separated")
    ap.add_argument("--top", type=int, default=6, help="plans a kernel and shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t, b = 192, 128
    chosen = port.lstm_launch_plan
    for pair in args.shapes.split(","):
        hidden, d = (int(v) for v in pair.split("x"))
        gen = torch.Generator().manual_seed(hidden + d)
        xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).cuda()
        whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1)
               * hidden ** -0.5).cuda()
        g = torch.randn(t, d, b, hidden, generator=gen).cuda()
        a = xw.clone().requires_grad_()
        h_ref = port.lstm_scan_reference(a, whh)
        dxw_ref, = torch.autograd.grad(h_ref, a, g)
        h_ref = h_ref.detach()
        _, c, gates = port._launch_forward(xw, whh, True, True)
        picked = chosen(b, d, hidden, sms=sms)
        for kind in ("fwd", "bwd"):
            # the cost model's cheapest first: the one the plan takes
            for cand in port.wide_candidates(b, d, hidden, sms, kind)[:args.top]:
                forced = {kind: (cand.units, cand.groups)}
                plan = port._wide_plan(b, d, hidden, sms, **forced)
                port.lstm_launch_plan = lambda *a, **k: plan
                try:
                    if kind == "fwd":
                        h, _, _ = port._launch_forward(xw, whh, False, False)
                        torch.cuda.synchronize()
                        err = float((h - h_ref).abs().max())
                        ms = time_ms(lambda: port._launch_forward(xw, whh, False, False))
                    else:
                        dxw = port._backward_recurrence(whh, c, gates, g)
                        torch.cuda.synchronize()
                        err = (float((dxw - dxw_ref).abs().max())
                               / max(1.0, float(dxw_ref.abs().max())))
                        ms = time_ms(lambda: port._backward_recurrence(whh, c, gates, g))
                finally:
                    port.lstm_launch_plan = chosen
                mine = (getattr(picked, f"units_{kind}"), getattr(picked, f"groups_{kind}"))
                print(json.dumps(dict(
                    H=hidden, D=d, kernel=kind, U=cand.units, groups=cand.groups,
                    chosen=(cand.units, cand.groups) == mine, ctas=cand.ctas,
                    launches=cand.launches, resident=cand.resident,
                    model_us_per_step=round(cand.step_us, 3), err=err, ms=ms,
                    us_per_step=ms / t * 1e3)), flush=True)
        del xw, whh, g, a, dxw_ref, h_ref, c, gates
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
