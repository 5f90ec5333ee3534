"""Times the wide LSTM kernels (#3's forward, #4's recurrence) at each of
several units-a-CTA counts U, at batch 128, T=192, on one CUDA card.

For each (H, D) the candidates are the four fewest U (multiples of 4
dividing H) that put all D directions' CTAs on the SMs at once, and the U
that :func:`lstm_launch_plan` picks for each kernel (``chosen``: forward,
backward).  Each U is held against the plain
twin on the same inputs (forward ``h``: max abs error; ``dxw``: max abs
error over max(1, max|twin|)) and timed by CUDA events, the median of 20
calls.  Prints the card's name and power limit, then one JSON line per
(H, D, U).  Run: ``python -m transformer_clip_eeg_tpu_torch.tools.lstm_wide_units``
(``--shapes 512x1,1024x1`` to choose the (H, D) pairs).
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


def candidates(d: int, hidden: int, sms: int) -> list:
    fit = [u for u in range(4, hidden + 1, 4) if hidden % u == 0 and d * (hidden // u) <= sms]
    plan = port.lstm_launch_plan(128, d, hidden, sms=sms)
    return sorted(set(fit[:4]) | {plan.units_fwd, plan.units_bwd})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES, help="HxD pairs, comma-separated")
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
        picked = chosen(b, d, hidden, sms=sms)
        for units in candidates(d, hidden, sms):
            plan = port._wide_plan(b, d, hidden, sms, units)
            port.lstm_launch_plan = lambda *a, **k: plan
            try:
                h, c, gates = port._launch_forward(xw, whh, True, True)
                dxw = port._backward_recurrence(whh, c, gates, g)
                torch.cuda.synchronize()
                row = dict(
                    H=hidden, D=d, U=units,
                    chosen=[units == picked.units_fwd, units == picked.units_bwd],
                    ctas=plan.ctas_fwd, resident=[plan.resident_fwd, plan.resident_bwd],
                    h_err=float((h - h_ref).abs().max()),
                    dxw_err=float((dxw - dxw_ref).abs().max())
                    / max(1.0, float(dxw_ref.abs().max())),
                    fwd_ms=time_ms(lambda: port._launch_forward(xw, whh, False, False)),
                    bwd_rec_ms=time_ms(lambda: port._backward_recurrence(whh, c, gates, g)))
            finally:
                port.lstm_launch_plan = chosen
            print(json.dumps(row), flush=True)
            del h, c, gates, dxw
        del xw, whh, g, a, dxw_ref, h_ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
