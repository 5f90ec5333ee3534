"""Times the H=256 LSTM kernels (#3's forward, #4's recurrence) at each batch
tile they are built for, at batch 128, T=192, on one CUDA card.

For each D (1 and 2) and each tile of ``ops.lstm_scan.MID_TILES`` (16, 24
and 32 rows: 2, 3 or 4 n8 blocks of mma.sync) the plan is ``mid_plan(128, D,
tile)``, its clusters beside those the card holds at once
(``cudaOccupancyMaxActiveClusters``, ``mid_coresident``) and the waves the
plan claims for them; ``chosen`` marks the tile ``lstm_launch_plan`` takes.
Each plan is held against the plain twin on the same inputs (forward ``h``:
max abs error; ``dxw``: max abs error over max(1, max|twin|)) and timed by
CUDA events, the median of 20 calls; the backward's candidates run on the
forward's outputs under the chosen plan.  Prints the card's name and power
limit, then one JSON line per (D, kernel, tile).  Run: ``python -m
transformer_clip_eeg_tpu_torch.tools.lstm_mid_tiles``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from transformer_clip_eeg_tpu_torch import _build
from transformer_clip_eeg_tpu_torch.ops import lstm_scan as port
from transformer_clip_eeg_tpu_torch.tools.lstm_wide_units import time_ms

HIDDEN, T, B = 256, 192, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--directions", default="1,2", help="D values, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    chosen = port.lstm_launch_plan
    for d in (int(v) for v in args.directions.split(",")):
        gen = torch.Generator().manual_seed(HIDDEN + d)
        xw = (0.5 * torch.randn(T, d, B, 4 * HIDDEN, generator=gen)).cuda()
        whh = ((torch.rand(d, HIDDEN, 4 * HIDDEN, generator=gen) * 2 - 1)
               * HIDDEN ** -0.5).cuda()
        g = torch.randn(T, d, B, HIDDEN, generator=gen).cuda()
        a = xw.clone().requires_grad_()
        h_ref = port.lstm_scan_reference(a, whh)
        dxw_ref, = torch.autograd.grad(h_ref, a, g)
        h_ref = h_ref.detach()
        _, c, gates = port._launch_forward(xw, whh, True, True)
        picked = chosen(B, d, HIDDEN)
        for kind in ("fwd", "bwd"):
            for tile in port.MID_TILES:
                plan = port.mid_plan(B, d, tile)
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
                print(json.dumps(dict(
                    H=HIDDEN, D=d, kernel=kind, tile=tile, chosen=plan == picked, clusters=plan.ctas // plan.cluster, waves=plan.waves,
                    coresident=port.mid_coresident(kind, plan), err=err, ms=ms,
                    us_per_step=ms / T * 1e3)), flush=True)
        del xw, whh, g, a, dxw_ref, h_ref, c, gates
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
