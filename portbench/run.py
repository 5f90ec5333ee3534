"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs on the CUDA cards of the machine it
starts on and on nothing else: with no card, or fewer than the cell asks
for, it prints no result and exits 2.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last ``checks``, each
number that decided ``correct`` beside its limit, which also end standard
error).  If ``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX package is
loaded once the window has closed, it prints no result and exits 3.  The
program builds its kernels into ``build/kernels`` inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness, spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}; "
              "it does not run elsewhere", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", bench=bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: these modules were loaded during the run: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(plain(result), allow_nan=False), flush=True)
    return 0


def plain(value):
    """``value`` with every non-finite float written as a string."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


if __name__ == "__main__":
    sys.exit(main())
