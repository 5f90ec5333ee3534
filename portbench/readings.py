"""The readings that a cell's limits are set from (not run by the benchmark's
own runs):

* ``program``: the numbers of sound runs of the program, one per seed, in
  one process (a training cell's checked steps need no window: ``--seconds
  0``; a serving cell's take a window at the cell's own load);
* ``control``: the reference put in the program's place and computed in
  the nearest precision below the configuration's (float32 → TF32), against
  the reference in float32, on the same inputs;
* ``fault``: the program with a fault planted in its timed path (training:
  half of each batch left out, its losses the mean over the rest; serving:
  one element of the first answer of each dispatch altered).  A step that leaves
  its state unchanged reads 1 by the numbers' definition and needs no run.

    python3 -m portbench.readings --workload <cell> --kind program --seeds 1 2 3
        [--seconds S] [--out readings.jsonl]

Each reading is a JSON line ``{"workload", "kind", "seed", "numbers"}`` on
standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from typing import Iterator

from portbench import checks, harness, spec


def program(cell: str, seed: int, seconds: float, device, overrides=None) -> dict:
    ctx = harness.make_context(cell, seed, seconds, False, device, overrides=overrides)
    generator = spec.load_module("generators", ctx.traffic["generator"])
    return generator.run(ctx)["numbers"]


def control(cell: str, seed: int, device, overrides=None) -> dict:
    ctx = harness.make_context(cell, seed, 0.0, False, device, overrides=overrides)
    generator = spec.load_module("generators", ctx.traffic["generator"])
    if ctx.traffic["generator"] == "train_chunks":
        cfg, params0, state0, batches = generator.reference_inputs(ctx)
        want = generator.reference_run(ctx, cfg, params0, state0, batches, tf32=False)
        got = generator.reference_run(ctx, cfg, params0, state0, batches, tf32=True)
        return checks.training_numbers(got[0], want[0], got[1], want[1], got[2], want[2])
    params, state, pool = generator.reference_inputs(ctx)
    ref = spec.load_module("reference", ctx.config_name)
    chunk = ctx.traffic["session_chunk"]
    got = generator.reference_embeddings(ref, params, state, pool, ctx.device, chunk, tf32=True)
    done = [(0, len(pool), 0.0, 0.0, got)]
    return {"embed_gap": generator.embed_gap(ref, params, state, pool, done, ctx.device, chunk,
                                          tf32=False)}


@contextlib.contextmanager
def planted(generator_name: str) -> Iterator[None]:
    """The program's timed path with a fault in it, for the duration."""
    if generator_name == "train_chunks":
        from transformer_clip_eeg_tpu_torch.train import steps as module

        name, original = "chunk_train_step", module.chunk_train_step

        def broken(model, opt, eeg, speech, ids, idx, subs, *args, **kwargs):
            half = idx.shape[0] // 2
            return original(model, opt, eeg, speech, ids, idx[:half], subs[:half], *args,
                            **kwargs)
    else:
        from transformer_clip_eeg_tpu_torch import serve as module

        name, original = "InferenceSession", module.InferenceSession

        class broken(original):  # noqa: N801 -- stands in for the class
            def embed_eeg(self, windows, *args, **kwargs):
                out = super().embed_eeg(windows, *args, **kwargs)
                out[0, 0] += 1e-2
                return out

    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, original)


def fault(cell: str, seed: int, seconds: float, device, overrides=None) -> dict:
    ctx = harness.make_context(cell, seed, seconds, False, device, overrides=overrides)
    with planted(ctx.traffic["generator"]):
        return program(cell, seed, seconds, device, overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.readings", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", choices=("program", "control", "fault"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        if args.kind == "control":
            numbers = control(args.workload, seed, args.device)
        elif args.kind == "fault":
            numbers = fault(args.workload, seed, args.seconds, args.device)
        else:
            numbers = program(args.workload, seed, args.seconds, args.device)
        line = json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed,
                           "numbers": {k: str(v) if not math.isfinite(v) else v
                                       for k, v in numbers.items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
