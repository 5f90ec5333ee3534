"""The offered rates of a serving cell's mix, swept once to find the rate the
system sustains (not run by the benchmark's own runs): for each rate a
window of ``--seconds`` at that rate, in one process, and one JSON line of
what it read (requests, windows offered and answered by the close, the
latency's p50, p95 and max, how long after the close the last answer came,
the dispatches).

    python3 -m portbench.sweep --workload <cell> --rates 300 600 900 --seconds 12
        [--seed S] [--out sweep.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.sweep", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=2**31 + 1000)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.workload(spec.benchmark(), args.workload)
    for k, rate in enumerate(args.rates):
        traffic = dict(spec.load_json("traffic", cell["traffic"]), requests_per_s=rate)
        ctx = harness.make_context(args.workload, args.seed + k, args.seconds, False,
                                   args.device, overrides={"traffic": traffic})
        out = spec.load_module("generators", traffic["generator"]).run(ctx)
        line = json.dumps({"workload": args.workload, "requests_per_s": rate,
                           "numbers": out["numbers"], **out["stats"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
