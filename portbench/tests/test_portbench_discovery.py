"""The harness finds a configuration's, a mix's and a metric's files by the
names ``BENCHMARK.json`` gives: a copy of the benchmark with one more
per-layer metric (a file of its own) and one more cell (an entry and a limits
file) runs them with no other file edited."""

import json
import shutil
import subprocess
import sys

from conftest import REPO

PROBE = r"""
import json, sys
sys.path.append({repo!r})  # the program; the benchmark comes from the copy
import torch
torch.set_num_threads(2)
from conftest import tiny
from portbench import harness, spec
bench = spec.benchmark()
assert str(spec.ROOT).startswith({copy!r}), spec.ROOT
out = harness.run_cell("flagship.extra", 11, 1.0, True, "cpu", overrides=tiny("flagship.extra"))
print(json.dumps(sorted(out["metrics"])))
"""


def test_a_new_metric_and_cell_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(REPO + "/portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(open(REPO + "/BENCHMARK.json").read())
    bench["workloads"].append({"name": "flagship.extra", "config": "flagship",
                               "traffic": "train", "chips": 1, "why": "a cell added by data"})
    for m in bench["end_to_end"]:
        if m["name"] in ("train_pairs_per_s",):
            m["workloads"].append("flagship.extra")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step, host",
                               "moves": "train_pairs_per_s", "workloads": ["flagship.extra"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    (copy / "portbench" / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run['steps'] + run['profiled_steps'])\n")
    shutil.copy(copy / "portbench" / "limits" / "flagship.train.json",
                copy / "portbench" / "limits" / "flagship.extra.json")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO, copy=str(copy))],
        cwd=copy, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": f"{copy}:{copy}/portbench/tests", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "steps_seen.train" in names
    assert "dispatch_ms.train" not in names  # the metric lists only its own cells
