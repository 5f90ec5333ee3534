"""A run of the harness on the CPU at a tiny size: the result line's keys,
the refusal without a card, and the imports it may not make."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, tiny
from portbench import harness, run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "transformer_clip_eeg_tpu"}
PORT = "transformer_clip_eeg_tpu_torch"


def result(cell, traced):
    out = harness.run_cell(cell, 2**31 + 7, 1.0, traced, "cpu", overrides=tiny(cell))
    return json.loads(json.dumps(run.plain(out), allow_nan=False))


@pytest.mark.parametrize("cell", ["flagship.train", "flagship.serve_eeg"])
def test_result_keys(cell):
    line = result(cell, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    wanted = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell, False)}
    assert set(line["metrics"]) == wanted
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_result_keys():
    line = result("flagship.train", True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.metrics_of(spec.benchmark(), "flagship.train", True)}
    assert set(line["metrics"]) <= per_layer
    assert "dispatch_ms.train" in line["metrics"]


def test_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "flagship.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def imports_of(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in sorted(spec.ROOT.rglob("*.py")):
        tops = {n.split(".")[0] for n in imports_of(path)}
        assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((spec.ROOT / "reference").rglob("*.py")):
        tops = {n.split(".")[0] for n in imports_of(path)}
        assert PORT not in tops, f"{path} imports the program"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in (PORT + ".ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    monkeypatch.setitem(sys.modules, "transformer_clip_eeg_tpu", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["flax", "transformer_clip_eeg_tpu"]
