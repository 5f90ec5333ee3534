"""``BENCHMARK.json`` keeps to its contract: names, units, keys, files and
the per-layer metrics' links; so do the entries of the cells set aside
(``set_aside.json``) beside it, ready to be put back."""

import json
import re

import pytest

from conftest import with_set_aside
from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()
ALL = with_set_aside(BENCH)


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(line_ok(w) for w in BENCH["command"])
    assert len(spec.BENCHMARK.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", ALL["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line_ok(entry["source"]) and line_ok(entry["why"])
    assert entry["file"].startswith("portbench/configs/")
    with open(spec.ROOT.parent / entry["file"]) as f:
        config = json.load(f)
    assert config["reduced"] == entry["reduced"]
    for part in ("configs", "reference"):
        assert (spec.ROOT / part / (entry["name"] + ("_flops.py" if part == "configs" else ".py"))
                ).is_file()


@pytest.mark.parametrize("entry", ALL["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and line_ok(entry["why"])
    assert entry["config"] in {c["name"] for c in ALL["configs"]}
    assert (spec.ROOT / "traffic" / f"{entry['traffic']}.json").is_file()
    assert (spec.ROOT / "limits" / f"{entry['name']}.json").is_file()
    reported = spec.metrics_of(ALL, entry["name"], False)
    assert "setup_s" in {m["name"] for m in reported}
    if entry in BENCH["workloads"]:
        assert len(reported) >= 2 and spec.metrics_of(BENCH, entry["name"], True)


@pytest.mark.parametrize("entry", ALL["end_to_end"] + ALL["per_layer"],
                         ids=lambda e: e["name"])
def test_metrics(entry):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if entry in ALL["end_to_end"]:
        allowed |= {"bound"}
        assert 0 < entry["bound"] <= 0.25 and entry["source"] in ("host_clock", "device_trace")
    else:
        allowed |= {"layer", "moves"}
        assert line_ok(entry["layer"])
        moved = next(m for m in ALL["end_to_end"] if m["name"] == entry["moves"])
        assert set(entry["workloads"]) <= set(moved.get("workloads", entry["workloads"]))
        assert (spec.ROOT / "metrics" / f"{entry['name']}.py").is_file()
    assert set(entry) <= allowed
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher") and entry["source"] in SOURCES
    cells = {w["name"] for w in ALL["workloads"]}
    assert set(entry.get("workloads", [])) <= cells


def test_names_are_unique():
    for group in (ALL["configs"], ALL["workloads"], ALL["end_to_end"] + ALL["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
