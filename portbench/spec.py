"""Where the benchmark finds each part, by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration as it is run (the program's
  flags), with ``configs/<config>_flops.py`` (its model operations) and
  ``reference/<config>.py`` (its plain reference);
* ``traffic/<mix>.json``: a traffic mix's parameters, read by the generator
  its ``generator`` key names, ``generators/<generator>.py``;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``;
* ``limits/<cell>.json``: the limits of the numbers that decide a cell's
  ``correct``.

Adding a configuration, a mix, a metric or a cell is adding such files and
entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def benchmark() -> dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    qualified = f"portbench.{kind}.{name}"
    if qualified in sys.modules:
        return sys.modules[qualified]
    spec = importlib.util.spec_from_file_location(qualified, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = module
    spec.loader.exec_module(module)
    return module


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``traced`` its per-layer ones.  A metric without ``workloads`` belongs to
    every cell that reports the end-to-end metric it moves."""
    ends = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return ends
    reported = {m["name"] for m in ends}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]
