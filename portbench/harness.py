"""One run of one cell: the context a generator gets, the program's model built
as the configuration states it, and the result line.

A generator (``generators/<name>.py``) exposes ``run(ctx) -> dict`` with the keys
``e2e`` (end-to-end values by metric name), ``window_start`` (host clock),
``attempted``, ``failed``, ``numbers`` (what decides ``correct``),
``memory_peak_bytes`` and ``layer`` (what the per-layer readers read).
"""

from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from portbench import checks, spec, weights
from portbench.trace import KernelWatch, Spans

# top-level module names that may not be loaded by the time the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformer_clip_eeg_tpu")


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (Linux: from
    ``/proc/self/stat``; elsewhere the moment this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Context:
    cell: dict
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    started: float
    spans: Optional[Spans] = None
    kernels: Optional[KernelWatch] = None

    @property
    def precision(self) -> str:
        return self.config["precision"]


def train_config(config: dict):
    """The program's ``TrainConfig``: the reference's defaults with the
    configuration's flags."""
    from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

    return TrainConfig(**config["flags"])


def build_model(cfg, bank_size: int, seed: int, device) -> torch.nn.Module:
    """The program's model as its trainer assembles it, on ``device``, with
    the benchmark's weights from ``seed``."""
    from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config

    model = build_model_from_config(cfg, bank_size, device)
    weights.make_weights(model, seed, device)
    return model


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Hand the freed program state's memory back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def set_precision(precision: str) -> None:
    """cuBLAS and cuDNN as ``precision`` states: float32 computes in float32,
    TF32 off (PyTorch's default leaves cuDNN's convolutions in TF32)."""
    if precision != "float32":
        raise ValueError(f"no precision {precision!r}; the configurations state float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_context(cell_name: str, seed: int, seconds: float, traced: bool, device,
                 bench: Optional[dict] = None, overrides: Optional[dict] = None) -> Context:
    """A run's context: the cell and its configuration, mix and limits,
    found by name, with the precision the configuration states;
    ``overrides`` replaces the loaded ``config``, ``traffic`` or ``limits``
    (the tests run the harness at a size the CPU holds)."""
    started = process_start()
    bench = bench if bench is not None else spec.benchmark()
    cell = spec.workload(bench, cell_name)
    parts = {"config": spec.load_json("configs", cell["config"]),
             "traffic": spec.load_json("traffic", cell["traffic"]),
             "limits": spec.load_json("limits", cell_name)}
    parts.update(overrides or {})
    set_precision(parts["config"]["precision"])
    return Context(cell=cell, config_name=cell["config"], seed=int(seed), seconds=float(seconds),
                   traced=traced, device=torch.device(device), started=started, **parts)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device,
             bench: Optional[dict] = None, overrides: Optional[dict] = None) -> dict:
    """Run one cell once; returns the result object (without printing)."""
    bench = bench if bench is not None else spec.benchmark()
    ctx = make_context(cell_name, seed, seconds, traced, device, bench, overrides)
    device, started = ctx.device, ctx.started
    if traced:
        ctx.spans = Spans()
        ctx.kernels = KernelWatch(ctx.precision)
        ctx.kernels.install()
    generator = spec.load_module("generators", ctx.traffic["generator"])
    try:
        out = generator.run(ctx)
    finally:
        if ctx.kernels is not None:
            ctx.kernels.uninstall()
    limits, cell = ctx.limits, ctx.cell
    numbers = out["numbers"]
    result = {
        "correct": checks.verdict(numbers, limits) and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {},
        "device": device_record(device, out["memory_peak_bytes"]),
    }
    wanted = spec.metrics_of(bench, cell_name, traced)
    if traced:
        trace = out["layer"].get("trace") or {}
        result["device"].update(busy_s=trace.get("busy_s", 0.0),
                                window_s=trace.get("window_s", 0.0))
        run = dict(out["layer"], cell=cell_name, config=cell["config"],
                   precision=ctx.precision, e2e=out["e2e"])
        for m in wanted:
            value = spec.load_module("metrics", m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        host = out["layer"].get("host_trace") or {}
        result["breakdown"] = {"device_ops": [list(kv) for kv in host.get("device_ops_top", [])],
                               "idle_gaps": [list(kv) for kv in host.get("idle_gaps_top", [])]}
    else:
        values = dict(out["e2e"], setup_s=out["window_start"] - started)
        for m in wanted:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["checks"] = checks.report(numbers, limits)
    return result


def device_record(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
