"""The numbers that decide ``correct``, each against its limit.

Training: the set-up drives the step from the seed through its first three
steps, and the reference follows the same three from the same weights,
state and batches.  Compared:

* ``loss_gap``: the widest gap of any loss the step returns, over the
  three steps, as a share of ``max(|reference|, 1)``;
* ``grad_gap``: per leaf, the gap between the norms of the program's first
  gradient (as its optimizer holds it after one step: ``mu / (1 - b1)``) and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf;
* ``change_gap``: the same of each leaf's change over the three steps, the
  memory bank and running statistics included, leaving out the parameters
  whose reference gradient is under a thousandth of the median leaf's
  (Adam moves those by round-off alone).

Serving: ``embed_gap``, the widest absolute gap of any element of any
answered request's L2-normalised embeddings from the reference's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             names: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap of norms, over ``max(reference leaf norm, median
    reference leaf norm)``; the median is over every leaf of ``reference``."""
    ref_norms = {k: float(v.double().norm()) for k, v in reference.items()}
    median = statistics.median(ref_norms.values())
    worst = 0.0
    for k in (names if names is not None else reference):
        got = float(program[k].double().norm())
        if not math.isfinite(got):
            return math.inf
        worst = max(worst, abs(got - ref_norms[k]) / max(ref_norms[k], median, 1e-30))
    return worst


def loss_gap(program: list, reference: list) -> float:
    worst = 0.0
    for got, want in zip(program, reference, strict=True):
        for k, w in want.items():
            g = got[k]
            if not math.isfinite(g):
                return math.inf
            worst = max(worst, abs(g - w) / max(abs(w), 1.0))
    return worst


def moved(reference_grads: Dict[str, torch.Tensor]) -> list:
    """The parameters whose reference gradient is not negligible."""
    norms = {k: float(v.double().norm()) for k, v in reference_grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= NEGLIGIBLE_GRAD * median]


def training_numbers(prog_losses: list, ref_losses: list, prog_grad: dict, ref_grad: dict,
                     prog_change: dict, ref_change: dict) -> Dict[str, float]:
    kept = moved(ref_grad) + [k for k in ref_change if k not in ref_grad]
    return {
        "loss_gap": loss_gap(prog_losses, ref_losses),
        "grad_gap": leaf_gap(prog_grad, ref_grad),
        "change_gap": leaf_gap(prog_change, ref_change, kept),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
