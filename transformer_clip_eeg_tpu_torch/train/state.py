"""The optimizer, with optax's semantics, and parameter counting.

Counterpart of ``transformer_clip_eeg_tpu/train/state.py``: ``make_optimizer``
builds Adam or AdamW (optionally AMSGrad) as the JAX package's optax chain
does, ``scale_by_adam`` (or ``scale_by_amsgrad``) → ``add_decayed_weights(wd)``
over every parameter (AdamW only) → ``scale_by_learning_rate``::

    mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2;   n += 1
    mu^ = mu / (1 - b1^n);     nu^ = nu / (1 - b2^n)   [AMSGrad: nu^ = max(nu^max, nu^)]
    u = mu^ / (sqrt(nu^) + eps) + wd p;                p = p - lr u

written by hand because torch's ``AdamW`` decays the weights before the
Adam step and its ``amsgrad`` keeps the max of the raw second moment, where
optax keeps the max of the bias-corrected one.  As ``optax.flatten`` does in
the JAX package, the moments live in one flat vector, so an update is a few
large element-wise operations whatever the number of parameters.  The step
count ``n`` is the train state's step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch
from torch import nn


class Optimizer:
    """Adam / AdamW / AMSGrad over ``params`` with optax's update rule."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.0,
                 amsgrad: bool = False, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr = float(learning_rate)
        self.b1, self.b2, self.eps = float(beta1), float(beta2), float(eps)
        self.weight_decay = float(weight_decay)
        self.amsgrad = amsgrad
        n = sum(p.numel() for p in self.params)
        ref = self.params[0]
        self.step = 0
        self.mu = torch.zeros(n, dtype=ref.dtype, device=ref.device)
        self.nu = torch.zeros_like(self.mu)
        self.nu_max = torch.zeros_like(self.mu) if amsgrad else None

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        g = torch.cat([gi.reshape(-1) for gi in grads])
        self.step += 1
        self.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        self.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mu_hat = self.mu / (1.0 - self.b1 ** self.step)
        nu_hat = self.nu / (1.0 - self.b2 ** self.step)
        if self.nu_max is not None:
            torch.maximum(self.nu_max, nu_hat, out=self.nu_max)
            nu_hat = self.nu_max
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        flat_p = torch.cat([p.reshape(-1) for p in self.params])
        if self.weight_decay:
            u.add_(flat_p, alpha=self.weight_decay)
        u.mul_(-self.lr)
        views = u.split([p.numel() for p in self.params])
        torch._foreach_add_(self.params, [v.view_as(p) for v, p in zip(views, self.params)])

    def state_dict(self) -> Dict[str, Any]:
        out = {"step": self.step, "lr": self.lr, "mu": self.mu, "nu": self.nu}
        if self.nu_max is not None:
            out["nu_max"] = self.nu_max
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step, self.lr = int(state["step"]), float(state["lr"])
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
        if self.nu_max is not None:
            self.nu_max.copy_(state["nu_max"])


def make_optimizer(params: Iterable[torch.Tensor], optimizer: str, learning_rate: float,
                   beta1: float = 0.9, beta2: float = 0.999, weight_decay: float = 0.01,
                   amsgrad: bool = False) -> Optimizer:
    """Adam or AdamW (the reference's dispatch), with the AMSGrad option."""
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return Optimizer(params, learning_rate, beta1, beta2,
                     weight_decay if optimizer == "adamw" else 0.0, amsgrad)


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    opt.lr = float(lr)
    return opt


def get_learning_rate(opt: Optimizer) -> float:
    return opt.lr


def count_params(model: nn.Module) -> int:
    """Number of parameters (the memory bank is a buffer and not counted)."""
    return sum(p.numel() for p in model.parameters())
