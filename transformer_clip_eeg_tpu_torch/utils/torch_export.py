"""Export a port model as a reference-layout torch ``state_dict``.

Counterpart of ``transformer_clip_eeg_tpu/utils/torch_export.py``, the
inverse of :mod:`transformer_clip_eeg_tpu_torch.utils.torch_import`: a model
trained by the port loads into the reference driver, which reads a bare
``state_dict`` written by ``torch.save`` (ref ``train_clip_final.py:
443-449,541-556``).

The caller supplies the target key and shape layout (a reference
``model.ckpt`` or ``reference_model.state_dict()``); each key is resolved to
its flax leaf with the import's key grammar (``_rewrite_comps`` /
``_resolve_path``), from the port model's flax tree
(``utils/convert.variables_from_state_dict``), and only each leaf's layout
is inverted:

* ``kernel [I, O]``           → ``weight [O, I]``          (nn.Linear)
* ``kernel [K, I, O]``        → ``weight [O, I, K]``       (nn.Conv1d)
* ``kernel [kT, 1, F]``       → ``weight [F, 1, kT, 1]``   (valid-time Conv2d)
* ``scale``/``bias [T, C]``   → 2-D LayerNorm([C, T]) weight/bias
* ``kernel_ih [I, 4H]``       → ``weight_ih_l0 [4H, I]``   (nn.LSTM, ±reverse)
* params + batch_stats        → BatchNorm weight/bias/running_mean/running_var
* the bank                    → the reference's ``memoryBank.memory`` buffer

Template leaves with no counterpart (BatchNorm's ``num_batches_tracked``)
keep their template values and are listed in the report.

:func:`reference_layout` is a stand-in template for tests and checks where
no reference checkpoint is at hand: the reference-named keys and shapes that
the grammar resolves to each leaf of a port model.  It is held to the JAX
package's grammar, not to the reference's code, which the repo does not
hold; where the reference wraps a layer in ``Sequential(layer, activation)``
(a key digit the grammar skips) it names the layer bare.  The CLI still
requires ``--template``, as JAX's does.  Imports nothing of JAX; moves bytes
on the CPU and runs no model.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.utils.convert import _numpy, variables_from_state_dict
from transformer_clip_eeg_tpu_torch.utils.torch_import import (
    _LSTM_LEAVES,
    _resolve_node,
    _resolve_path,
    _rewrite_comps,
)


def _tree_get(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _emit_torch_group(out, prefix, leaves, node, path, batch_stats, report) -> None:
    """Fill ``out`` with one torch module's leaves from the flax subtree
    ``node`` at ``path``; ``leaves`` maps leaf name → the template array."""
    key = lambda name: ".".join(prefix + (name,))  # noqa: E731

    def keep(name):
        out[key(name)] = np.asarray(leaves[name])
        report.append(key(name))

    if "weight_ih_l0" in leaves:  # nn.LSTM
        for tk, fk in _LSTM_LEAVES:
            if tk in leaves:
                v = np.asarray(node[fk])
                out[key(tk)] = v.T if v.ndim == 2 else v
        return
    if "running_mean" in leaves:  # nn.BatchNorm1d
        stats = _tree_get(batch_stats, path)
        out[key("weight")] = np.asarray(node["scale"])
        out[key("bias")] = np.asarray(node["bias"])
        out[key("running_mean")] = np.asarray(stats["mean"])
        out[key("running_var")] = np.asarray(stats["var"])
        if "num_batches_tracked" in leaves:
            # no counterpart; torch reads it only for BatchNorm(momentum=None),
            # which the reference never builds
            keep("num_batches_tracked")
        return
    w_t = leaves.get("weight")
    if w_t is None:
        for name in leaves:
            keep(name)
        return
    if not isinstance(node, dict):  # a bare table: no transpose
        out[key("weight")] = np.asarray(node)
        return
    b_t = leaves.get("bias")
    ndim = len(np.shape(w_t))
    if ndim == 4:  # valid-time Conv2d: kernel [kT, 1, F] → [F, 1, kT, 1]
        k = np.asarray(node["kernel"])
        out[key("weight")] = k[:, 0, :].T[:, None, :, None]
    elif ndim == 3:  # Conv1d: kernel [K, I, O] → [O, I, K]
        out[key("weight")] = np.asarray(node["kernel"]).transpose(2, 1, 0)
    elif ndim == 2 and b_t is not None and len(np.shape(b_t)) == 2:
        # 2-D LayerNorm([C, T]): scale/bias [T, C] → [C, T]
        out[key("weight")] = np.asarray(node["scale"]).T
        out[key("bias")] = np.asarray(node["bias"]).T
        return
    elif ndim == 2:  # nn.Linear: kernel [I, O] → [O, I]
        out[key("weight")] = np.asarray(node["kernel"]).T
    else:  # 1-D LayerNorm
        out[key("weight")] = np.asarray(node["scale"])
        if b_t is not None:
            out[key("bias")] = np.asarray(node["bias"])
        return
    if b_t is not None:
        out[key("bias")] = np.asarray(node["bias"])


def export_state_dict(model_or_state_dict, template_state_dict: Dict[str, Any]
                      ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """A port model (or its ``state_dict``) → the reference layout of
    ``template_state_dict``, as numpy arrays.

    Returns ``(state_dict, report)``; ``report`` lists the keys that kept
    their template values because the port model has no counterpart."""
    variables = variables_from_state_dict(model_or_state_dict)
    params_t = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    membank = variables.get("membank", {})
    out: Dict[str, np.ndarray] = {}
    report: List[str] = []

    groups: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for k, t in template_state_dict.items():
        arr = _numpy(t)
        comps = k.split(".")
        groups.setdefault(tuple(comps[:-1]), {})[comps[-1]] = arr

    for prefix, leaves in groups.items():
        if not prefix:  # root scalars: temperature, temperature_eeg
            for name, v in leaves.items():
                if name in params_t:
                    out[name] = np.asarray(params_t[name])
                else:
                    out[name] = np.asarray(v)
                    report.append(name)
            continue
        if "memory" in leaves:  # the reference's memoryBank buffer
            name = ".".join(prefix + ("memory",))
            mem = _tree_get(membank, prefix + ("memory",))
            if mem is not None:
                out[name] = np.asarray(mem)
            else:
                out[name] = np.asarray(leaves["memory"])
                report.append(name)
            continue
        comps = _rewrite_comps(list(prefix))
        node = _resolve_node(params_t, comps)
        path = _resolve_path(params_t, comps)
        if node is None or path is None:
            for name, v in leaves.items():
                out[".".join(prefix + (name,))] = np.asarray(v)
                report.append(".".join(prefix + (name,)))
            continue
        _emit_torch_group(out, prefix, leaves, node, path, batch_stats, report)
    return out, report


def save_torch_checkpoint(model_or_state_dict, template_state_dict: Dict[str, Any],
                          path: str | os.PathLike) -> List[str]:
    """Write a reference-loadable ``model.ckpt`` (each tensor in its template
    key's dtype); returns the kept-template-value report."""
    sd_np, report = export_state_dict(model_or_state_dict, template_state_dict)
    sd = {}
    for k, v in sd_np.items():
        t = template_state_dict.get(k)
        dtype = t.dtype if isinstance(t, torch.Tensor) else None
        sd[k] = torch.as_tensor(np.array(v, copy=True), dtype=dtype)
    torch.save(sd, os.fspath(path))
    return report


# the port's module paths the reference names otherwise (the inverse of the
# grammar's remaps): VLAAI's stack, and the transformer blocks' branches
_VLAAI_STACK = {"extractor": "0", "linear_recombination": "1", "output_context": "2"}
_BLOCK_BRANCH = {"ln1": ["0", "fn", "0"], "attn": ["0", "fn", "1"], "ln2": ["1", "fn", "0"]}
_FFN_BRANCH = {"fc1": ["1", "fn", "1", "0"], "fc2": ["1", "fn", "1", "3"]}


def _reference_prefix(comps: List[str]) -> List[str]:
    out, i = [], 0
    while i < len(comps):
        c = comps[i]
        if c.startswith("block_") and i + 1 < len(comps):
            blk, sub = c[len("block_"):], comps[i + 1]
            if sub in _BLOCK_BRANCH:
                out += [blk] + _BLOCK_BRANCH[sub]
                i += 2
                continue
            if sub == "ffn" and i + 2 < len(comps) and comps[i + 2] in _FFN_BRANCH:
                out += [blk] + _FFN_BRANCH[comps[i + 2]]
                i += 3
                continue
        if c in _VLAAI_STACK:
            out += ["sequentialConvStack", _VLAAI_STACK[c]]
            if c == "extractor" and i + 1 < len(comps):
                sub = comps[i + 1]
                for name, offset in (("conv_", 0), ("norm_", 1)):
                    if sub.startswith(name) and sub[len(name):].isdigit():
                        out += ["conv_layers", str(3 * int(sub[len(name):]) + offset)]
                        i += 1
            i += 1
            continue
        out.append(c)
        i += 1
    return out


def reference_layout(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The reference-named keys, shapes and dtypes the key grammar resolves
    to each leaf of ``model`` (values are the model's, in the reference's
    layouts): a stand-in template for :func:`export_state_dict` where no
    reference checkpoint is at hand.  Batch norms gain ``num_batches_tracked``
    (int64 0), as a reference ``state_dict`` holds it."""
    from transformer_clip_eeg_tpu_torch.ops.layers import Conv2dValidTime, LayerNormTC

    kinds = {name: type(m) for name, m in model.named_modules()}
    out: Dict[str, torch.Tensor] = {}
    for key, t in model.state_dict().items():
        *prefix, leaf = key.split(".")
        t = t.detach().cpu().clone()
        if not prefix:  # root leaves; the KLD table is an nn.Embedding
            out[f"{leaf}.weight" if t.ndim == 2 else leaf] = t
            continue
        kind = kinds.get(".".join(prefix))
        if kind is Conv2dValidTime and leaf == "weight":
            t = t[..., None]
        elif kind is LayerNormTC:
            t = t.T.contiguous()
        ref = ".".join(_reference_prefix(prefix) + [leaf])
        out[ref] = t
        if leaf == "running_var":
            out[ref.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
    return out


def main(argv=None) -> int:
    """CLI: a port training run's results directory → a reference-loadable
    ``model.ckpt``.

    The template (any reference-written ``model.ckpt`` of the same
    architecture, e.g. one saved by ``train_clip_final.py:531-540``)
    supplies the torch key layout; no reference code is imported."""
    import argparse

    from transformer_clip_eeg_tpu_torch.train.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser(
        prog="python -m transformer_clip_eeg_tpu_torch.utils.torch_export",
        description=main.__doc__,
    )
    ap.add_argument("--run", required=True,
                    help="results dir of a training run (holds checkpoints/model_ckpt.pt)")
    ap.add_argument("--template", required=True,
                    help="reference model.ckpt whose key/shape layout to produce")
    ap.add_argument("--out", required=True, help="output model.ckpt path")
    args = ap.parse_args(argv)

    payload = load_checkpoint(os.path.join(args.run, "checkpoints"))
    if payload is None:
        ap.error(f"no checkpoint in {os.path.join(args.run, 'checkpoints')}")
    template = torch.load(args.template, map_location="cpu", weights_only=True)
    report = save_torch_checkpoint(payload["model"], template, args.out)
    for item in report:
        print(f"kept template value: {item}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
