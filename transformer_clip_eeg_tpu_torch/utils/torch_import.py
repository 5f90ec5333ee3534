"""Load the reference's PyTorch checkpoints into the port's models.

Counterpart of ``transformer_clip_eeg_tpu/utils/torch_import.py``.  A
reference ``checkpoints/model.ckpt`` is a bare ``state_dict`` written by
``torch.save`` (ref ``train_clip_final.py:531-540``) under the reference's
module names.  The port's modules carry the JAX package's flax names
(``utils/convert.py``), so a reference key is resolved as the JAX package
resolves it: the key grammar below (a copy of JAX's ``_rewrite_comps``,
``_resolve_node``, ``_resolve_path`` and ``_emit_group``) maps the key's
module path onto the flax tree of the port model and converts its leaves to
the flax layout; ``utils/convert.py``'s leaf rules then give the port's key
and layout:

* ``nn.Linear``, ``nn.Conv1d`` and ``nn.LSTM`` keep torch's layout;
* the reference's 2-D ``LayerNorm([C, T])`` becomes ``LayerNormTC`` ``[T, C]``;
* the valid-time ``Conv2d`` weight ``[F, 1, kT, 1]`` becomes
  ``Conv2dValidTime``'s ``[F, 1, kT]``;
* ``BatchNorm1d``'s running statistics become the port's buffers;
* ``eegMemoryBank.memory`` is the bank; ``mu_eeg_lookup.weight`` (an
  ``nn.Embedding``) the root table.

The grammar handles the reference's ``TransformerEncoder`` Sequential
internals (``<i>.0.fn.0`` → ``block_<i>.ln1``, …), VLAAI's
``sequentialConvStack.{0,1,2}`` and ``conv_layers.{3j,3j+1}``, and skips
bare Sequential digits the flax tree does not have.

Partial-load semantics are JAX's (ref ``:546-554``): a checkpoint key that
matches nothing is reported, a template leaf with no entry keeps its value,
a shape mismatch is skipped and reported; a batch norm's
``num_batches_tracked`` has no counterpart and is dropped, as in JAX.  The
template is the port model's own ``state_dict``; every function returns
port-named tensors on the CPU.  Files are read with ``torch.load(...,
weights_only=True)``.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from transformer_clip_eeg_tpu_torch.utils.convert import (
    _leaves,
    _numpy,
    _torch_leaf,
    variables_from_state_dict,
)

# an nn.LSTM's leaves → the flax LSTM's
_LSTM_LEAVES = (
    ("weight_ih_l0", "kernel_ih"),
    ("weight_hh_l0", "kernel_hh"),
    ("bias_ih_l0", "bias_ih"),
    ("bias_hh_l0", "bias_hh"),
    ("weight_ih_l0_reverse", "kernel_ih_reverse"),
    ("weight_hh_l0_reverse", "kernel_hh_reverse"),
    ("bias_ih_l0_reverse", "bias_ih_reverse"),
    ("bias_hh_l0_reverse", "bias_hh_reverse"),
)


class _Collector:
    """Accumulates (collection, path) → array entries into nested dicts."""

    def __init__(self):
        self.trees: Dict[str, Dict] = {}

    def add(self, collection: str, path: Tuple[str, ...], value: np.ndarray):
        node = self.trees.setdefault(collection, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)


def _rewrite_comps(comps):
    """Torch key components → flax path components: the reference's
    TransformerEncoder(Sequential) internals (ref clip_model.py:75-99 →
    block_{i}.ln1/attn/ln2/ffn.fc1/fc2), VLAAI's sequentialConvStack (ref
    vlaai.py:101 → extractor / linear_recombination / output_context) and
    its stride-3 conv/norm layer list (ref vlaai.py:24-41)."""
    out = []
    i = 0
    n = len(comps)
    while i < n:
        c = comps[i]
        if c.isdigit() and i + 2 < n and comps[i + 1] in ("0", "1") and comps[i + 2] == "fn":
            blk = f"block_{c}"
            branch, rest = comps[i + 1], comps[i + 3:]
            if branch == "0" and rest[:1] == ["0"]:
                out += [blk, "ln1"]
                i += 4
            elif branch == "0" and rest[:1] == ["1"]:
                out += [blk, "attn"]
                i += 4
            elif branch == "1" and rest[:1] == ["0"]:
                out += [blk, "ln2"]
                i += 4
            elif branch == "1" and rest[:2] == ["1", "0"]:
                out += [blk, "ffn", "fc1"]
                i += 5
            elif branch == "1" and rest[:2] == ["1", "3"]:
                out += [blk, "ffn", "fc2"]
                i += 5
            else:
                out.append(c)
                i += 1
            continue
        if c == "sequentialConvStack" and i + 1 < n and comps[i + 1].isdigit():
            out.append({"0": "extractor", "1": "linear_recombination",
                        "2": "output_context"}[comps[i + 1]])
            i += 2
            continue
        if c == "conv_layers" and i + 1 < n and comps[i + 1].isdigit():
            j = int(comps[i + 1])
            out.append(f"conv_{j // 3}" if j % 3 == 0 else f"norm_{j // 3}")
            i += 2
            continue
        out.append(c)
        i += 1
    return out


def _resolve_node(tree, comps):
    """Resolve rewritten components against the template params tree; bare
    digit components the template lacks (the reference's
    ``Sequential(layer, activation)`` wrappers) are skipped.  Returns the
    module dict, a bare leaf (the KLD ``mu_eeg_lookup`` table) or None."""
    if not comps:
        return tree
    c = comps[0]
    if isinstance(tree, dict):
        if c in tree:
            r = _resolve_node(tree[c], comps[1:])
            if r is not None:
                return r
        if c.isdigit():
            return _resolve_node(tree, comps[1:])
    return None


def _resolve_path(tree, comps):
    """Like ``_resolve_node`` but returns the flax path taken."""
    if not comps:
        return ()
    c = comps[0]
    if isinstance(tree, dict):
        if c in tree:
            r = _resolve_path(tree[c], comps[1:])
            if r is not None:
                return (c,) + r
        if c.isdigit():
            return _resolve_path(tree, comps[1:])
    return None


def _emit_group(col, path, node, leaves, unmatched, prefix_str):
    """Convert one module's leaf group by its type cues (sibling keys and
    rank) into flax leaves at ``path``."""
    if "weight_ih_l0" in leaves:
        for tk, fk in _LSTM_LEAVES:
            if tk in leaves:
                v = leaves[tk]
                col.add("params", path + (fk,), v.T if v.ndim == 2 else v)
        return
    if "running_mean" in leaves:
        col.add("params", path + ("scale",), leaves["weight"])
        col.add("params", path + ("bias",), leaves["bias"])
        col.add("batch_stats", path + ("mean",), leaves["running_mean"])
        col.add("batch_stats", path + ("var",), leaves["running_var"])
        return
    w = leaves.get("weight")
    if w is None:
        unmatched.append(prefix_str)
        return
    b = leaves.get("bias")
    if not isinstance(node, dict):  # a bare table: mu_eeg_lookup
        col.add("params", path, w)
        return
    if w.ndim == 3:
        col.add("params", path + ("kernel",), w.transpose(2, 1, 0))
    elif w.ndim == 4:
        col.add("params", path + ("kernel",), w[:, 0, :, 0].T[:, None, :])
    elif w.ndim == 2 and b is not None and b.ndim == 2:
        col.add("params", path + ("scale",), w.T)
        col.add("params", path + ("bias",), b.T)
        return
    elif w.ndim == 2:
        col.add("params", path + ("kernel",), w.T)
    else:  # 1-D LayerNorm
        col.add("params", path + ("scale",), w)
        if b is not None:
            col.add("params", path + ("bias",), b)
        return
    if b is not None:
        col.add("params", path + ("bias",), b)


def _state_dict(template) -> Dict[str, Any]:
    return template.state_dict() if isinstance(template, nn.Module) else template


def _to_port(trees: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax leaves → port keys and layouts (``utils/convert.py``)."""
    out = {}
    for coll, tree in trees.items():
        for path, value in _leaves(tree):
            key, arr = _torch_leaf(coll, path, value)
            out[key] = torch.from_numpy(arr)
    return out


def convert_state_dict(state_dict: Dict[str, Any], template) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Reference ``state_dict`` → port-named tensors, guided by ``template``
    (the port model or its ``state_dict``).

    Returns ``(converted, unmatched)``: ``converted`` holds only the leaves
    the checkpoint has (overlay it on the template with
    :func:`merge_variables`); ``unmatched`` names the checkpoint's module
    paths (and root leaves) that resolve to nothing."""
    params_t = variables_from_state_dict(_state_dict(template)).get("params", {})
    col = _Collector()
    unmatched: List[str] = []
    groups: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for k, t in state_dict.items():
        comps = k.split(".")
        groups.setdefault(tuple(comps[:-1]), {})[comps[-1]] = _numpy(t)

    for prefix, leaves in groups.items():
        if not prefix:  # root scalars: temperature, temperature_eeg
            for name, v in leaves.items():
                if name in params_t:
                    col.add("params", (name,), v)
                else:
                    unmatched.append(name)
            continue
        if "memory" in leaves:  # the reference's memoryBank buffer
            col.add("membank", prefix + ("memory",), leaves["memory"])
            continue
        comps = _rewrite_comps(list(prefix))
        node = _resolve_node(params_t, comps)
        path = _resolve_path(params_t, comps)
        if node is None or path is None:
            unmatched.append(".".join(prefix))
            continue
        _emit_group(col, path, node, leaves, unmatched, ".".join(prefix))
    return _to_port(col.trees), unmatched


def merge_variables(template, converted: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Overlay ``converted`` on a copy of ``template`` (the port model or its
    ``state_dict``), each leaf in the template's dtype; a shape mismatch
    keeps the template's value and is reported, as is a converted key the
    template lacks (ref :546-554)."""
    template = _state_dict(template)
    skipped: List[str] = []
    merged = {}
    for k, t in template.items():
        c = converted.get(k)
        if c is None:
            merged[k] = t.detach().cpu().clone()
        elif tuple(c.shape) != tuple(t.shape):
            skipped.append(k)
            merged[k] = t.detach().cpu().clone()
        else:
            merged[k] = c.detach().cpu().to(t.dtype).clone()
    skipped += [k for k in converted if k not in template]
    return merged, skipped


def load_torch_state_dict(source, template) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference ``model.ckpt`` path (or a loaded ``state_dict``) and the
    port model (or its ``state_dict``) → ``(merged_state_dict, report)``.

    ``report`` lists checkpoint keys without a template match and template
    leaves skipped for a shape mismatch: empty for a faithful pair."""
    if isinstance(source, (str, os.PathLike)):
        source = torch.load(source, map_location="cpu", weights_only=True)
    converted, unmatched = convert_state_dict(source, template)
    merged, skipped = merge_variables(template, converted)
    return merged, unmatched + skipped


# --------------------------------------------------------------------------
# Module walkers.  JAX walks the reference's torch modules class by class;
# here each goes through the module's ``state_dict()`` and the grammar above,
# which is what a results directory holds.  Without the reference's code
# these are tested only through that state_dict path.
# --------------------------------------------------------------------------


def convert_encoder(torch_encoder: nn.Module, template) -> Dict[str, torch.Tensor]:
    """A reference encoder module → the port encoder ``template``'s named
    tensors (keys the grammar cannot place are left out)."""
    return convert_state_dict(torch_encoder.state_dict(), template)[0]


def convert_head(torch_head: nn.Module, template) -> Dict[str, torch.Tensor]:
    """A reference head (encoders, temperatures, bank, projections, the KLD
    table and linears) → the port model ``template``'s named tensors."""
    return convert_state_dict(torch_head.state_dict(), template)[0]


def convert_regression_model(torch_probe: nn.Module) -> Dict[str, torch.Tensor]:
    """The reference's ``RegressionModel`` (helper:1132-1140, a Conv1d named
    ``conv``) → the port's ``RegressionModel`` ``state_dict``."""
    from transformer_clip_eeg_tpu_torch.models.regression import RegressionModel

    out_dim, in_dim, k = torch_probe.conv.weight.shape
    return convert_state_dict(torch_probe.state_dict(), RegressionModel(in_dim, out_dim, k))[0]


def load_torch_checkpoint(path: str, torch_model_factory, template) -> Dict[str, torch.Tensor]:
    """A reference ``model.ckpt`` loaded into the reference module that
    ``torch_model_factory`` builds (``strict=False``, as the reference's eval
    loader), then converted for the port model ``template``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = torch_model_factory()
    model.load_state_dict(state, strict=False)
    return convert_head(model, template)
