"""Carry a JAX variable tree across into the torch package's ``state_dict``.

The port's submodules carry the flax module names (``eegModel.conformer_3.
block_0.attn.queries`` …), so the mapping is a walk over names; only the leaf
names and layouts change:

* Dense ``kernel [I, O]``             → ``weight [O, I]``
* Conv1d ``kernel [K, I, O]``         → ``weight [O, I, K]``
* LayerNorm ``scale``/``bias``        → ``weight``/``bias`` (LayerNormTC keeps
  the JAX ``[T, C]`` layout: the port's choice, see ``ops/layers.py``)
* LSTM ``kernel_ih``/``kernel_hh``    → ``weight_ih_l0``/``weight_hh_l0``,
  transposed; ``bias_ih``/``bias_hh`` → ``bias_ih_l0``/``bias_hh_l0``; the
  ``_reverse`` set likewise
* ``membank`` ``eegMemoryBank/memory`` → the ``eegMemoryBank.memory`` buffer
* ``batch_stats`` ``mean``/``var``    → the ``running_mean``/``running_var``
  buffers of the port's ``BatchNorm1d`` (and the baselines' ``BatchNorm2d``)
* a 4-D ``kernel`` (the baselines' torch-layout ``Conv2d``, ``[O, I/g, kH,
  kW]``) → ``weight``, unchanged
* root leaves (``temperature``, ``temperature_eeg``, ``mu_eeg_lookup``) keep
  their names; a submodule applied several times (VLAAI's shared stack)
  holds one set of leaves in both trees.

The functions take numpy arrays (anything ``np.asarray`` reads) and import
nothing of JAX.  :func:`probe_state_dict_from_jax` carries an envelope
probe (JAX ``models/regression.RegressionModel``, a Conv1d named ``conv``)
across, its shape read from the kernel.  :func:`variables_from_state_dict`
is the inverse walk, a port ``state_dict`` → the JAX variable tree, with each
leaf's kind read from its siblings and rank as the reference-key grammar
reads them (``utils/torch_import.py``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LSTM_LEAVES = {
    "kernel_ih": "weight_ih_l0",
    "kernel_hh": "weight_hh_l0",
    "bias_ih": "bias_ih_l0",
    "bias_hh": "bias_hh_l0",
}
_LSTM_LEAVES.update({k + "_reverse": v + "_reverse" for k, v in list(_LSTM_LEAVES.items())})


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_leaf(coll: str, path: Tuple[str, ...], value) -> Tuple[str, np.ndarray]:
    *modules, leaf = path
    arr = np.asarray(value)
    if coll == "batch_stats":
        name = _BATCH_STATS.get(leaf, leaf)
    elif leaf in _LSTM_LEAVES:
        name = _LSTM_LEAVES[leaf]
        arr = arr.T if arr.ndim == 2 else arr
    elif leaf == "kernel" and arr.ndim == 2:
        name, arr = "weight", arr.T
    elif leaf == "kernel" and arr.ndim == 3:
        name, arr = "weight", arr.transpose(2, 1, 0)
    elif leaf == "kernel" and arr.ndim == 4:
        name = "weight"
    elif leaf == "scale":
        name = "weight"
    else:
        name = leaf
    return ".".join(modules + [name]), np.array(arr, order="C", copy=True)


def state_dict_from_jax(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "membank": ..., "batch_stats": ...}`` →
    ``model``'s ``state_dict``.

    Raises ``ValueError`` if a JAX leaf finds no port tensor, if a port
    tensor is left unfilled, or if a shape disagrees.
    """
    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for coll, tree in variables.items():
        if coll not in ("params", "membank", "batch_stats"):
            unused.extend("/".join((coll,) + p) for p, _ in _leaves(tree))
            continue
        for path, value in _leaves(tree):
            key, arr = _torch_leaf(coll, path, value)
            if key not in template:
                unused.append("/".join((coll,) + path))
                continue
            want = template[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} does not "
                                 f"fit {key} {tuple(want.shape)}")
            out[key] = torch.from_numpy(arr).to(dtype=want.dtype)
    missing = [k for k in template if k not in out]
    if unused or missing:
        raise ValueError(f"JAX leaves with no port tensor: {unused}; port "
                         f"tensors left unfilled: {missing}")
    return out


def probe_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX regression probe's ``{"params": {"conv": {"kernel", "bias"}}}``
    → the port's ``RegressionModel`` ``state_dict``."""
    from transformer_clip_eeg_tpu_torch.models.regression import RegressionModel

    k, i, o = np.asarray(variables["params"]["conv"]["kernel"]).shape
    return state_dict_from_jax(variables, RegressionModel(i, o, k))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy() if hasattr(t, "detach") else np.array(t)


def variables_from_state_dict(state_dict: Mapping) -> Dict[str, dict]:
    """A port ``state_dict`` (or a model) → JAX's ``{"params", "batch_stats",
    "membank"}`` trees of numpy arrays: the inverse of
    :func:`state_dict_from_jax`.

    A module's leaves are read by their siblings and rank: LSTM leaves by
    name; ``running_mean`` beside ``weight`` is a batch norm (``scale``,
    ``bias``, ``batch_stats``); a 4-D ``weight`` a torch-layout Conv2d, a 3-D
    one a Conv1d or ``Conv2dValidTime`` (``[K, I, O]``), a 2-D one with a
    2-D ``bias`` a ``LayerNormTC`` (``scale [T, C]``), another 2-D one a
    Dense (``[I, O]``), a 1-D one a LayerNorm; ``memory`` is the bank; root
    leaves keep their names."""
    if isinstance(state_dict, nn.Module):
        state_dict = state_dict.state_dict()
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}, "membank": {}}

    def add(coll: str, path: Tuple[str, ...], value) -> None:
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    groups: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for key, t in state_dict.items():
        *prefix, leaf = key.split(".")
        groups.setdefault(tuple(prefix), {})[leaf] = _numpy(t)
    inverse_lstm = {v: k for k, v in _LSTM_LEAVES.items()}
    for prefix, leaves in groups.items():
        if not prefix:
            for name, v in leaves.items():
                add("params", (name,), v)
            continue
        if set(leaves) == {"memory"}:
            add("membank", prefix + ("memory",), leaves["memory"])
            continue
        if "weight_ih_l0" in leaves:
            for name, v in leaves.items():
                add("params", prefix + (inverse_lstm[name],), v.T if v.ndim == 2 else v)
            continue
        w, b = leaves.get("weight"), leaves.get("bias")
        if "running_mean" in leaves:
            add("batch_stats", prefix + ("mean",), leaves["running_mean"])
            add("batch_stats", prefix + ("var",), leaves["running_var"])
            add("params", prefix + ("scale",), w)
        elif w is None:
            raise ValueError(f"{'.'.join(prefix)}: leaves {sorted(leaves)} of no known kind")
        elif w.ndim == 4:
            add("params", prefix + ("kernel",), w)
        elif w.ndim == 3:
            add("params", prefix + ("kernel",), w.transpose(2, 1, 0).copy())
        elif w.ndim == 2 and b is not None and b.ndim == 2:
            add("params", prefix + ("scale",), w)
        elif w.ndim == 2:
            add("params", prefix + ("kernel",), w.T.copy())
        else:
            add("params", prefix + ("scale",), w)
        if b is not None:
            add("params", prefix + ("bias",), b)
    return {c: t for c, t in trees.items() if t}
