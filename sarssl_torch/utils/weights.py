"""Flax variables <-> the port's ``state_dict`` (the port's own converter).

``from_jax_params`` takes the ``{"params": ..., "batch_stats": ...}`` tree of
``sarssl_tpu`` ``SARSSL.init`` (pretext, with its decoder, or downstream,
with its ``head_*`` modules) or ``SARSSLMultiCH.init`` (the trunk under
``model_sch``, the joint head as ``LayerNorm_0``, ``Dense_0``, ``Dense_1``)
as nested dicts of numpy arrays and returns the parameters and buffers of
:class:`sarssl_torch.models.SARSSL` or ``SARSSLMultiCH``:

  * Dense kernels ``(in, out)`` are transposed to ``(out, in)``;
  * conv kernels go from HWIO to OIHW;
  * depthwise conv kernels ``(k, 1, ch)`` go to ``(ch, 1, k)``;
  * the transformer's attention projections (``DenseGeneral`` kernels
    ``(d, h, hd)`` / ``(h, hd, d)`` and their biases) keep flax's layout;
  * LayerNorm / BatchNorm ``scale`` becomes ``weight``;
  * BatchNorm ``mean`` / ``var`` become the ``running_mean`` / ``running_var``
    buffers.

Module names follow flax's, with flax's automatic names renamed
(``LayerNorm_0`` -> ``ln``, ``LayerNorm_1`` -> ``ln1``, ``Dense_0`` ->
``dense0``, ``Dense_1`` -> ``dense1``, ``Conv_0`` -> ``dwconv``,
``BatchNorm_0`` -> ``bn``, ``MultiHeadDotProductAttention_0`` -> ``mha``,
``block<i>`` -> ``blocks.<i>``, ``layer<i>`` -> ``layers.<i>``, an encoder's
``global`` -> ``seq``, the decoder's ``seq`` -> ``stage``, a GRU's
``GRUCell_0`` / ``GRUCell_1`` -> ``fwd`` / ``bwd`` and its gate ``in`` ->
``in_``) at any depth, the multi-pair head's included. A leaf without a
rename (``cls_token``, ``u_bias``, the decoder's ``conv0``..``proj``, the
CRNNs' ``pre``, ``block<i>a``, ``conv<i>a``, ``down<i>``) keeps its name.
TCRNN's 1-D conv kernels ``(k, cin, cout)`` go to ``(cout, cin, k)`` as the
depthwise ones do.

``to_jax_params`` is the inverse: the model's parameters and BatchNorm stats
as flax's tree of float32 numpy arrays, with flax's names and layouts (a
model sharded over a mesh, ``parallel/steps.py``, gives its whole
parameters, gathered from the model group's ranks); ``flax_tree`` maps any
``{parameter name: tensor}`` dict (the optimizer's moments) the same way.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

_RENAME = {"LayerNorm_0": "ln", "LayerNorm_1": "ln1", "Dense_0": "dense0",
           "Dense_1": "dense1", "Conv_0": "dwconv", "BatchNorm_0": "bn",
           "MultiHeadDotProductAttention_0": "mha", "global": "seq", "seq": "stage",
           "GRUCell_0": "fwd", "GRUCell_1": "bwd", "in": "in_"}
_LISTS = {"block": "blocks", "layer": "layers"}  # flax's block<i> / layer<i>
_INDEXED = re.compile(r"(block|layer)(\d+)$")
_MHA = "MultiHeadDotProductAttention_0"


def _key(path, leaf: str) -> str:
    parts = []
    for p in path:
        m = _INDEXED.match(p)
        parts.append(f"{_LISTS[m.group(1)]}.{m.group(2)}" if m else _RENAME.get(p, p))
    return ".".join(parts + [leaf])


def _param(path, name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel" and _MHA in path:
        return "weight", value  # DenseGeneral, flax's layout
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value  # bias, u_bias, v_bias


_UNRENAME = {v: k for k, v in _RENAME.items()}
_UNLISTS = {v: k for k, v in _LISTS.items()}


def _flax_path(name: str) -> Tuple[List[str], str]:
    parts = name.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] in _UNLISTS:
            path.append(f"{_UNLISTS[parts[i]]}{parts[i + 1]}")
            i += 2
        else:
            path.append(_UNRENAME.get(parts[i], parts[i]))
            i += 1
    return path, parts[-1]


def _flax_param(path, leaf: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "weight" and _MHA in path:
        return "kernel", value
    if leaf == "weight":
        if value.ndim == 1:
            return "scale", value
        if value.ndim == 2:
            return "kernel", value.T
        if value.ndim == 3:
            return "kernel", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return "kernel", value.transpose(2, 3, 1, 0)
        raise ValueError(f"weight of rank {value.ndim}")
    return leaf, value


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``name`` of rank ``ndim``, its
    leaf named as flax names it (``kernel``, ``scale``, ...)."""
    path, leaf = _flax_path(name)
    fleaf, _ = _flax_param(path, leaf, np.empty((0,) * ndim))
    return tuple(path) + (fleaf,)


def _insert(tree: Dict, path: List[str], leaf: str, value: np.ndarray) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    # a copy: the numpy view of a CPU tensor would follow the model's later
    # in-place updates (a running stat, an optimizer step)
    tree[leaf] = np.array(value, dtype=np.float32, order="C")


def flax_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """``{parameter name: tensor}`` -> flax's nested ``params`` tree of f32
    numpy arrays (names and layouts as ``from_jax_params`` reads them)."""
    tree: Dict = {}
    for name, t in named.items():
        path, leaf = _flax_path(name)
        fleaf, value = _flax_param(path, leaf, t.detach().float().cpu().numpy())
        _insert(tree, path, fleaf, value)
    return tree


def to_jax_params(model: torch.nn.Module) -> Dict[str, Dict]:
    """The model as flax's ``{"params": ..., "batch_stats": ...}`` tree of
    f32 numpy arrays, the inverse of ``from_jax_params``."""
    stats_name = {"running_mean": "mean", "running_var": "var"}
    batch_stats: Dict = {}
    for name, b in model.named_buffers():
        path, leaf = _flax_path(name)
        if leaf in stats_name:
            _insert(batch_stats, path, stats_name[leaf], b.detach().float().cpu().numpy())
    params = dict(model.named_parameters())
    layout = getattr(model, "shard_layout", None)
    if layout is not None:
        params = layout.full_dict(params)
    return {"params": flax_tree(params), "batch_stats": batch_stats}


def _walk(tree, path=()):
    for key, value in tree.items():
        if hasattr(value, "items"):  # dict or flax FrozenDict
            yield from _walk(value, path + (key,))
        else:
            yield path, key, np.asarray(value, dtype=np.float32)


def from_jax_params(variables: Dict) -> Tuple[Dict[str, torch.Tensor],
                                              Dict[str, torch.Tensor]]:
    """Returns ``(state_dict, buffers)``; load both with
    ``model.load_state_dict({**state_dict, **buffers}, strict=True)``. The
    tree alone names every leaf, so no config is needed."""
    params, buffers = {}, {}
    for path, name, value in _walk(variables["params"]):
        tname, tvalue = _param(path, name, value)
        params[_key(path, tname)] = torch.tensor(tvalue)
    stats_name = {"mean": "running_mean", "var": "running_var"}
    for path, name, value in _walk(variables.get("batch_stats", {})):
        buffers[_key(path, stats_name[name])] = torch.tensor(value)
    return params, buffers
