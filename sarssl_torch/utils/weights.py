"""Flax variables -> the port's ``state_dict`` (the port's own converter).

``from_jax_params`` takes the ``{"params": ..., "batch_stats": ...}`` tree of
``sarssl_tpu`` ``SARSSL.init`` (pretext, with its decoder, or downstream,
with its ``head_*`` modules) as nested dicts of numpy arrays and returns the
parameters and buffers of :class:`sarssl_torch.models.SARSSL`:

  * Dense kernels ``(in, out)`` are transposed to ``(out, in)``;
  * conv kernels go from HWIO to OIHW;
  * depthwise conv kernels ``(k, 1, ch)`` go to ``(ch, 1, k)``;
  * LayerNorm / BatchNorm ``scale`` becomes ``weight``;
  * BatchNorm ``mean`` / ``var`` become the ``running_mean`` / ``running_var``
    buffers.

Module names follow flax's, with flax's automatic names renamed
(``LayerNorm_0`` -> ``ln``, ``Dense_0`` -> ``dense0``, ``Conv_0`` ->
``dwconv``, ``BatchNorm_0`` -> ``bn``, ``block<i>`` -> ``blocks.<i>``,
``global`` -> ``seq``).
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_RENAME = {"LayerNorm_0": "ln", "Dense_0": "dense0", "Dense_1": "dense1",
           "Conv_0": "dwconv", "BatchNorm_0": "bn", "global": "seq"}
_BLOCK = re.compile(r"block(\d+)$")


def _key(path, leaf: str) -> str:
    parts = []
    for p in path:
        m = _BLOCK.match(p)
        parts.append(f"blocks.{m.group(1)}" if m else _RENAME.get(p, p))
    return ".".join(parts + [leaf])


def _param(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
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
        tname, tvalue = _param(name, value)
        params[_key(path, tname)] = torch.tensor(tvalue)
    stats_name = {"mean": "running_mean", "var": "running_var"}
    for path, name, value in _walk(variables.get("batch_stats", {})):
        buffers[_key(path, stats_name[name])] = torch.tensor(value)
    return params, buffers
