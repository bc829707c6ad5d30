"""Moving a pretrained trunk into a downstream model (the in-memory half of
``sarssl_tpu/train/checkpoint.py``: ``partial_load`` and
``trainable_mask_from_loaded``). Checkpoint files are not ported yet.

Like the JAX downstream run, which loads ``params`` only, ``partial_load``
copies parameters and never buffers: the downstream model keeps its own
freshly initialised BatchNorm running stats.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


@torch.no_grad()
def partial_load(model: torch.nn.Module, source_state_dict: Dict[str, torch.Tensor],
                 ex_prefix: str = "") -> List[str]:
    """Copy ``source_state_dict[name]`` into each parameter of ``model`` of
    the same name and shape; return the names loaded.

    ``ex_prefix`` is stripped from the source names that start with it.
    Source entries that name no parameter (buffers such as BatchNorm running
    stats, or a decoder the model lacks) are skipped."""
    src = {(k[len(ex_prefix):] if ex_prefix and k.startswith(ex_prefix) else k): v
           for k, v in source_state_dict.items()}
    loaded = []
    for name, p in model.named_parameters():
        v = src.get(name)
        if v is not None and tuple(v.shape) == tuple(p.shape):
            p.copy_(v)
            loaded.append(name)
    return loaded


def trainable_mask_from_loaded(model: torch.nn.Module,
                               loaded: Sequence[str]) -> Dict[str, bool]:
    """``{name: trainable}`` over ``model``'s parameters: False for the
    loaded ones (lineareval freezing), True for the rest."""
    done = set(loaded)
    return {name: name not in done for name, _ in model.named_parameters()}
