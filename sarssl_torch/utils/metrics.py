"""Model introspection (port of ``count_params`` from
``sarssl_tpu/utils/metrics.py``)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def count_params(model: torch.nn.Module, groups: Sequence[str] = ()) -> Dict[str, float]:
    """Parameter counts in millions, total and per top-level module whose
    name starts with a group's."""
    out: Dict[str, float] = {}
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        top = name.split(".")[0]
        for g in groups:
            if top.startswith(g):
                out[g] = out.get(g, 0) + n
    out = {k: v / 1e6 for k, v in out.items()}
    out["total"] = total / 1e6
    return out
