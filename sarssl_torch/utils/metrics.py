"""Model introspection and data splits (port of ``count_params`` and
``cross_validation_datadirs`` from ``sarssl_tpu/utils/metrics.py``)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
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


def cross_validation_datadirs(room_dirs: Sequence[str], with_val: bool = False, seed: int = 0):
    """Leave-one-room-out splits (the reference's ``cross_validation_datadir``,
    ``utils.py:249-277``, used for ACE fine-tuning): yields {'train': [...],
    'test': [dir]} per held-out room; with ``with_val`` one of the remaining
    rooms becomes the val room, drawn by one generator seeded
    ``(seed, 0xCF)`` (the reference draws it from its global RNG)."""
    rooms = list(room_dirs)
    rng = np.random.default_rng((seed, 0xCF))
    for i, test_room in enumerate(rooms):
        rest = rooms[:i] + rooms[i + 1:]
        if not with_val:
            yield {"train": rest, "test": [test_room]}
            continue
        vi = int(rng.integers(len(rest)))
        yield {"train": rest[:vi] + rest[vi + 1:], "val": [rest[vi]], "test": [test_room]}
