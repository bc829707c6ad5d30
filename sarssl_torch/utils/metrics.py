"""Model introspection, FLOP counts, the forgetting normaliser and data
splits (port of ``sarssl_tpu/utils/metrics.py``)."""
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


def estimate_flops(fn, *args) -> float:
    """GFLOPs of one call ``fn(*args)`` without autograd, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (the reference's
    printout, ``utils.py:75-89``): matmuls, convolutions and attention only.
    XLA's cost analysis, which the JAX package reads, also counts elementwise
    work, so the two differ on a whole model."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops() / 1e9


def forgetting_norm(x: torch.Tensor, num_frame_set: int = None) -> torch.Tensor:
    """Per-frame 'forgetting' normaliser (the reference's
    ``common/utils.py:142-172``, from "Online Monaural Speech Enhancement
    using Delayed Subband LSTM"): the running mean of each frame's average
    magnitude with the smoothing factor ``alpha_t = (t-1)/(t+1)``, held at
    ``(N-1)/(N+1)`` past frame N. As in the reference, ``alpha_0 = -1``, so
    ``mu_0 = 2 m_0``.

    ``x``: ``(B, C, F, T)``; returns ``(B, 1, 1, T)``."""
    if x.ndim != 4:
        raise ValueError(f"forgetting_norm takes (B, C, F, T), got {tuple(x.shape)}")
    B, C, F, T = x.shape
    N = T if num_frame_set is None else num_frame_set
    frame_mu = x.reshape(B, C * F, T).mean(1)  # (B, T)
    t = torch.arange(T, device=x.device)
    alpha = torch.where(t <= N, (t - 1) / (t + 1), (N - 1) / (N + 1)).to(x.dtype)
    mu = torch.zeros(B, dtype=x.dtype, device=x.device)
    mus = []
    for i in range(T):  # a linear recurrence, frame by frame as the reference runs it
        mu = alpha[i] * mu + (1 - alpha[i]) * frame_mu[:, i]
        mus.append(mu)
    return torch.stack(mus, dim=1).reshape(B, 1, 1, T)


def detect_nonfinite(tree, name: str = "tensor") -> bool:
    """True if a floating tensor of ``tree`` (a module's parameters and
    buffers, or a nested dict of tensors / arrays) holds a NaN or Inf; prints
    ``nonfinite values in <name>:<path>`` for each such leaf (one device
    sync in all)."""
    if isinstance(tree, torch.nn.Module):
        leaves = [*tree.named_parameters(), *tree.named_buffers()]
    else:
        leaves = list(_named_leaves(tree))
    leaves = [(path, torch.as_tensor(v)) for path, v in leaves]
    leaves = [(path, v) for path, v in leaves if v.is_floating_point() or v.is_complex()]
    if not leaves:
        return False
    dev = leaves[0][1].device
    bad = torch.stack([~torch.isfinite(v.detach()).all().to(dev) for _, v in leaves]).tolist()
    for (path, _), b in zip(leaves, bad):
        if b:
            print(f"nonfinite values in {name}:{path}")
    return any(bad)


def _named_leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _named_leaves(value, path + (key,))
        else:
            yield "/".join(map(str, path + (key,))), value
