"""Random patch masking (port of ``sarssl_tpu/ops/mask.py``, mode 'T').

Per example, exactly ``nmasked`` of ``npatch`` patches are masked uniformly
without replacement, and one of ``nmic`` channels is chosen uniformly. The
draws come from an explicit ``torch.Generator``; the other masking modes are
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

T_MODE = "T"


class PatchMask(NamedTuple):
    """``True`` means *masked*.

    patch: ``(nb, npatch)`` bool — which patches are masked.
    ch:    ``(nb,)`` int64      — index of the masked channel.
    idx:   ``(nb, nmasked)`` int64 — masked patch indices (ascending).
    """

    patch: torch.Tensor
    ch: torch.Tensor
    idx: torch.Tensor

    def to(self, device) -> "PatchMask":
        return PatchMask(*(t.to(device, non_blocking=True) for t in self))


def gen_patch_mask(generator: torch.Generator, nbatch: int, npatch: int,
                   nmasked: int, nmic: int = 2, mode: str = T_MODE,
                   device=None) -> PatchMask:
    """Draw a mask on ``generator``'s device, then move it to ``device``."""
    if mode != T_MODE:
        raise NotImplementedError(f"mask mode {mode!r} is not ported yet")
    gdev = generator.device
    u = torch.rand((nbatch, npatch), generator=generator, device=gdev)
    idx = torch.sort(torch.argsort(u, dim=1)[:, :nmasked], dim=1).values
    patch = torch.zeros((nbatch, npatch), dtype=torch.bool, device=gdev)
    patch.scatter_(1, idx, True)
    ch = torch.randint(0, nmic, (nbatch,), generator=generator, device=gdev)
    mask = PatchMask(patch=patch, ch=ch, idx=idx)
    return mask if device is None else mask.to(device)
