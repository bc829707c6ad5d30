"""Random patch masking (port of ``sarssl_tpu/ops/mask.py``).

Per example, ``nmasked`` patches are masked by the chosen mode, and one of
``nmic`` channels is chosen uniformly. The draws come from an explicit
``torch.Generator``. Each clustered mode is a draw of run starts
(:func:`draw_starts`) followed by a construction that is deterministic given
the starts (:func:`mask_from_starts`): the starts' runs are scattered onto
the patch row, trimmed to the first ``nmasked`` and filled up to ``nmasked``
from the first unmasked patches, as the JAX package's ``_cluster_patch`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

T_MODE = "T"
T1S_MODE = "T_1s"
TCLUSTER_MODE = "T_cluster"
TCLUSTER_INV_MODE = "T_cluster_inverse"
TCLUSTER2_MODE = "T_cluster2"
TF_MODE = "TF"
MASK_MODES = (T_MODE, T1S_MODE, TCLUSTER_MODE, TCLUSTER_INV_MODE, TCLUSTER2_MODE, TF_MODE)

_CLUS = {TCLUSTER_MODE: 5, TCLUSTER_INV_MODE: 5, TCLUSTER2_MODE: 5, TF_MODE: 3}


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


def _check_mode(mode: str, grid_shape) -> None:
    if mode not in MASK_MODES:
        raise ValueError(f"Unrecognized patch mode: {mode}")
    if mode == TF_MODE and grid_shape is None:
        raise ValueError("mask mode 'TF' needs grid_shape=(gh, gw); the pretrain step "
                         "passes none, so draw a 'TF' mask with gen_patch_mask and hand "
                         "it to the step as mask=")


def _built_count(mode: str, npatch: int, nmasked: int) -> int:
    """Patches the construction puts in each row (the inverse mode builds the
    visible ones)."""
    return npatch - nmasked if mode == TCLUSTER_INV_MODE else nmasked


def cluster_runs(mode: str, npatch: int, nmasked: int) -> int:
    """Run starts a clustered mode draws per example."""
    clus = _CLUS[mode]
    size = clus * clus if mode == TF_MODE else clus
    return (_built_count(mode, npatch, nmasked) + size - 1) // size + 1


def draw_starts(generator: torch.Generator, mode: str, nbatch: int, npatch: int,
                nmasked: int) -> torch.Tensor:
    """``(nbatch, cluster_runs)`` int64 run starts of a clustered mode, uniform
    over the patches ('T_cluster2': over the multiples of 5)."""
    shape = (nbatch, cluster_runs(mode, npatch, nmasked))
    if mode == TCLUSTER2_MODE:
        clus = _CLUS[mode]
        grid = torch.randint(0, max(npatch // clus, 1), shape, generator=generator,
                             device=generator.device)
        return grid * clus
    return torch.randint(0, npatch, shape, generator=generator, device=generator.device)


def _cluster_patch(starts: torch.Tensor, npatch: int, count: int, clus: int,
                   grid_shape: Optional[Tuple[int, int]]) -> torch.Tensor:
    nb = starts.shape[0]
    if grid_shape is None:
        offs = torch.arange(clus, device=starts.device)
    else:  # clus x clus blocks on the (gh, gw) patch grid, row-major
        di, dj = torch.meshgrid(torch.arange(clus, device=starts.device),
                                torch.arange(clus, device=starts.device), indexing="ij")
        offs = di.reshape(-1) * grid_shape[1] + dj.reshape(-1)
    cand = (starts[:, :, None] + offs).reshape(nb, -1).clamp(0, npatch - 1)
    patch = torch.zeros((nb, npatch), dtype=torch.bool, device=starts.device)
    patch.scatter_(1, cand, True)  # duplicates collapse
    patch &= patch.cumsum(1) <= count
    deficit = count - patch.sum(1, keepdim=True)
    return patch | (~patch & ((~patch).cumsum(1) <= deficit))


def _idx_from_patch(patch: torch.Tensor, nmasked: int) -> torch.Tensor:
    idx = torch.argsort((~patch).to(torch.uint8), dim=1, stable=True)[:, :nmasked]
    return torch.sort(idx, dim=1).values


def mask_from_starts(mode: str, starts: torch.Tensor, npatch: int, nmasked: int,
                     grid_shape: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """``(patch, idx)`` of a clustered mode from its drawn ``starts``: exactly
    ``nmasked`` masked patches per row, ``idx`` ascending."""
    _check_mode(mode, grid_shape)
    if mode not in _CLUS:
        raise ValueError(f"mask mode {mode!r} draws no run starts")
    patch = _cluster_patch(starts, npatch, _built_count(mode, npatch, nmasked), _CLUS[mode],
                           grid_shape if mode == TF_MODE else None)
    if mode == TCLUSTER_INV_MODE:
        patch = ~patch
    return patch, _idx_from_patch(patch, nmasked)


def gen_patch_mask(generator: torch.Generator, nbatch: int, npatch: int,
                   nmasked: int, nmic: int = 2, mode: str = T_MODE,
                   grid_shape: Optional[Tuple[int, int]] = None, device=None) -> PatchMask:
    """Draw a mask on ``generator``'s device, then move it to ``device``.

    'T'                : ``nmasked`` uniform without replacement.
    'T_1s'             : the last quarter of the patches (``nmasked`` unused).
    'T_cluster'        : runs of 5 from uniform starts until ``nmasked``.
    'T_cluster_inverse': the complement of a 'T_cluster' draw of
                         ``npatch - nmasked`` visible patches.
    'T_cluster2'       : runs of 5 from starts on multiples of 5.
    'TF'               : 3 x 3 blocks on the ``grid_shape = (gh, gw)`` patch
                         grid.
    The channel is drawn after the patches."""
    _check_mode(mode, grid_shape)
    gdev = generator.device
    if mode == T_MODE:
        u = torch.rand((nbatch, npatch), generator=generator, device=gdev)
        idx = torch.sort(torch.argsort(u, dim=1)[:, :nmasked], dim=1).values
        patch = torch.zeros((nbatch, npatch), dtype=torch.bool, device=gdev)
        patch.scatter_(1, idx, True)
    elif mode == T1S_MODE:
        start = npatch - npatch // 4
        idx = torch.arange(start, npatch, device=gdev).expand(nbatch, -1).contiguous()
        patch = torch.zeros((nbatch, npatch), dtype=torch.bool, device=gdev)
        patch[:, start:] = True
    else:
        starts = draw_starts(generator, mode, nbatch, npatch, nmasked)
        patch, idx = mask_from_starts(mode, starts, npatch, nmasked, grid_shape)
    ch = torch.randint(0, nmic, (nbatch,), generator=generator, device=gdev)
    mask = PatchMask(patch=patch, ch=ch, idx=idx)
    return mask if device is None else mask.to(device)
