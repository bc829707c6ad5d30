"""Direct-path inter-channel phase difference (DPIPD) templates (port of
``sarssl_tpu/ops/dpipd.py``).

The complex IPD template over a DOA candidate grid for a mic geometry, and
the IPDs of given source DOAs, vectorised over the mic pairs, as complex64
tensors: ``ch_mode`` 'M' keeps the pairs (0, m), 'MM' every pair i < j.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.device import resolve_device


def _pair_adjust(data: torch.Tensor, ch_mode: str) -> torch.Tensor:
    """(..., nmic, nmic) -> (..., nmic-1) ['M'] or (..., nmic(nmic-1)/2) ['MM']."""
    nmic = data.shape[-1]
    if ch_mode == "M":
        return data[..., 0, 1:]
    if ch_mode == "MM":
        ii, jj = torch.triu_indices(nmic, nmic, 1, device=data.device)
        return data[..., ii, jj]
    raise ValueError(ch_mode)


def _unit_vectors(ele: torch.Tensor, azi: torch.Tensor) -> torch.Tensor:
    ele, azi = torch.broadcast_tensors(ele, azi)
    return torch.stack([torch.sin(ele) * torch.cos(azi), torch.sin(ele) * torch.sin(azi),
                        torch.cos(ele)], dim=-1)


def _mics(mic_location, device) -> torch.Tensor:
    return torch.as_tensor(mic_location, dtype=torch.float32, device=device)


def dpipd_template(mic_location, ndoa_candidate: Tuple[int, int] = (37, 73),
                   nf: int = 257, fre_max: float = 8000.0, ch_mode: str = "M",
                   speed: float = 343.0, device="cuda"):
    """Returns (template ``(nele, nazi, nf, npair)`` complex64,
    ``(ele_candidates, azi_candidates)``), built on ``device``."""
    device = resolve_device(device)
    mic = _mics(mic_location, device)
    nele, nazi = ndoa_candidate
    ele = torch.linspace(0, math.pi, nele, device=device)
    azi = torch.linspace(-math.pi, math.pi, nazi, device=device)
    fre = torch.linspace(0.0, fre_max, nf, device=device)
    r = _unit_vectors(ele[:, None], azi[None, :])  # (nele, nazi, 3)
    # ITD[m1, m2] = r . (mic[m2] - mic[m1]) / c
    dvec = mic[None, :, :] - mic[:, None, :]  # (nmic, nmic, 3)
    itd = torch.einsum("eak,mnk->eamn", r, dvec) / speed
    ipd = (-2 * math.pi) * fre[None, None, :, None, None] * itd[:, :, None]
    return _pair_adjust(torch.polar(torch.ones_like(ipd), ipd), ch_mode), (ele, azi)


def dpipd_for_doa(source_doa, mic_location, nf: int = 257, fre_max: float = 8000.0,
                  ch_mode: str = "M", speed: float = 343.0) -> torch.Tensor:
    """IPD for given DOAs. ``source_doa``: ``(nb, ntime, 2, nsrc)`` [ele, azi]
    radians (a tensor, or an array read onto the CPU). Returns ``(nb,
    ntime, nf, npair, nsrc)`` complex64 on the DOAs' device."""
    doa = torch.as_tensor(source_doa, dtype=torch.float32).movedim(2, -1)  # (nb, nt, nsrc, 2)
    mic = _mics(mic_location, doa.device)
    fre = torch.linspace(0.0, fre_max, nf, device=doa.device)
    r = _unit_vectors(doa[..., 0], doa[..., 1])  # (nb, nt, nsrc, 3)
    dvec = mic[:, None, :] - mic[None, :, :]  # m1 - m2, as the reference
    itd = torch.einsum("btsk,mnk->btsmn", r, dvec) / speed
    ipd = 2 * math.pi * fre[None, None, None, :, None, None] * itd[:, :, :, None]
    dp = _pair_adjust(torch.polar(torch.ones_like(ipd), ipd), ch_mode)  # (nb, nt, nsrc, nf, np)
    return dp.movedim(2, -1)
