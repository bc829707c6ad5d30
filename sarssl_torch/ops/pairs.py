"""Microphone-pair rebatching (port of ``sarssl_tpu/ops/pairs.py``).

  'M'  : mic 0 paired with each other mic -> ``(nb*(nch-1), 2, ...)``
  'MM' : all unordered pairs (i < j)      -> ``(nb*nch*(nch-1)/2, 2, ...)``
  '1'  : identity

``pairwise_tdoa`` gives the per-pair targets in that pair order.
"""
from __future__ import annotations

import torch


def mic_pair_rebatch(data: torch.Tensor, ch_mode: str = "M") -> torch.Tensor:
    nb, nch = data.shape[0], data.shape[1]
    if ch_mode == "1" or nch == 1:
        return data
    if nch == 2 and ch_mode in ("M", "MM"):
        return data  # the only pair is (0, 1): already the input layout
    if ch_mode == "M":
        ref = data[:, 0:1].expand((nb, nch - 1) + tuple(data.shape[2:]))
        pairs = torch.stack([ref, data[:, 1:]], dim=2)  # (nb, nch-1, 2, ...)
        return pairs.reshape((nb * (nch - 1), 2) + tuple(data.shape[2:]))
    if ch_mode == "MM":
        ii, jj = torch.triu_indices(nch, nch, offset=1, device=data.device)
        pairs = torch.stack([data[:, ii], data[:, jj]], dim=2)
        return pairs.reshape((nb * ii.numel(), 2) + tuple(data.shape[2:]))
    raise ValueError(f"Unrecognized microphone channel mode: {ch_mode}")


def pair_unbatch(data: torch.Tensor, nb: int) -> torch.Tensor:
    """Inverse view: ``(nb*npair, ...) -> (nb, npair, ...)``."""
    npair = data.shape[0] // nb
    return data.reshape((nb, npair) + tuple(data.shape[1:]))


def num_pairs(nch: int, ch_mode: str = "M") -> int:
    if ch_mode == "1" or nch == 1:
        return 1
    if ch_mode == "M":
        return nch - 1
    if ch_mode == "MM":
        return nch * (nch - 1) // 2
    raise ValueError(f"Unrecognized microphone channel mode: {ch_mode}")


def pairwise_tdoa(tdoa_ref: torch.Tensor, nch: int, ch_mode: str = "M") -> torch.Tensor:
    """Per-mic TDOAs against mic 0, ``(nb, nch-1)`` (positive: mic k hears
    later), as per-pair TDOAs ``(nb, npair)`` in :func:`mic_pair_rebatch`'s
    pair order: 'M' is (0, k) for k = 1..nch-1, 'MM' the pairs i < j in
    row-major order with ``tdoa(i, j) = t_j - t_i`` and ``t_0 = 0``."""
    nb = tdoa_ref.shape[0]
    t = torch.cat([torch.zeros((nb, 1), dtype=tdoa_ref.dtype, device=tdoa_ref.device),
                   tdoa_ref[:, :nch - 1]], dim=1)
    if ch_mode == "M" or nch == 2:
        return t[:, 1:]
    if ch_mode == "MM":
        ii, jj = torch.triu_indices(nch, nch, offset=1, device=t.device)
        return t[:, jj] - t[:, ii]
    raise ValueError(f"Unrecognized microphone channel mode: {ch_mode}")
