"""Microphone-pair rebatching (port of ``sarssl_tpu/ops/pairs.py:18-49``).

  'M'  : mic 0 paired with each other mic -> ``(nb*(nch-1), 2, ...)``
  'MM' : all unordered pairs (i < j)      -> ``(nb*nch*(nch-1)/2, 2, ...)``
  '1'  : identity
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


def num_pairs(nch: int, ch_mode: str = "M") -> int:
    if ch_mode == "1" or nch == 1:
        return 1
    if ch_mode == "M":
        return nch - 1
    if ch_mode == "MM":
        return nch * (nch - 1) // 2
    raise ValueError(f"Unrecognized microphone channel mode: {ch_mode}")
