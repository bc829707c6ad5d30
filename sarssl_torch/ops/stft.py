"""STFT building blocks (port of ``sarssl_tpu/ops/stft.py:21-58``).

Periodic Hann window, ``center=False`` framing with
``nt = (nsample - win_len)//hop + 1``, and the windowed real-DFT basis that
the feature path multiplies frames with. The inverse transform is not ported
yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def hann_window(win_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = torch.arange(win_len, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_len))


def frame_signal(x: torch.Tensor, win_len: int, hop: int) -> torch.Tensor:
    """Split ``x (..., nsample)`` into frames ``(..., nt, win_len)``.

    Frame ``t`` covers samples ``[t*hop, t*hop + win_len)``. When
    ``win_len == 2*hop`` the frames are two half-frame views of one reshape
    instead of a gather.
    """
    nsample = x.shape[-1]
    nt = (nsample - win_len) // hop + 1
    if win_len == 2 * hop and nsample % hop == 0:
        blocks = x.reshape(x.shape[:-1] + (nsample // hop, hop))
        return torch.cat([blocks[..., :nt, :], blocks[..., 1:nt + 1, :]], dim=-1)
    starts = torch.arange(nt, device=x.device) * hop
    idx = starts[:, None] + torch.arange(win_len, device=x.device)[None, :]
    return x[..., idx]


def _dft_matrices(win_len: int, nfft: int, dtype=torch.float32, device=None):
    """Hann-windowed real-DFT basis: ``frames @ C`` and ``frames @ S`` are the
    real and imaginary rFFT values, ``(win_len, nfft//2 + 1)`` each."""
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_len) / win_len))
    cw = win[:, None] * np.cos(ang)[:win_len]
    sw = win[:, None] * np.sin(ang)[:win_len]
    return (torch.as_tensor(cw, dtype=dtype, device=device),
            torch.as_tensor(sw, dtype=dtype, device=device))
