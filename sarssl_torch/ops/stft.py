"""Batched STFT / ISTFT (port of ``sarssl_tpu/ops/stft.py``).

Periodic Hann window, ``center=False`` framing with
``nt = (nsample - win_len)//hop + 1``, an un-normalised transform, and an
exact window-envelope division on the inverse. ``stft`` computes the
transform as a windowed real-DFT product (``impl="matmul"``) or with
``torch.fft.rfft`` (``impl="fft"``); ``istft`` uses ``torch.fft.irfft``,
complex tensors being native on the card. ``torch.istft`` is not used: with
``center=False`` it refuses the Hann window's zero end sample (NOLA check).
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


def stft(signal: torch.Tensor, win_len: int = 512, win_shift_ratio: float = 0.5,
         nfft: int = 512, impl: str = "matmul") -> torch.Tensor:
    """``signal (nb, nsample, nch)`` float -> ``(nb, nf, nt, nch)`` complex64,
    ``nf = nfft//2 + 1``; all channels in one batched transform."""
    hop = int(win_len * win_shift_ratio)
    frames = frame_signal(signal.movedim(-1, 1), win_len, hop)  # (nb, nch, nt, win)
    if impl == "matmul" and win_len <= nfft:
        C, S = _dft_matrices(win_len, nfft, frames.dtype, frames.device)
        spec = torch.complex(torch.matmul(frames, C).float(), torch.matmul(frames, S).float())
    else:
        win = hann_window(win_len, frames.dtype, frames.device)
        spec = torch.fft.rfft(frames * win, n=nfft, dim=-1)
    return spec.permute(0, 3, 2, 1)  # (nb, nf, nt, nch)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(..., nt, win_len)`` -> ``(..., (nt-1)*hop + win_len)``.

    For ``win_len == 2*hop`` the two half-frame streams are added as two
    shifted slices, with no scatter."""
    *lead, nt, win_len = frames.shape
    out = frames.new_zeros((*lead, (nt - 1) * hop + win_len))
    if win_len == 2 * hop:
        halves = frames.reshape(*lead, nt, 2, hop)
        out[..., :nt * hop] += halves[..., 0, :].reshape(*lead, nt * hop)
        out[..., hop:hop + nt * hop] += halves[..., 1, :].reshape(*lead, nt * hop)
        return out
    for t in range(nt):
        out[..., t * hop:t * hop + win_len] += frames[..., t, :]
    return out


def istft(spec: torch.Tensor, win_len: int = 512, win_shift_ratio: float = 0.5,
          nfft: int = 512) -> torch.Tensor:
    """Inverse of ``stft``: ``(nb, nf, nt, nch)`` complex -> ``(nb, nsample,
    nch)`` float, ``nsample = (nt - 1)*hop + win_len``: irfft, the Hann
    window, overlap-add, then division by ``max(envelope, 1e-11)``, the
    envelope being the overlap-added squared window."""
    hop = int(win_len * win_shift_ratio)
    x = spec.permute(0, 3, 2, 1)  # (nb, nch, nt, nf)
    frames = torch.fft.irfft(x, n=nfft, dim=-1)[..., :win_len]
    # the window and envelope in f64, rounded once: in f32, 1 - cos(2 pi n/N)
    # loses up to 1e-3 of itself at the window's ends, where the envelope
    # division amplifies it (the JAX package's host reconstruction,
    # ``_istft_np``, takes them in f64 too)
    win = hann_window(win_len, torch.float64)
    env = overlap_add((win * win).expand(x.shape[-2], win_len), hop).clamp_min(1e-11)
    sig = overlap_add(frames * win.to(frames.device, frames.dtype), hop)  # (nb, nch, nsample)
    return (sig / env.to(frames.device, frames.dtype)).movedim(1, -1)
