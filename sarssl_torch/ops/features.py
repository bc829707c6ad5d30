"""Waveform -> model-input features (port of ``sarssl_tpu/ops/features.py``).

STFT as a windowed-DFT matrix product, per-example normalisation by the mean
channel-0 magnitude, mic-pair rebatching, real/imag planes and the DC-bin
drop; or, with ``mel_bins``, an HTK mel projection of the re/im planes. The
products stay ``torch.matmul``, as the JAX package left them to XLA;
``stft_impl="fft"`` takes ``torch.fft.rfft`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .pairs import mic_pair_rebatch
from .stft import _dft_matrices, frame_signal, hann_window, stft


@dataclass(frozen=True)
class FeatureConfig:
    win_len: int = 512
    win_shift_ratio: float = 0.5
    nfft: int = 512
    fre_used_ratio: float = 1.0  # 1.0 -> bins 1..nfft/2 ; 0.5 -> bins 0..nfft/4
    ch_mode: str = "M"
    eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    stft_impl: str = "matmul"
    mel_bins: int = 0  # > 0: HTK mel projection of the re/im planes (n_mels)
    fs: int = 16000

    @property
    def nf_used(self) -> int:
        if self.mel_bins:
            return self.mel_bins
        return int(self.nfft // 2 * self.fre_used_ratio)

    def num_frames(self, nsample: int) -> int:
        hop = int(self.win_len * self.win_shift_ratio)
        return (nsample - self.win_len) // hop + 1


def stft_features(mic_sig: torch.Tensor, cfg: FeatureConfig = FeatureConfig()) -> torch.Tensor:
    """``mic_sig (nb, nsample, nch)`` -> ``(nb*npair, 2, nf_used, nt, 2)``
    (batch*pairs, mic, freq, time, re/im)."""
    if cfg.stft_impl != "matmul" or cfg.mel_bins or cfg.fre_used_ratio != 1.0:
        return _features_generic(mic_sig, cfg)
    # Flagship fast path (features.py:57-87): one interleaved product emits
    # exactly bins 1..nfft/2 as (re, im) pairs. The normaliser averages |X0|
    # over all nfft/2+1 bins, so the skipped DC bin re-enters the mean
    # through a window matvec (DC imag is 0).
    frames = _frames(mic_sig, cfg)                      # (nb, nch, nt, win)
    C, S = _dft_matrices(cfg.win_len, cfg.nfft, frames.dtype, frames.device)
    nfb = cfg.nfft // 2
    cs = torch.stack([C[:, 1:], S[:, 1:]], dim=-1).reshape(cfg.win_len, 2 * nfb)
    out = torch.matmul(frames, cs)
    out = out.reshape(out.shape[:-1] + (nfb, 2))        # (nb, nch, nt, nf, 2)
    dc = torch.matmul(frames[:, 0], hann_window(cfg.win_len, frames.dtype,
                                                frames.device))  # (nb, nt)
    mag0 = torch.sqrt(out[:, 0, :, :, 0] ** 2 + out[:, 0, :, :, 1] ** 2)
    total = mag0.reshape(mag0.shape[0], -1).sum(1) + dc.abs().sum(1)
    mean = total / (out.shape[2] * (nfb + 1))
    reim = out.permute(0, 1, 3, 2, 4)                   # (nb, nch, nf, nt, 2)
    reim = reim / (mean[:, None, None, None, None] + cfg.eps)
    return mic_pair_rebatch(reim, cfg.ch_mode).to(cfg.dtype)


def _frames(mic_sig, cfg):
    hop = int(cfg.win_len * cfg.win_shift_ratio)
    return frame_signal(mic_sig.movedim(-1, 1), cfg.win_len, hop)


def _features_generic(mic_sig: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """All nfft/2+1 bins (features.py:88-121), as separate re/im products or
    through ``torch.fft.rfft`` (``stft_impl="fft"``), normalised by the mean
    channel-0 magnitude over all of them, DC included; then the mel
    projection, or the bin selection of :123-128 (DC drop for ratio 1.0,
    low half for 0.5)."""
    if cfg.stft_impl == "matmul":
        frames = _frames(mic_sig, cfg)
        C, S = _dft_matrices(cfg.win_len, cfg.nfft, frames.dtype, frames.device)
        re = torch.matmul(frames, C).transpose(-1, -2)  # (nb, nch, nf, nt)
        im = torch.matmul(frames, S).transpose(-1, -2)
        reim = torch.stack([re, im], dim=-1)            # (nb, nch, nf, nt, 2)
        mag0 = torch.sqrt(re[:, 0] ** 2 + im[:, 0] ** 2)
        mean = mag0.reshape(mag0.shape[0], -1).mean(1)
        reim = reim / (mean[:, None, None, None, None] + cfg.eps)
        reim = mic_pair_rebatch(reim, cfg.ch_mode)
    else:
        spec = stft(mic_sig, cfg.win_len, cfg.win_shift_ratio, cfg.nfft, impl="fft")
        spec = spec.permute(0, 3, 1, 2)                 # (nb, nch, nf, nt)
        mag0 = spec[:, 0].abs()
        mean = mag0.reshape(mag0.shape[0], -1).mean(1)
        spec = spec / (mean[:, None, None, None] + cfg.eps)
        pairs = mic_pair_rebatch(spec, cfg.ch_mode)     # (nb*npair, 2, nf, nt)
        reim = torch.stack([pairs.real, pairs.imag], dim=-1)
    if cfg.mel_bins:
        # the reference applies torchaudio's MelScale to view_as_real output
        fb = mel_filterbank(cfg.mel_bins, reim.shape[2], cfg.fs, dtype=reim.dtype,
                            device=reim.device)
        reim = torch.einsum("bcftr,mf->bcmtr", reim, fb)
    elif cfg.fre_used_ratio == 1.0:
        reim = reim[:, :, 1:cfg.nf_used + 1]
    elif cfg.fre_used_ratio == 0.5:
        reim = reim[:, :, :cfg.nf_used]
    else:
        raise ValueError("fre_used_ratio must be 1.0 or 0.5")
    return reim.to(cfg.dtype)


def mel_filterbank(n_mels: int, n_freqs: int, fs: int, fmin: float = 0.0,
                   fmax: float = None, dtype=torch.float32, device=None) -> torch.Tensor:
    """HTK-scale triangular mel filterbank, ``(n_mels, n_freqs)``,
    unnormalised (torchaudio ``MelScale``'s defaults: ``mel_scale='htk'``,
    ``norm=None``)."""
    fmax = fmax if fmax is not None else fs / 2
    to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)  # noqa: E731
    from_mel = lambda m: 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)  # noqa: E731
    f_pts = from_mel(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))  # (n_mels + 2,)
    freqs = np.linspace(0, fs / 2, n_freqs)
    lower = (freqs[None, :] - f_pts[:-2, None]) / np.maximum(
        f_pts[1:-1, None] - f_pts[:-2, None], 1e-9)
    upper = (f_pts[2:, None] - freqs[None, :]) / np.maximum(
        f_pts[2:, None] - f_pts[1:-1, None], 1e-9)
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return torch.as_tensor(fb, dtype=dtype, device=device)
