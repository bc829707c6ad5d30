"""Synthetic 2-mic pairs and their nch-mic variant (the port's own copy of
``sarssl_tpu/data/synthetic.py``, numpy only): with the same seed both
packages draw identical waves.

Each item is an AR-coloured noise source with a short exponential reverb
tail, delayed by a random integer offset of at most ``max_tdoa`` samples
between the mics, plus white noise at a random SNR.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticPairs:
    nsample: int = 16640  # 1.04 s @ 16 kHz
    fs: int = 16000
    max_tdoa_samples: int = 10
    snr_range: Tuple[float, float] = (15.0, 30.0)
    seed: int = 0

    def batches(self, batch_size: int, num_batches: int,
                with_labels: bool = False) -> Iterator:
        rng = np.random.default_rng(self.seed)
        for _ in range(num_batches):
            wave, tdoa = synth_batch(rng, batch_size, self.nsample,
                                     self.max_tdoa_samples, self.snr_range)
            if with_labels:
                yield wave, {"TDOA": tdoa / self.fs}
            else:
                yield wave


def synth_batch(rng: np.random.Generator, nb: int, nsample: int,
                max_tdoa: int = 10, snr_range=(15.0, 30.0)):
    """Returns (wave (nb, nsample, 2) float32, tdoa_samples (nb,) float32);
    a positive TDOA means mic 1 receives later than mic 0."""
    pad = max_tdoa + 1
    src = rng.standard_normal((nb, nsample + 2 * pad)).astype(np.float32)
    src[:, 1:] += 0.7 * src[:, :-1]  # 2-tap AR colouring
    tail = np.exp(-np.arange(64, dtype=np.float32) / 12.0) * 0.3
    tail[0] = 1.0
    src = np.apply_along_axis(lambda s: np.convolve(s, tail)[: s.shape[0]], 1, src)

    tdoa = rng.integers(-max_tdoa, max_tdoa + 1, size=nb)
    m0 = src[:, pad: pad + nsample]
    m1 = np.stack([src[b, pad + tdoa[b]: pad + tdoa[b] + nsample] for b in range(nb)])
    wave = np.stack([m0, m1], axis=-1)
    snr = rng.uniform(*snr_range, size=(nb, 1, 1)).astype(np.float32)
    sig_pow = np.mean(wave ** 2, axis=(1, 2), keepdims=True)
    noise = rng.standard_normal(wave.shape).astype(np.float32)
    noise *= np.sqrt(sig_pow / (10 ** (snr / 10.0)))
    wave = wave + noise
    peak = np.abs(wave).max(axis=(1, 2), keepdims=True)
    wave = wave / np.maximum(peak, 1e-6) * 0.9
    # m1[t] = m0[t + tdoa]: mic 1 hears everything tdoa samples earlier
    return wave.astype(np.float32), (-tdoa).astype(np.float32)


def synth_batch_multich(rng: np.random.Generator, nb: int, nsample: int,
                        nch: int = 4, max_tdoa: int = 10,
                        snr_range=(15.0, 30.0)):
    """nch-mic variant: each mic k > 0 hears the source at its own random
    offset. Returns (wave (nb, nsample, nch) float32, tdoa_samples (nb,
    nch-1) float32 against mic 0; positive: mic k receives later)."""
    pad = max_tdoa + 1
    src = rng.standard_normal((nb, nsample + 2 * pad)).astype(np.float32)
    src[:, 1:] += 0.7 * src[:, :-1]
    tail = np.exp(-np.arange(64, dtype=np.float32) / 12.0) * 0.3
    tail[0] = 1.0
    src = np.apply_along_axis(lambda s: np.convolve(s, tail)[: s.shape[0]], 1, src)
    tdoa = rng.integers(-max_tdoa, max_tdoa + 1, size=(nb, nch - 1))
    chans = [src[:, pad: pad + nsample]]
    for k in range(nch - 1):
        chans.append(np.stack([src[b, pad + tdoa[b, k]: pad + tdoa[b, k] + nsample]
                               for b in range(nb)]))
    wave = np.stack(chans, axis=-1)
    snr = rng.uniform(*snr_range, size=(nb, 1, 1)).astype(np.float32)
    sig_pow = np.mean(wave ** 2, axis=(1, 2), keepdims=True)
    noise = rng.standard_normal(wave.shape).astype(np.float32)
    noise *= np.sqrt(sig_pow / (10 ** (snr / 10.0)))
    wave = wave + noise
    peak = np.abs(wave).max(axis=(1, 2), keepdims=True)
    wave = wave / np.maximum(peak, 1e-6) * 0.9
    return wave.astype(np.float32), (-tdoa).astype(np.float32)
