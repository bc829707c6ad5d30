"""Noise synthesis: spatial white and isotropic diffuse noise, SNR mixing
(the port's own copy of ``sarssl_tpu/data/noise.py``).

Diffuse noise follows the ANF-generator method used by the reference
(``data_generation/utils_noise.py:141-253``): build the
desired spatial-coherence matrix (sinc for a spherical field, Bessel J0 for
cylindrical), Cholesky-factor it per frequency, and mix M independent noise
channels in the STFT domain. SNR is set against direct-path signal power
(utils_noise.py:157-176).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.linalg
import scipy.signal
import scipy.special


def spatial_white(rng: np.random.Generator, nsample: int, nmic: int) -> np.ndarray:
    return rng.standard_normal((nsample, nmic))


def desired_spatial_coherence(mic_pos: np.ndarray, w_rad: np.ndarray,
                              c: float = 343.0,
                              field: str = "spherical") -> np.ndarray:
    """(nmic, nmic, nf) coherence matrix."""
    M = mic_pos.shape[0]
    dist = np.linalg.norm(mic_pos[:, None, :] - mic_pos[None, :, :], axis=-1)
    arg = w_rad[None, None, :] * dist[:, :, None] / c
    if field == "spherical":
        DC = np.sinc(arg / math.pi)
    elif field == "cylindrical":
        DC = scipy.special.jn(0, arg)
    else:
        raise ValueError(field)
    for p in range(M):
        DC[p, p, :] = 1.0
    return DC


def mix_matrix(DC: np.ndarray) -> np.ndarray:
    """Per-frequency Cholesky factors (nf, nmic, nmic)."""
    M, _, nf = DC.shape
    C = np.zeros((nf, M, M), complex)
    for k in range(1, nf):
        # tiny diagonal loading for numerical PD-ness at high coherence
        C[k] = scipy.linalg.cholesky(DC[:, :, k] + 1e-10 * np.eye(M))
    return C


def diffuse_noise(rng: np.random.Generator, nsample: int, mic_pos: np.ndarray,
                  fs: int, c: float = 343.0, nfft: int = 256,
                  field: str = "spherical", eps: float = 1e-8) -> np.ndarray:
    """Isotropic diffuse noise (nsample, nmic), peak-normalized."""
    M = mic_pos.shape[0]
    src = rng.standard_normal((nsample, M))
    w_rad = 2 * math.pi * fs * np.arange(nfft // 2 + 1) / nfft
    DC = desired_spatial_coherence(mic_pos, w_rad, c, field)
    C = mix_matrix(DC)

    _, _, N = scipy.signal.stft(src.T, window="hann", nperseg=nfft,
                                noverlap=int(0.75 * nfft), nfft=nfft)
    X = np.einsum("fmn,mft->nft", np.conj(C), N)
    _, out = scipy.signal.istft(X, window="hann", nperseg=nfft,
                                noverlap=int(0.75 * nfft), nfft=nfft)
    out = out.T[:nsample]
    if out.shape[0] < nsample:
        out = np.pad(out, ((0, nsample - out.shape[0]), (0, 0)))
    return out / (np.max(np.abs(out)) + eps)


def add_noise(mic_sig_clean: np.ndarray, noise: np.ndarray, snr_db: float,
              mic_sig_dp: Optional[np.ndarray] = None,
              eps: float = 1e-10) -> np.ndarray:
    """Mix noise at the given SNR vs direct-path (or clean) signal power."""
    nsample = mic_sig_clean.shape[0]
    ref = mic_sig_dp if mic_sig_dp is not None else mic_sig_clean
    av_pow = np.mean(np.sum(ref ** 2, axis=0) / nsample)
    av_pow_noise = np.mean(np.sum(noise ** 2, axis=0) / nsample)
    scaled = np.sqrt(av_pow / (10 ** (snr_db / 10))) / (np.sqrt(av_pow_noise) + eps) * noise
    return mic_sig_clean + scaled[:nsample]


def measured_coherence(noise: np.ndarray, nfft: int = 256):
    """Empirical real coherence between channels 0 and 1 (for tests,
    mirrors the reference's _sc_test, utils_noise.py:255-272)."""
    _, _, X = scipy.signal.stft(noise[:, :2].T, window="hann", nperseg=nfft,
                                noverlap=int(0.75 * nfft), nfft=nfft)
    phi = np.mean(np.abs(X) ** 2, axis=2)
    psi = np.mean(X[0] * np.conj(X[1]), axis=-1)
    return np.real(psi / np.sqrt(phi[0] * phi[1] + 1e-12))


def pad_cut_same(sig: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """Repeat-pad then random-cut to n samples (reference
    pad_cut_sig_sameutt, utils_real_micsig.py:19-33)."""
    while sig.shape[0] < n:
        sig = np.concatenate([sig, sig], axis=0)
    st = int(rng.integers(0, sig.shape[0] - n + 1))
    return sig[st:st + n]


def babble_noise(rng: np.random.Generator, nsample: int, mic_pos: np.ndarray,
                 fs: int, speech_sampler, nspeech: int = 10,
                 c: float = 343.0, eps: float = 1e-8) -> np.ndarray:
    """Diffuse babble: M independent sums of ``nspeech`` utterances, mixed
    to the isotropic coherence field (reference utils_noise.py:73-91)."""
    M = mic_pos.shape[0]
    chans = np.zeros((nsample, M))
    for m in range(M):
        acc = np.zeros(nsample)
        for _ in range(nspeech):
            sp = np.asarray(speech_sampler(rng), float).reshape(-1)
            sp = pad_cut_same(sp, nsample, rng)
            acc += sp - sp.mean()
        chans[:, m] = acc
    out = _diffuse_mix(chans, mic_pos, fs, c)
    return out / (np.max(np.abs(out)) + eps)


def xsrc_noise(rng: np.random.Generator, nsample: int, mic_pos: np.ndarray,
               fs: int, recording: np.ndarray, rec_fs: int,
               c: float = 343.0, eps: float = 1e-8) -> np.ndarray:
    """Diffuse noise whose M channels are M disjoint stretches of one long
    single-channel recording (reference 'diffuse_xsrc',
    utils_noise.py:93-112)."""
    M = mic_pos.shape[0]
    rec = np.asarray(recording, float).reshape(-1)
    need = -(-nsample * rec_fs // fs) * M
    rec = pad_cut_same(rec, need, rng)
    if rec_fs != fs:
        rec = scipy.signal.resample_poly(rec, fs, rec_fs)
    rec = rec - rec.mean()
    # resample_poly rounding can land a few samples short of nsample*M
    total = nsample * M
    if rec.shape[0] < total:
        rec = np.pad(rec, (0, total - rec.shape[0]), mode="wrap")
    L = nsample
    chans = np.stack([rec[m * L:(m + 1) * L] for m in range(M)], axis=1)
    out = _diffuse_mix(chans, mic_pos, fs, c)
    return out / (np.max(np.abs(out)) + eps)


def real_world_noise(rng: np.random.Generator, nsample: int, nmic: int,
                     recording: np.ndarray, rec_fs: int, fs: int,
                     eps: float = 1e-8) -> np.ndarray:
    """Recorded multichannel noise, pad-cut and resampled (reference
    'real_world', utils_noise.py:115-128). Channel count must match the
    array."""
    rec = np.asarray(recording, float)
    if rec.ndim == 1:
        rec = rec[:, None]
    if rec.shape[1] != nmic:
        raise ValueError(f"real-world noise has {rec.shape[1]} channels, "
                         f"array has {nmic}")
    need = -(-nsample * rec_fs // fs)
    rec = pad_cut_same(rec, need, rng)
    if rec_fs != fs:
        rec = scipy.signal.resample_poly(rec, fs, rec_fs, axis=0)
    if rec.shape[0] < nsample:  # resample_poly rounding shortfall
        rec = np.pad(rec, ((0, nsample - rec.shape[0]), (0, 0)), mode="wrap")
    rec = rec[:nsample]
    return rec / (np.max(np.abs(rec)) + eps)


def _diffuse_mix(chans: np.ndarray, mic_pos: np.ndarray, fs: int,
                 c: float = 343.0, nfft: int = 256) -> np.ndarray:
    """Impose the isotropic spherical coherence on independent channels."""
    nsample, M = chans.shape
    w_rad = 2 * math.pi * fs * np.arange(nfft // 2 + 1) / nfft
    DC = desired_spatial_coherence(mic_pos, w_rad, c)
    C = mix_matrix(DC)
    _, _, N = scipy.signal.stft(chans.T, window="hann", nperseg=nfft,
                                noverlap=int(0.75 * nfft), nfft=nfft)
    X = np.einsum("fmn,mft->nft", np.conj(C), N)
    _, out = scipy.signal.istft(X, window="hann", nperseg=nfft,
                                noverlap=int(0.75 * nfft), nfft=nfft)
    out = out.T[:nsample]
    if out.shape[0] < nsample:
        out = np.pad(out, ((0, nsample - out.shape[0]), (0, 0)))
    return out
