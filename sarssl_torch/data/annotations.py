"""Acoustic annotations: TDOA, DOA, DRR, C50/C80, T60-from-EDC, ABS (the
port's own copy of ``sarssl_tpu/data/annotations.py``, numpy and scipy only).

Formulas mirror the reference annotator
(``data_generation/utils_simu_rir_sig.py:910-1019``) and the EDC-based T60
estimator (``:526-614``):

  TDOA   geometric path-length difference vs mic 0, in seconds;
  DRR    direct (+/-2.5 ms window around the direct-path peak) to reverberant
         energy ratio in dB, reference channel;
  C50/80 early (<= peak + 50/80 ms) to late energy ratio in dB;
  T60    Schroeder-integration EDC + best-of linear regressions over a grid
         of [start dB, duration dB] windows, scored by |r|;
  ABS    mean Sabine absorption 0.161 V / (S * T60).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.stats


def cart2sph(cart: np.ndarray) -> np.ndarray:
    """[x,y,z] -> [azi, ele, r] (radians)."""
    xy2 = cart[..., 0] ** 2 + cart[..., 1] ** 2
    sph = np.zeros_like(cart)
    sph[..., 0] = np.arctan2(cart[..., 1], cart[..., 0])
    sph[..., 1] = np.arctan2(np.sqrt(xy2), cart[..., 2])
    sph[..., 2] = np.sqrt(xy2 + cart[..., 2] ** 2)
    return sph


def tdoa_from_geometry(traj_pts: np.ndarray, mic_pos: np.ndarray,
                       c: float = 343.0) -> np.ndarray:
    """(npt, nmic-1, nsrc) TDOAs (seconds) of each mic vs mic 0."""
    npt = traj_pts.shape[0]
    nmic = mic_pos.shape[0]
    diff = traj_pts[:, None, :, :] - mic_pos[None, :, :, None]
    dist = np.sqrt(np.sum(diff ** 2, axis=2))  # (npt, nmic, nsrc)
    return (dist[:, 1:] - dist[:, 0:1]) / c


def doa_from_geometry(traj_pts: np.ndarray, array_pos: np.ndarray) -> np.ndarray:
    """(npt, 2, nsrc) [ele, azi] in radians."""
    npt, _, nsrc = traj_pts.shape
    out = np.zeros((npt, 2, nsrc), np.float32)
    for s in range(nsrc):
        sph = cart2sph(traj_pts[:, :, s] - array_pos)
        out[:, :, s] = sph[:, [1, 0]]
    return out


def _dp_window_energy(rir: np.ndarray, rir_dp: np.ndarray, half_ms: float,
                      fs: int, mode: str, eps: float = 1e-8):
    """Shared energy-split helper. rir/rir_dp: (npt, nmic, nsamp, nsrc)."""
    ns = max(rir.shape[2], rir_dp.shape[2])

    def pad(x):
        if x.shape[2] < ns:
            z = np.zeros(x.shape[:2] + (ns - x.shape[2],) + x.shape[3:])
            return np.concatenate([x, z], axis=2)
        return x

    r = pad(rir)
    rd = pad(rir_dp)
    nd = np.argmax(rd, axis=2)[:, :, None, :]  # direct-path peak index
    n0 = int(fs * half_ms / 1000)
    t = np.arange(ns)[None, None, :, None]
    if mode == "around":  # DRR: +/- window around the peak
        sel = (t >= nd - n0) & (t <= nd + n0)
    else:  # C50/C80: everything up to peak + window
        sel = t <= nd + n0
    ein = np.sum(r ** 2 * sel, axis=2)
    eout = np.sum(r ** 2 * (~sel), axis=2)
    return 10 * np.log10(ein / (eout + eps) + eps)


def drr(rir, rir_dp, fs: int = 16000) -> np.ndarray:
    """(npt, nsrc) direct-to-reverberant ratio, ref channel 0."""
    return _dp_window_energy(rir, rir_dp, 2.5, fs, "around")[:, 0, :]


def c50(rir, rir_dp, fs: int = 16000) -> np.ndarray:
    return _dp_window_energy(rir, rir_dp, 50.0, fs, "upto")[:, 0, :]


def c80(rir, rir_dp, fs: int = 16000) -> np.ndarray:
    return _dp_window_energy(rir, rir_dp, 80.0, fs, "upto")[:, 0, :]


def edc(rir_1d: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Schroeder energy decay curve in dB."""
    max_idx = int(np.argmax(rir_1d))
    denom = np.sum(rir_1d[max_idx:] ** 2) + eps
    return 10.0 * np.log10(np.cumsum(rir_1d[::-1] ** 2)[::-1] / denom + eps)


def t60_from_rir(rir_1d: np.ndarray, fs: int,
                 edc_starts=range(-5, -20, -2),
                 edc_durations=range(-10, -30, -2),
                 eps: float = 1e-10) -> Tuple[float, float]:
    """(T60 seconds, regression |r|) via best-of linear fits on the EDC."""
    E = edc(rir_1d)
    times = np.arange(len(E)) / fs
    best = (np.nan, 0.0)
    for st_db in edc_starts:
        for dur_db in edc_durations:
            i0 = int(np.argmin(np.abs(E - st_db)))
            i1 = int(np.argmin(np.abs(E - (st_db + dur_db))))
            if abs(i0 - i1) <= 1:
                continue
            lo, hi = min(i0, i1), max(i0, i1)
            res = scipy.stats.linregress(times[lo:hi], E[lo:hi])
            if abs(res.rvalue) > abs(best[1]):
                best = (-60.0 / (res.slope + eps), res.rvalue)
    return best


def check_rir_envelope(rir: np.ndarray, t60_specify: float, fs: int,
                       tol: float = 0.05) -> Tuple[bool, float]:
    """Validate simulated RIRs against the specified T60
    (reference utils_simu_rir_sig.py:526-540)."""
    t60s, corrs = [], []
    for m in range(rir.shape[1]):
        t60, corr = t60_from_rir(rir[0, m, :, 0], fs)
        t60s.append(t60)
        corrs.append(corr)
    t60_edc = float(np.mean(t60s))
    ok = abs(t60_edc - t60_specify) < tol and abs(corrs[-1]) > 0.5
    return bool(ok), t60_edc


def mean_absorption(room_sz, T60: float) -> float:
    """ABS = 0.161 V / (S * T60) (reference dataset.py:160-167 semantics)."""
    V = float(np.prod(room_sz))
    S = 2 * (room_sz[0] * room_sz[1] + room_sz[0] * room_sz[2]
             + room_sz[1] * room_sz[2])
    return 0.161 * V / (S * T60)


def annotate_scene(cfg: Dict, rir: np.ndarray, rir_dp: np.ndarray,
                   fs: int = 16000, c: float = 343.0) -> Dict:
    """Full annotation dict for a static single-source scene (scalars),
    matching the reference's saved ``*_info.npz`` fields."""
    tdoa = tdoa_from_geometry(cfg["src_traj_pts"], cfg["mic_pos"], c)
    room_sz = np.asarray(cfg["room_sz"], float)
    annos = {
        "TDOA": np.float32(tdoa[0, 0, 0]),
        "DRR": np.float16(drr(rir, rir_dp, fs)[0, 0]),
        "C50": np.float16(c50(rir, rir_dp, fs)[0, 0]),
        "C80": np.float16(c80(rir, rir_dp, fs)[0, 0]),
        "DOA": np.float32(doa_from_geometry(cfg["src_traj_pts"],
                                            cfg["array_pos"])[0, 1, 0]),
        "SUR": np.float32(2 * (room_sz[0] * room_sz[1]
                               + room_sz[0] * room_sz[2]
                               + room_sz[1] * room_sz[2])),
        "VOL": np.float32(np.prod(room_sz)),
    }
    if "T60_edc" in cfg:
        annos["T60"] = np.float32(cfg["T60_edc"])
        annos["ABS"] = np.float32(mean_absorption(cfg["room_sz"],
                                                  cfg["T60_edc"]))
    return annos


def mic_vad_dp_ratio(mic_sig: np.ndarray, mic_sig_dp: np.ndarray,
                     fs: int = 16000, win_s: float = 0.032,
                     eps: float = 1e-10) -> np.ndarray:
    """Frame-wise direct-path-to-mixture energy ratio as a soft VAD
    (reference 'dp_ratio' mode, utils_simu_rir_sig.py:1026-1041): per 32-ms
    window, ratio of the direct-path signal energy (channel 0) to the full
    mixture energy, broadcast back to samples. Returns (nsample, nsrc)
    float16 — threshold at ~1e-6 for a binary decision."""
    sig = np.asarray(mic_sig)
    dp = np.asarray(mic_sig_dp)
    if dp.ndim == 2:            # (nsample, nmic) single source
        dp = dp[:, :, None]
    nsample = sig.shape[0]
    nsrc = dp.shape[2]
    win = int(fs * win_s)
    nt = nsample // win
    out = np.zeros((nsample, nsrc), np.float32)
    for t in range(nt):
        st, ed = t * win, (t + 1) * win
        num = np.sum(dp[st:ed, 0, :] ** 2, axis=0)
        den = np.sum(sig[st:ed, 0] ** 2) + eps
        out[st:ed, :] = num[None, :] / den
    return out.astype(np.float16)
