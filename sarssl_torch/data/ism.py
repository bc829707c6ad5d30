"""Image-source room impulse response engine (gpuRIR replacement; the port's
own copy of ``sarssl_tpu/data/ism.py``).

The reference delegates RIR synthesis to the external CUDA library gpuRIR
(``data_generation/utils_simu_rir_sig.py:475-508``):
ISM until the RIR decays ``ism_db`` (12 dB), a stochastic diffuse tail until
40 dB, ``Tdiff = Tmax`` for T60 < 0.15 s, and a direct-path-only variant with
``nb_img = [1,1,1]``.

This module re-implements that contract:
  * Allen-Berkley image enumeration with per-wall reflection coefficients
    ``beta = [bx0, bx1, by0, by1, bz0, bz1]``; per-axis image at
    ``2 n L + (1-2q) s`` with amplitude ``b0^|n-q| * b1^|n|``;
  * band-limited fractional-delay taps (windowed sinc, 16 taps) accumulated
    with a vectorized scatter-add;
  * diffuse tail: Gaussian noise under the Sabine exponential envelope,
    power-matched to the ISM segment at ``Tdiff``;
  * 1/(4*pi*dist) spherical spreading, omni pickup.

The image accumulation runs in the C++/OpenMP core (``csrc/ism.cpp``, built
at first use by ``native.py``; a failed build raises) unless the caller asks
for ``impl="numpy"``, the plain version the tests hold it against.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

_SINC_HALF = 8  # taps on each side of the fractional delay


def att2t_sabine(att_db: float, T60: float) -> float:
    """Time for the RIR to decay ``att_db`` dB under the Sabine model
    (gpuRIR.att2t_SabineEstimator semantics)."""
    return att_db / 60.0 * T60


def t2n(T: float, room_sz, c: float = 343.0) -> np.ndarray:
    """Images needed per axis to cover propagation time T."""
    room_sz = np.asarray(room_sz, np.float64)
    return np.ceil(T * c / (2.0 * room_sz)).astype(int) + 1


def _image_grid(n_max: int):
    """(2*n_max+1)*2 images per axis: (n, q) pairs."""
    n = np.arange(-n_max, n_max + 1)
    q = np.array([0, 1])
    nn, qq = np.meshgrid(n, q, indexing="ij")
    return nn.ravel(), qq.ravel()


def _axis_images(L: float, s: float, b0: float, b1: float, n_max: int):
    nn, qq = _image_grid(n_max)
    coords = 2.0 * nn * L + (1 - 2 * qq) * s
    amps = (b0 ** np.abs(nn - qq)) * (b1 ** np.abs(nn))
    return coords, amps


def _place_taps(rir: np.ndarray, times: np.ndarray, amps: np.ndarray, fs: int):
    """Accumulate windowed-sinc taps at fractional sample positions."""
    nsamp = rir.shape[-1]
    t0 = times * fs
    base = np.floor(t0).astype(np.int64)
    frac = t0 - base
    k = np.arange(-_SINC_HALF + 1, _SINC_HALF + 1)  # 16 taps
    # windowed sinc centered at frac
    arg = k[None, :] - frac[:, None]
    win = 0.5 * (1.0 + np.cos(np.pi * arg / _SINC_HALF))
    taps = np.sinc(arg) * win * amps[:, None]
    idx = base[:, None] + k[None, :]
    valid = (idx >= 0) & (idx < nsamp)
    np.add.at(rir, idx[valid], taps[valid])
    return rir


def simulate_rir_single(room_sz, beta, src_pos, mic_pos, fs: int,
                        T60: float, c: float = 343.0, ism_db: float = 12.0,
                        att_max_db: float = 40.0, dp_only: bool = False,
                        rng: Optional[np.random.Generator] = None,
                        impl: str = "native") -> np.ndarray:
    """RIR for one static source. Returns (nmic, nsamples) float32.

    impl: ``"native"`` (the C++ core) or ``"numpy"`` (its plain version)."""
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl must be 'native' or 'numpy', not {impl!r}")
    room_sz = np.asarray(room_sz, np.float64)
    beta = np.asarray(beta, np.float64)
    src = np.asarray(src_pos, np.float64)
    mics = np.atleast_2d(np.asarray(mic_pos, np.float64))
    nmic = mics.shape[0]

    if dp_only or T60 == 0:
        Tmax = 0.1
        nsamp = int(math.ceil(Tmax * fs))
        rir = np.zeros((nmic, nsamp), np.float64)
        for m in range(nmic):
            dist = float(np.linalg.norm(src - mics[m]))
            _place_taps(rir[m], np.array([dist / c]),
                        np.array([1.0 / (4 * np.pi * max(dist, 1e-2))]), fs)
        return rir.astype(np.float32)

    Tdiff = att2t_sabine(ism_db, T60)
    Tmax = att2t_sabine(att_max_db, T60)
    if T60 < 0.15:
        Tdiff = Tmax  # full ISM for short RIRs (ref :485)
    nsamp = int(math.ceil(Tmax * fs))
    n_per_axis = t2n(Tdiff, room_sz, c)

    cx, ax = _axis_images(room_sz[0], src[0], beta[0], beta[1], n_per_axis[0])
    cy, ay = _axis_images(room_sz[1], src[1], beta[2], beta[3], n_per_axis[1])
    cz, az = _axis_images(room_sz[2], src[2], beta[4], beta[5], n_per_axis[2])

    t_lim = Tdiff + _SINC_HALF / fs
    if impl == "native":
        from . import native
        rir = native.ism_core(cx, ax, cy, ay, cz, az, mics, nsamp, fs, c, t_lim)
    else:
        rir = np.zeros((nmic, nsamp), np.float64)
        pos = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        amp = (ax[:, None, None] * ay[None, :, None] * az[None, None, :]).ravel()
        for m in range(nmic):
            d = np.linalg.norm(pos - mics[m], axis=1)
            t = d / c
            sel = t <= t_lim
            _place_taps(rir[m], t[sel],
                        amp[sel] / (4 * np.pi * np.maximum(d[sel], 1e-2)), fs)

    # diffuse tail (power-matched exponential-envelope noise, ref gpuRIR model)
    if Tdiff < Tmax:
        rng = rng or np.random.default_rng(
            int(abs(src).sum() * 1e6) % (2 ** 31))
        n_diff = int(Tdiff * fs)
        w = max(int(0.01 * fs), 8)
        ref_pow = float(np.mean(rir[:, max(n_diff - w, 0):n_diff] ** 2))
        t = np.arange(n_diff, nsamp) / fs
        env = np.sqrt(ref_pow) * 10 ** (-3.0 * (t - Tdiff) / T60)
        noise = rng.standard_normal((rir.shape[0], nsamp - n_diff))
        rir[:, n_diff:] += noise * env[None, :]

    return rir.astype(np.float32)


def simulate_rir(room_sz, beta, src_traj_pts, mic_pos, fs: int, T60: float,
                 c: float = 343.0, ism_db: float = 12.0,
                 dp_only: bool = False,
                 rng: Optional[np.random.Generator] = None,
                 impl: str = "native") -> np.ndarray:
    """RIRs for a source trajectory. Returns (npt, nmic, nsamples, nsrc),
    matching the reference layout (utils_simu_rir_sig.py:505-508)."""
    traj = np.asarray(src_traj_pts, np.float64)
    if traj.ndim == 2:
        traj = traj[:, :, None]
    npt, _, nsrc = traj.shape
    out = []
    for s in range(nsrc):
        per_pt = [simulate_rir_single(room_sz, beta, traj[p, :, s], mic_pos,
                                      fs, T60, c, ism_db, dp_only=dp_only,
                                      rng=rng, impl=impl)
                  for p in range(npt)]
        out.append(np.stack(per_pt))  # (npt, nmic, nsamp)
    return np.stack(out, axis=-1)


def rir_conv_src(rir: np.ndarray, src_sig: np.ndarray, fs: int = 16000):
    """Convolve sources with (static) RIRs.

    rir: (npt, nmic, nsamp, nsrc); src_sig: (nsample, nsrc).
    Returns (mic_sig (nsample, nmic), per-source (nsample, nmic, nsrc)).
    Matches reference rir_conv_src static path (utils_simu_rir_sig.py:616-663).
    """
    from scipy.signal import fftconvolve

    nsample, nsrc = src_sig.shape
    per_src = []
    for s in range(nsrc):
        if rir.shape[0] == 1:
            h = rir[0, :, :, s].T  # (nsamp, nmic)
            y = fftconvolve(src_sig[:, s][:, None], h, axes=0)[:nsample]
        else:
            y = _conv_trajectory(rir[:, :, :, s], src_sig[:, s])
        per_src.append(y)
    per_src = np.stack(per_src, axis=-1)
    return per_src.sum(axis=-1), per_src


def _conv_trajectory(rirs: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Moving-source convolution by linear crossfade between per-point RIR
    convolutions (the gpuRIR.simulateTrajectory model the reference calls for
    moving sources, utils_simu_rir_sig.py:636-641).

    rirs: (npt, nmic, nsamp); src: (nsample,). Returns (nsample, nmic).
    """
    from scipy.signal import fftconvolve as _fc

    npt = rirs.shape[0]
    nsample = src.shape[0]
    t = np.arange(nsample)
    # trajectory point k is centered at sample k * nsample / npt
    pos = t * npt / nsample  # fractional trajectory index per sample
    lo = np.clip(np.floor(pos).astype(int), 0, npt - 1)
    hi = np.clip(lo + 1, 0, npt - 1)
    w_hi = (pos - lo).astype(np.float64)[:, None]
    ys = np.stack([_fc(src[:, None], rirs[k].T, axes=0)[:nsample]
                   for k in range(npt)])  # (npt, nsample, nmic)
    out = ys[lo, t] * (1.0 - w_hi) + ys[hi, t] * w_hi
    return out
