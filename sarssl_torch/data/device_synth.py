"""On-card training-pair synthesis (port of ``sarssl_tpu/data/device_synth.py``,
in PyTorch on the device the generator lives on).

Each 2-mic pair comes from a random shoebox room, mic pair and source:

  1. the image set (Allen-Berkley, per-axis order ``img_order``, padded to a
     static count) in closed form: positions, per-image reflection
     amplitudes, exact fractional delays;
  2. the images binned by STFT frame of arrival into a convolutive transfer
     function H(m, j, f): frame j holds the images whose delay rounds to
     j*hop samples, each with its exact within-frame residual phase; beyond
     the order's coverage a stochastic Sabine tail, per-frame Gaussian H
     under the 10^(-3 (t - T_img)/T60) envelope, power-matched to the
     computed part at the boundary (the diffuse-tail model of ``ism.py``);
  3. a speech-like source spectrogram (coloured noise with a slow energy
     envelope), convolved along frames with H by FFT, the ISTFT, white noise
     at a random SNR, and peak normalisation.

Randomness is split from arithmetic. ``draw_inputs`` takes every random
input of a batch from one ``torch.Generator`` (room, T60, mic centre /
distance / angle, source position, tail noise, source spectrogram, envelope
phase, SNR, white noise); ``synth_pair`` is a deterministic function of those
draws, batched over a leading dimension. The JAX package draws from keys, so
the two packages' samples differ by design; handed the same draws, the
deterministic parts agree (the tests rebuild JAX's draws from its keys).
The same generator seed gives the same batch bit for bit: the images are
accumulated into the frames by a one-hot matmul per chunk, never by an
atomic scatter whose order varies from run to run. Every constant is built on
the device (a host copy would wait for the card's queue to drain).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..ops.stft import istft
from ..utils.device import resolve_device

_CHUNK = 512  # images per accumulation chunk (bounds the live intermediate)


@dataclass(frozen=True)
class DeviceSynthConfig:
    nsample: int = 16640
    fs: int = 16000
    nfft: int = 512
    hop: int = 256
    c: float = 343.0
    room_lo: Tuple[float, float, float] = (4.0, 4.0, 2.5)
    room_hi: Tuple[float, float, float] = (10.0, 8.0, 4.0)
    t60_range: Tuple[float, float] = (0.2, 1.0)
    mic_dist_range: Tuple[float, float] = (0.03, 0.20)
    snr_range: Tuple[float, float] = (15.0, 30.0)
    # per-axis image order: n in [-N, N] with both wall parities. (3, 3, 4)
    # covers >= 40 ms of exact early reflections in the smallest rooms while
    # keeping the padded image count at 14*14*18 = 3528.
    img_order: Tuple[int, int, int] = (3, 3, 4)

    @property
    def nf(self) -> int:
        return self.nfft // 2 + 1

    @property
    def nt(self) -> int:
        # frames so that after cropping one window from each edge (where the
        # synthesis-window envelope is near zero) nsample samples remain
        return (self.nsample + 2 * self.nfft - self.nfft) // self.hop + 1 + 2

    @property
    def n_rir_frames(self) -> int:
        """Static CTF length: frames to the 40 dB point of the longest T60
        (gpuRIR's att_max_db, reference utils_simu_rir_sig.py:479)."""
        tmax = 40.0 / 60.0 * self.t60_range[1]
        return int(math.ceil(tmax * self.fs / self.hop)) + 1

    @property
    def n_images(self) -> int:
        k = 1
        for o in self.img_order:
            k *= 2 * (2 * o + 1)
        return k


def _uniform(gen, shape, lo, hi, device):
    # JAX's uniform: u * (hi - lo) + lo, u in [0, 1)
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def draw_inputs(gen: torch.Generator, nb: int,
                cfg: DeviceSynthConfig = DeviceSynthConfig()) -> Dict[str, torch.Tensor]:
    """Every random input of ``nb`` pairs, drawn from ``gen`` on its device
    (f32): room (nb, 3), t60, center_u (nb, 3) in [0.35, 0.65), mic_dist,
    theta, src_u (nb, 3) in [0.2, 0.8), tail_re / tail_im (nb, 2, J, nf) and
    spec_re / spec_im (nb, nf, nt) standard normal, env_u in [0, 1), snr,
    white (nb, nsample, 2) standard normal."""
    dev = gen.device
    J, nf, nt = cfg.n_rir_frames, cfg.nf, cfg.nt
    u = torch.rand((nb, 3), generator=gen, device=dev)
    room = torch.stack([u[:, i] * (cfg.room_hi[i] - cfg.room_lo[i]) + cfg.room_lo[i]
                        for i in range(3)], -1)
    d = {"room": room,
         "t60": _uniform(gen, (nb,), *cfg.t60_range, dev),
         "center_u": _uniform(gen, (nb, 3), 0.35, 0.65, dev),
         "mic_dist": _uniform(gen, (nb,), *cfg.mic_dist_range, dev),
         "theta": _uniform(gen, (nb,), 0.0, 2 * math.pi, dev),
         "src_u": _uniform(gen, (nb, 3), 0.2, 0.8, dev)}
    for name, shape in (("tail_re", (nb, 2, J, nf)), ("tail_im", (nb, 2, J, nf)),
                        ("spec_re", (nb, nf, nt)), ("spec_im", (nb, nf, nt))):
        d[name] = torch.randn(shape, generator=gen, device=dev)
    d["env_u"] = torch.rand((nb,), generator=gen, device=dev)
    d["snr"] = _uniform(gen, (nb,), *cfg.snr_range, dev)
    d["white"] = torch.randn((nb, cfg.nsample, 2), generator=gen, device=dev)
    return d


def _axis_images(L, s, b0, b1, order: int):
    """One axis's images of a batch: L, s, b0, b1 (nb,) -> coordinates and
    amplitudes (nb, 2 (2 order + 1)), n outer, wall parity q inner."""
    n = torch.arange(-order, order + 1, device=L.device)
    nn = n.repeat_interleave(2)
    qq = torch.arange(2, device=L.device).repeat(2 * order + 1)
    coord = 2.0 * nn * L[:, None] + (1 - 2 * qq) * s[:, None]
    amp = (b0[:, None] ** (nn - qq).abs()) * (b1[:, None] ** nn.abs())
    return coord, amp


def _images(room, src, beta, cfg: DeviceSynthConfig):
    """Image positions and amplitudes of a batch: (nb, K, 3) and (nb, K), the
    x index outermost and z innermost."""
    cx, ax = _axis_images(room[:, 0], src[:, 0], beta[:, 0], beta[:, 1], cfg.img_order[0])
    cy, ay = _axis_images(room[:, 1], src[:, 1], beta[:, 2], beta[:, 3], cfg.img_order[1])
    cz, az = _axis_images(room[:, 2], src[:, 2], beta[:, 4], beta[:, 5], cfg.img_order[2])
    nb, kx, ky, kz = cx.shape[0], cx.shape[1], cy.shape[1], cz.shape[1]
    pos = torch.stack([cx[:, :, None, None].expand(nb, kx, ky, kz),
                       cy[:, None, :, None].expand(nb, kx, ky, kz),
                       cz[:, None, None, :].expand(nb, kx, ky, kz)], -1).reshape(nb, -1, 3)
    amp = (ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]).reshape(nb, -1)
    return pos, amp


def ctf_frames(tail_re, tail_im, room, t60, beta, mics, src,
               cfg: DeviceSynthConfig = DeviceSynthConfig()):
    """Convolutive transfer function of a batch of 2-mic scenes.

    room (nb, 3), t60 (nb,), beta (nb, 6), mics (nb, nmic, 3), src (nb, 3),
    the tail's standard normal draws (nb, nmic, J, nf). Returns H complex64
    ``(nb, nmic, J, nf)`` with J = cfg.n_rir_frames: frame j is the one-sided
    nfft-grid response of the RIR samples arriving in ``[(j-1/2) hop,
    (j+1/2) hop)``. Exact images up to ``T_img = min(Tdiff, coverage)``; a
    Sabine-envelope Gaussian tail beyond, power-matched at the boundary."""
    J, nf = cfg.n_rir_frames, cfg.nf
    nb, nmic = mics.shape[:2]
    dev = room.device
    pos, amp = _images(room, src, beta, cfg)
    K = pos.shape[1]
    pad = (-K) % _CHUNK
    pos = torch.cat([pos, src[:, None, :].expand(nb, pad, 3)], 1)
    amp = torch.cat([amp, amp.new_zeros(nb, pad)], 1)

    dists = (pos[:, None, :, :] - mics[:, :, None, :]).square().sum(-1).sqrt()
    tau = dists / cfg.c                                          # (nb, nmic, Kp)
    gains = amp[:, None, :] / (4 * math.pi * dists.clamp_min(0.1))

    # exact-image horizon: ISM until 12 dB decay (Tdiff), full ISM for short
    # RIRs, clipped to what the fixed order covers: order N spans
    # (N-1) * 2L / c per axis (gpuRIR's t2n)
    tmax = 40.0 / 60.0 * t60
    tdiff = torch.where(t60 < 0.15, tmax, 12.0 / 60.0 * t60)
    t_cov = torch.stack([(float(o) - 1.0) * 2.0 * room[:, i] / cfg.c
                         for i, o in enumerate(cfg.img_order)], -1).amin(-1)
    t_img = torch.minimum(tdiff, t_cov)                          # (nb,)

    jidx = torch.round(tau * cfg.fs / cfg.hop).to(torch.int32)
    resid = tau - jidx * (cfg.hop / cfg.fs)
    keep = (tau <= t_img[:, None, None]) & (jidx >= 0) & (jidx < J)
    g = torch.where(keep, gains, torch.zeros((), device=dev))

    f = torch.arange(nf, device=dev) * (cfg.fs / cfg.nfft)
    frames = torch.arange(J, device=dev, dtype=torch.float32)
    acc = torch.zeros(nb, nmic, J, 2 * nf, device=dev)
    for lo in range(0, K + pad, _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        ph = -2.0 * math.pi * f * resid[:, :, sl, None]           # (nb, m, C, nf)
        gc = g[:, :, sl, None]
        contrib = torch.cat([gc * torch.cos(ph), gc * torch.sin(ph)], -1)  # (nb, m, C, 2 nf)
        onehot = (jidx[:, :, sl, None].float() == frames).float()  # (nb, m, C, J)
        acc += torch.matmul(onehot.transpose(-1, -2), contrib)
    H = torch.complex(acc[..., :nf], acc[..., nf:])               # (nb, m, J, nf)

    # stochastic Sabine tail beyond the exact horizon: per-frame Gaussian
    # response whose power follows 10^(-6 (t-T_img)/T60), matched to the
    # computed part's energy in the last ~2 frames
    tc = frames * (cfg.hop / cfg.fs)                              # (J,)
    E = H.abs().square().mean(-1)                                 # (nb, m, J)
    ti = t_img[:, None]
    wb = ((tc > ti - 2.0 * cfg.hop / cfg.fs) & (tc <= ti)).float()  # (nb, J)
    ref_pow = (E * wb[:, None, :]).sum(-1) / wb.sum(-1).clamp_min(1.0)[:, None]  # (nb, m)
    tail_mask = ((tc > ti) & (tc <= tmax[:, None])).float()      # (nb, J)
    sigma = ref_pow.sqrt()[..., None] * 10.0 ** (-3.0 * (tc - ti) / t60[:, None])[:, None, :]
    noise = torch.complex(tail_re, tail_im) * math.sqrt(0.5)
    return H + (tail_mask[:, None, :] * sigma)[..., None] * noise


def _sample_scene(d, cfg: DeviceSynthConfig):
    """The scene of each pair from its draws: room (nb, 3), t60 (nb,), beta
    (nb, 6) (uniform absorption, Sabine inverse), mics (nb, 2, 3), src (nb, 3)
    (kept at least ~0.5 m off the array and 0.1 m off the walls)."""
    room, t60 = d["room"], d["t60"]
    V = room.prod(-1)
    S = 2 * (room[:, 0] * room[:, 1] + room[:, 0] * room[:, 2] + room[:, 1] * room[:, 2])
    alpha = (0.161 * V / (S * t60)).clamp(0.02, 0.95)
    beta = torch.sqrt(1.0 - alpha)[:, None].expand(-1, 6)

    center = room * d["center_u"]
    th = d["theta"]
    off = 0.5 * d["mic_dist"][:, None] * torch.stack(
        [torch.cos(th), torch.sin(th), torch.zeros_like(th)], -1)
    mics = torch.stack([center - off, center + off], 1)

    src = room * d["src_u"]
    delta = src - center
    dist = delta.square().sum(-1, keepdim=True).sqrt()
    src = center + delta / dist.clamp_min(1e-3) * dist.clamp_min(0.5)
    src = torch.minimum(torch.maximum(src, torch.full_like(src, 0.1)), room - 0.1)
    return room, t60, beta, mics, src


def synth_pair(d: Dict[str, torch.Tensor], cfg: DeviceSynthConfig = DeviceSynthConfig()):
    """The deterministic part of the synthesis, batched over the draws'
    leading dimension: ``(wave (nb, nsample, 2) f32, {"TDOA", "T60", "SNR"}
    each (nb,))``, on the draws' device."""
    room, t60, beta, mics, src = _sample_scene(d, cfg)
    H = ctf_frames(d["tail_re"], d["tail_im"], room, t60, beta, mics, src, cfg)  # (nb, 2, J, nf)
    dev = room.device

    # source spectrogram: coloured noise with a slow energy envelope
    nt, nf, J = cfg.nt, cfg.nf, cfg.n_rir_frames
    f = torch.arange(nf, device=dev) * (cfg.fs / cfg.nfft)
    color = 1.0 / torch.sqrt(1.0 + (f / 800.0) ** 2)
    lin = torch.linspace(0, 6 * math.pi, nt, device=dev)
    env_t = 0.4 + 0.6 * torch.sigmoid(3 * torch.sin(lin + d["env_u"][:, None] * 6.28))
    S = torch.complex(d["spec_re"], d["spec_im"]) * color[:, None] * env_t[:, None, :]

    # frame-domain convolution X[m, f, t] = sum_j H[m, j, f] S[f, t-j]
    L = nt + J
    Sf = torch.fft.fft(S, n=L, dim=-1)                            # (nb, nf, L)
    Hf = torch.fft.fft(H.transpose(-1, -2), n=L, dim=-1)          # (nb, 2, nf, L)
    X = torch.fft.ifft(Sf[:, None] * Hf, dim=-1)[..., :nt]        # (nb, 2, nf, nt)

    wave = istft(X.permute(0, 2, 3, 1), cfg.nfft, cfg.hop / cfg.nfft, cfg.nfft)  # (nb, ns, 2)
    # drop one window from each edge: the synthesis-window envelope is ~0
    # there and the division amplifies whatever the frames hold
    wave = wave[:, cfg.nfft: cfg.nfft + cfg.nsample]
    wave = torch.nn.functional.pad(wave, (0, 0, 0, cfg.nsample - wave.shape[1]))

    snr = d["snr"]
    sig_pow = wave.square().mean((1, 2))                          # per row
    wave = wave + d["white"] * torch.sqrt(sig_pow / 10 ** (snr / 10))[:, None, None]
    wave = wave / (wave.abs().amax((1, 2)) + 1e-6)[:, None, None] * 0.9

    d_direct = (src[:, None, :] - mics).square().sum(-1).sqrt()   # (nb, 2)
    tdoa = (d_direct[:, 1] - d_direct[:, 0]) / cfg.c
    return wave.float(), {"TDOA": tdoa.float(), "T60": t60.float(), "SNR": snr.float()}


def synth_batch_device(gen: torch.Generator, nb: int,
                       cfg: DeviceSynthConfig = DeviceSynthConfig(), device="cuda"):
    """``(wave (nb, nsample, 2) f32, {"TDOA", "T60", "SNR"} (nb,))`` on
    ``device``, drawn from ``gen``, which must live there. Runs on the card
    unless ``device="cpu"`` is asked for (and raises without one)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the synthesis on {dev}")
    return synth_pair(draw_inputs(gen, nb, cfg), cfg)
