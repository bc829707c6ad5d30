"""End-to-end microphone-signal synthesis for one acoustic scene (the port's
own copy of ``sarssl_tpu/data/scene.py``: the same rng call sequence, so a
seed gives both packages the same item).

Pipeline (mirrors reference ``MicrophoneSignalOrRIR.generate_microphone_signal``,
``data_generation/utils_simu_rir_sig.py:749-861``):
regenerate-until-valid RIR (nan/inf/zero + T60-EDC envelope checks), source
convolution, diffuse noise at a random SNR vs direct-path power, 0.9 peak
normalization, and TDOA/DRR/C50/T60/ABS annotations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import ism, noise as noise_mod
from .annotations import annotate_scene, check_rir_envelope
from .rooms import AcousticSamplerConfig, sample_acoustic_scene


def check_rir(rir: np.ndarray) -> bool:
    return (np.isfinite(rir).all() and float(np.sum(rir ** 2)) != 0.0)


@dataclass
class SceneSynthesizer:
    cfg: AcousticSamplerConfig = field(default_factory=AcousticSamplerConfig)
    T: float = 4.112
    snr_range: Tuple[float, float] = (15.0, 30.0)
    noise_type: str = "diffuse_white"  # + 'spatial_white' | 'diffuse_babble'
    # | 'diffuse_xsrc' | 'real_world' | '' (utils_noise.py:39-140)
    max_regen: int = 10
    # 'diffuse_babble': callable(rng) -> single-channel speech for babble
    babble_sampler: Optional[Callable] = None
    # 'diffuse_xsrc' / 'real_world': wav paths sampled uniformly
    noise_paths: Tuple[str, ...] = ()
    mic_vad: Optional[str] = None  # 'dp_ratio' adds annos['mic_vad_src']
    # (utils_simu_rir_sig.py:1026-1041; 'src_webrtc' needs webrtcvad, which
    # neither package depends on)
    ism_impl: str = "native"  # the RIRs' image loop: 'native' (C++) | 'numpy'

    def _valid_rir(self, rng: np.random.Generator,
                   scene_cfg: Optional[Dict] = None):
        """Regenerate-until-valid RIR + direct-path RIR. Returns
        (cfg, rir, rir_dp); cfg gains 'T60_edc'. The rng call sequence is
        exactly the one ``generate`` always made (byte-determinism of
        existing corpora is pinned by test)."""
        fs, c = self.cfg.fs, self.cfg.c
        for attempt in range(self.max_regen):
            cfg = scene_cfg or sample_acoustic_scene(rng, self.cfg)
            rir = ism.simulate_rir(cfg["room_sz"], cfg["beta"],
                                   cfg["src_traj_pts"], cfg["mic_pos"], fs,
                                   cfg["T60_sabine"], c, self.cfg.ism_db,
                                   rng=rng, impl=self.ism_impl)
            rir_dp = ism.simulate_rir(cfg["room_sz"], cfg["beta"],
                                      cfg["src_traj_pts"], cfg["mic_pos"], fs,
                                      cfg["T60_sabine"], c, self.cfg.ism_db,
                                      dp_only=True, rng=rng,
                                      impl=self.ism_impl)
            if not (check_rir(rir) and check_rir(rir_dp)):
                scene_cfg = None
                continue
            ok, t60_edc = check_rir_envelope(rir, cfg["T60_specify"], fs)
            if ok:
                break
            scene_cfg = None
        else:
            raise RuntimeError("could not generate a valid RIR")
        cfg["T60_edc"] = t60_edc
        return cfg, rir, rir_dp

    def generate_rir(self, seed: int,
                     scene_cfg: Optional[Dict] = None) -> Tuple[np.ndarray, Dict]:
        """RIR-only generation (reference gen_simu 'rir' mode): returns
        (rir (npt, nmic, nsamp, nsrc) float32 — the reference
        simulateRIR layout — , info) where info carries the direct-path RIR
        ('rir_dp', same layout), geometry and the source-independent
        annotations (T60/DRR/C50/ABS/TDOA/DOA...)."""
        rng = np.random.default_rng(seed)
        fs, c = self.cfg.fs, self.cfg.c
        cfg, rir, rir_dp = self._valid_rir(rng, scene_cfg)
        annos = annotate_scene(cfg, rir, rir_dp, fs, c)
        info = {"rir_dp": rir_dp.astype(np.float32), "fs": np.int32(fs),
                "T60_specify": cfg["T60_specify"],
                "T60_sabine": cfg["T60_sabine"], "T60_edc": cfg["T60_edc"],
                "room_sz": np.asarray(cfg["room_sz"], np.float32),
                "mic_pos": cfg["mic_pos"].astype(np.float32),
                "array_pos": cfg["array_pos"].astype(np.float32),
                "src_traj_pts": cfg["src_traj_pts"].astype(np.float32),
                **annos}
        return rir.astype(np.float32), info

    def generate(self, seed: int,
                 source_fn: Optional[Callable[[np.random.Generator, int], np.ndarray]] = None,
                 scene_cfg: Optional[Dict] = None) -> Tuple[np.ndarray, Dict]:
        """Returns (mic_sig (nsample, nmic) float32, info dict incl. annos).

        source_fn(rng, nsample) -> (nsample, nsrc) source waveforms; defaults
        to AR-colored Gaussian noise (a WSJ0 reader can be plugged in).
        """
        rng = np.random.default_rng(seed)
        fs, c = self.cfg.fs, self.cfg.c
        nsample = int(self.T * fs)

        cfg, rir, rir_dp = self._valid_rir(rng, scene_cfg)
        t60_edc = cfg["T60_edc"]

        nsrc = cfg["src_traj_pts"].shape[-1]
        if source_fn is None:
            source_fn = _default_source
        src = source_fn(rng, nsample)
        if src.shape[1] < nsrc:
            # draw independent extra sources rather than silently synthesizing
            # fewer sources than the scene's annotations declare
            extra = [source_fn(rng, nsample)[:, :1]
                     for _ in range(nsrc - src.shape[1])]
            src = np.concatenate([src] + extra, axis=1)
        src = src[:, :nsrc]

        mic_clean, _ = ism.rir_conv_src(rir, src, fs)
        mic_dp, _ = ism.rir_conv_src(rir_dp, src, fs)

        nmic = cfg["mic_pos"].shape[0]
        if self.noise_type == "diffuse_white":
            noi = noise_mod.diffuse_noise(rng, nsample, cfg["mic_pos"], fs, c)
        elif self.noise_type == "spatial_white":
            noi = noise_mod.spatial_white(rng, nsample, nmic)
        elif self.noise_type == "diffuse_babble":
            sampler = self.babble_sampler or (
                lambda r: _default_source(r, nsample)[:, 0])
            noi = noise_mod.babble_noise(rng, nsample, cfg["mic_pos"], fs,
                                         sampler)
        elif self.noise_type in ("diffuse_xsrc", "real_world"):
            assert self.noise_paths, f"{self.noise_type} noise needs wav paths"
            # ranged read: decode only the needed stretch of (potentially
            # hours-long) noise recordings, not the whole file
            from .wavio import audio_info, read_audio
            paths = self.noise_paths
            if self.noise_type == "real_world":
                # only recordings whose channel count matches the array
                if not hasattr(self, "_rw_paths"):
                    self._rw_paths = {}
                if nmic not in self._rw_paths:
                    self._rw_paths[nmic] = tuple(
                        p for p in self.noise_paths
                        if audio_info(p).channels == nmic)
                paths = self._rw_paths[nmic]
                assert paths, (f"no {nmic}-channel recordings among "
                               f"{len(self.noise_paths)} noise paths for "
                               f"real_world noise")
            path = paths[int(rng.integers(len(paths)))]
            info = audio_info(path)
            rec_fs = info.fs
            need = -(-nsample * rec_fs // fs)
            if self.noise_type == "diffuse_xsrc":
                need *= nmic
            st = (int(rng.integers(0, info.frames - need))
                  if info.frames > need else 0)
            rec, _ = read_audio(path, st, min(st + need, info.frames))
            if self.noise_type == "diffuse_xsrc":
                noi = noise_mod.xsrc_noise(rng, nsample, cfg["mic_pos"], fs,
                                           rec[:, 0], rec_fs, c)
            else:
                noi = noise_mod.real_world_noise(rng, nsample, nmic, rec,
                                                 rec_fs, fs)
        elif self.noise_type == "":
            noi = np.zeros((nsample, nmic))
        else:
            raise ValueError(self.noise_type)
        snr = rng.uniform(*self.snr_range)
        mic_sig = noise_mod.add_noise(mic_clean, noi, snr, mic_sig_dp=mic_dp)

        peak = max(np.abs(mic_sig).max(), np.abs(mic_dp).max(), 1e-9)
        mic_sig = (mic_sig / peak * 0.9).astype(np.float32)
        mic_dp = (mic_dp / peak * 0.9).astype(np.float32)

        annos = annotate_scene(cfg, rir, rir_dp, fs, c)
        if self.mic_vad == "dp_ratio":
            from .annotations import mic_vad_dp_ratio
            annos["mic_vad_src"] = mic_vad_dp_ratio(mic_sig, mic_dp, fs)
        elif self.mic_vad == "src_energy":
            # the reference's 'src_webrtc' pipeline (utils_simu_rir_sig.py
            # :1043-1052) with the webrtcvad detector (not a dependency)
            # replaced by a frame-energy detector: per-source
            # VAD track convolved through the direct-path RIR, thresholded
            # at mean > max * 1e-3 per sample.
            win = int(fs * 0.030)
            vads = []
            for s_idx in range(src.shape[1]):
                ssig = src[:, s_idx]
                nfr = len(ssig) // win
                e = np.mean(ssig[: nfr * win].reshape(nfr, win) ** 2, axis=1)
                edb = 10 * np.log10(e + 1e-12)
                frame_vad = (edb > edb.max() - 40.0).astype(np.float32)
                track = np.repeat(frame_vad, win)
                track = np.pad(track, (0, nsample - len(track)))
                conv, _ = ism.rir_conv_src(
                    rir_dp[..., s_idx:s_idx + 1], track[:, None], fs)
                # threshold on magnitude: fractional-delay sinc sidelobes
                # make RIR taps signed, and a signed mean can flip near the
                # threshold on cancellation rather than on activity
                mag = np.abs(conv[:nsample])
                vads.append(mag.mean(axis=1) > mag.max() * 1e-3)
            annos["mic_vad_src"] = np.stack(vads, axis=1).astype(bool)
        elif self.mic_vad:
            raise ValueError(f"unsupported mic_vad mode: {self.mic_vad} "
                             f"(use 'dp_ratio' or 'src_energy'; the "
                             f"reference's 'src_webrtc' needs webrtcvad)")
        info = {"SNR": np.float32(snr), "T60_specify": cfg["T60_specify"],
                "T60_sabine": cfg["T60_sabine"], "T60_edc": t60_edc,
                "room_sz": np.asarray(cfg["room_sz"], np.float32),
                "mic_pos": cfg["mic_pos"].astype(np.float32),
                "array_pos": cfg["array_pos"].astype(np.float32),
                "src_traj_pts": cfg["src_traj_pts"].astype(np.float32),
                **annos}
        return mic_sig, {"mic_sig_dp": mic_dp, **info}


def _default_source(rng: np.random.Generator, nsample: int) -> np.ndarray:
    """AR(1)-colored Gaussian 'speech-like' source."""
    x = rng.standard_normal((nsample, 1)).astype(np.float32)
    for _ in range(2):
        x[1:] += 0.8 * x[:-1]
    # slow amplitude modulation approximating speech energy contours
    t = np.arange(nsample) / nsample
    env = 0.4 + 0.6 * (0.5 + 0.5 * np.sin(2 * np.pi * (3 * t + rng.random())))
    return (x * env[:, None]).astype(np.float32)
