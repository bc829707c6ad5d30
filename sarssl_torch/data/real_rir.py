"""Extracted real-RIR datasets and micsig synthesis from them (the port's own
copy of ``sarssl_tpu/data/real_rir.py``: an index gives the same item).

The reference extracts 2-channel RIR pairs from 6 public corpora into
``SP*_MP*-a-b.npy`` files plus matched noise wavs
(the reference's ``data_generation/gen_real_rir.py``) and then convolves
WSJ0 speech with them (gen_sig_from_real_rir.py). This module implements the
consumption side — the part the training workload needs:

  NpyRIRDataset          — reads extracted .npy RIRs (+ optional *_info.npz
                           and matched noise wavs);
  dp_from_rir            — direct-path approximation: +/-2.5 ms window around
                           the RIR peak (gen_sig_from_real_rir.py:269-283);
  MicSigFromRIRDataset   — per-index seeded speech x RIR (+noise) synthesis
                           with T60/DRR/C50/ABS annotations
                           (dataset.py:287-382).

Corpus-specific extractor CLIs (DCASE/MIR/MeshRIR/dEchorate/BUTReverb/ACE)
materialize these trees; see ``cli/gen_real_rir.py``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.signal import fftconvolve

from . import noise as noise_mod
from .annotations import t60_from_rir, drr, c50, mean_absorption
from .wavio import read_wav


def dp_from_rir(rir: np.ndarray, fs: int, half_ms: float = 2.5) -> np.ndarray:
    """Direct-path RIR: zero everything outside +/-half_ms around the peak.

    rir: (nsamp, nmic). Matches gen_sig_from_real_rir.py:269-283.
    """
    n0 = int(fs * half_ms / 1000)
    out = np.zeros_like(rir)
    for m in range(rir.shape[1]):
        peak = int(np.argmax(np.abs(rir[:, m])))
        lo, hi = max(peak - n0, 0), min(peak + n0 + 1, rir.shape[0])
        out[lo:hi, m] = rir[lo:hi, m]
    return out


class NpyRIRDataset:
    """Extracted real RIRs in the extractor schema: ``<room>/<array>/
    SP*_MP*.npy`` arrays of shape (npoints, nmic, nsample, nsources) — the
    reference writer's layout (gen_real_rir.py) — or legacy (nsamp, nmic).

    Matched noise is found by the ``MP<tag>-a-b`` token: any
    ``*_MP<tag>-a-b_<type>*.wav`` in the RIR's directory, or in a sibling
    tree whose top directory is ``<corpus>_noise`` (the reference splits RIR
    and noise trees that way, gen_sig_from_real_rir.py:104-112)."""

    def __init__(self, data_dir: str, fs: int = 16000,
                 rooms: Optional[List[str]] = None):
        self.fs = fs
        root = Path(data_dir)
        paths = sorted(p for p in root.rglob("*.npy")
                       if not p.name.endswith("_info.npy"))
        if rooms is not None:
            paths = [p for p in paths
                     if any(r in p.parts or r == p.parent.name for r in rooms)]
        assert paths, f"no RIR .npy files under {data_dir}"
        self._root = root
        self.paths = [str(p) for p in paths]
        self._noise_root = root.parent / (root.name + "_noise")

    def __len__(self):
        return len(self.paths)

    def _noise_candidates(self, path: str) -> List[str]:
        p = Path(path)
        mp = next((t for t in p.stem.split("_") if t.startswith("MP")), None)
        if mp is None:
            legacy = path.replace(".npy", "_noise.wav")
            return [legacy] if os.path.exists(legacy) else []
        dirs = [p.parent]
        if self._noise_root.is_dir():
            # mirror the room/array subpath under the sibling noise tree
            try:
                mirrored = self._noise_root / p.parent.relative_to(self._root)
                if mirrored.is_dir():
                    dirs.append(mirrored)
            except ValueError:
                pass
        out = []
        for d in dirs:
            out += [str(f) for f in sorted(Path(d).glob(f"*_{mp}_*.wav"))]
            legacy = Path(d) / (p.stem + "_noise.wav")
            if legacy.exists():
                out.append(str(legacy))
        return out

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        path = self.paths[idx]
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 4:          # (npoints, nmic, nsample, nsources)
            rir = arr[0, :, :, 0].T
        elif arr.ndim == 1:
            rir = arr[:, None]
        else:
            rir = arr
        info: Dict = {}
        info_path = path.replace(".npy", "_info.npz")
        if os.path.exists(info_path):
            info = dict(np.load(info_path, allow_pickle=True))
        src_fs = int(info.get("fs", self.fs))
        if src_fs != self.fs:
            import scipy.signal
            rir = scipy.signal.resample_poly(rir, self.fs, src_fs, axis=0)
        cands = self._noise_candidates(path)
        noise = None
        if cands:
            pick = cands[0] if rng is None else cands[int(rng.integers(len(cands)))]
            noise, noise_fs = read_wav(pick)
            if noise_fs != self.fs:
                import scipy.signal
                noise = scipy.signal.resample_poly(noise, self.fs, noise_fs,
                                                   axis=0)
        return rir, info, noise

    def __getitem__(self, idx: int):
        return self.get(idx)


class SimRIRDataset:
    """Pre-generated *simulated* RIR tree (``gen_simu --mode rir``):
    ``{idx}_rir.npy`` in the reference 4-D layout (npt, nmic, nsamp, nsrc)
    (or legacy 2-D (nsamp, nmic)) + ``{idx}_rir_info.npz`` with the exact
    direct-path RIR ('rir_dp'), geometry and annotations — the reference's
    simu_dataset.RIRDataset side of RandomMicSigFromRIRDataset
    (dataset.py:336-356). Speaks the same ``.get`` protocol as
    NpyRIRDataset (recorded noise is always None)."""

    def __init__(self, data_dir: str, fs: int = 16000):
        self.fs = fs
        self.paths = sorted(str(p) for p in Path(data_dir).rglob("*_rir.npy"))
        assert self.paths, f"no *_rir.npy files under {data_dir}"

    def __len__(self):
        return len(self.paths)

    @staticmethod
    def _to_2d(arr: np.ndarray) -> np.ndarray:
        """(npt, nmic, nsamp, nsrc) reference layout (or legacy 2-D) ->
        (nsamp, nmic), first trajectory point / first source."""
        if arr.ndim == 4:
            return arr[0, :, :, 0].T
        assert arr.ndim == 2, (
            f"RIR array must be 4-D (npt, nmic, nsamp, nsrc) or 2-D "
            f"(nsamp, nmic); got shape {arr.shape}")
        return arr

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        path = self.paths[idx]
        rir = self._to_2d(np.load(path).astype(np.float32))
        info_path = path.replace("_rir.npy", "_rir_info.npz")
        info: Dict = {}
        if os.path.exists(info_path):
            info = dict(np.load(info_path, allow_pickle=True))
        if "rir_dp" in info:
            info["rir_dp"] = self._to_2d(np.asarray(info["rir_dp"],
                                                    np.float32))
        src_fs = int(info.get("fs", self.fs))
        if src_fs != self.fs:
            import scipy.signal
            rir = scipy.signal.resample_poly(rir, self.fs, src_fs, axis=0)
            if "rir_dp" in info:
                info["rir_dp"] = scipy.signal.resample_poly(
                    info["rir_dp"], self.fs, src_fs, axis=0)
        return rir, info, None

    def __getitem__(self, idx: int):
        return self.get(idx)


class MicSigFromRIRDataset:
    """On-the-fly speech x RIR synthesis with annotations.

    Matches the reference RandomMicSigFromRIRDataset semantics
    (dataset.py:287-382): per-index seeding, random RIR + random source,
    matched recorded noise when present (else the ``noise_type`` generator,
    the reference sim arm's diffuse_white NoiseSignal), SNR in snr_range vs
    direct-path power, peak norm x0.9, and {T60, DRR, C50, ABS} annotations
    computed from the RIR. Works with real (NpyRIRDataset) and simulated
    (SimRIRDataset) RIR sources; an exact 'rir_dp' in the RIR info replaces
    the +/-2.5 ms peak-window approximation.
    """

    def __init__(self, rir_dataset, source_dataset,
                 T: float = 4.112, fs: int = 16000,
                 snr_range: Tuple[float, float] = (15.0, 30.0),
                 seed: int = 1, length: int = 10000,
                 room_sz_for_abs: Optional[np.ndarray] = None,
                 noise_type: str = ""):
        self.rirs = rir_dataset
        self.sources = source_dataset
        self.T = T
        self.fs = fs
        self.snr_range = snr_range
        self.seed = seed
        self.length = length
        self.room_sz_for_abs = room_sz_for_abs
        self.noise_type = noise_type  # '' | 'diffuse_white' | 'spatial_white'

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed + idx)
        nsample = int(self.T * self.fs)
        ridx = int(rng.integers(len(self.rirs)))
        if hasattr(self.rirs, "get"):
            rir, info, rec_noise = self.rirs.get(ridx, rng)
        else:
            rir, info, rec_noise = self.rirs[ridx]
        src = self.sources.sample(rng)[:, 0]

        dp_rir = info.get("rir_dp")
        dp_rir = (np.asarray(dp_rir, np.float32) if dp_rir is not None
                  else dp_from_rir(rir, self.fs))
        mic = fftconvolve(src[:, None], rir, axes=0)[:nsample]
        dp = fftconvolve(src[:, None], dp_rir, axes=0)[:nsample]

        if rec_noise is not None and rec_noise.shape[0] >= nsample:
            st = int(rng.integers(0, rec_noise.shape[0] - nsample + 1))
            noi = rec_noise[st: st + nsample, : mic.shape[1]]
        elif self.noise_type == "diffuse_white" and "mic_pos" in info:
            noi = noise_mod.diffuse_noise(rng, nsample,
                                          np.asarray(info["mic_pos"]),
                                          self.fs)
        elif self.noise_type in ("diffuse_white", "spatial_white"):
            noi = noise_mod.spatial_white(rng, nsample, mic.shape[1])
        else:
            noi = np.zeros_like(mic)
        snr = float(rng.uniform(*self.snr_range))
        if noi.any():
            mic = noise_mod.add_noise(mic, noi, snr, mic_sig_dp=dp)

        peak = max(np.abs(mic).max(), 1e-9)
        mic = (mic / peak * 0.9).astype(np.float32)

        rir4 = rir.T[None, :, :, None]  # (1, nmic, nsamp, 1)
        dp4 = dp_rir.T[None, :, :, None]
        t60, _ = t60_from_rir(rir[:, 0], self.fs)
        annos = {
            "T60": np.float32(info.get("T60_edc", info.get("T60", t60))),
            "DRR": np.float32(drr(rir4, dp4, self.fs)[0, 0]),
            "C50": np.float32(c50(rir4, dp4, self.fs)[0, 0]),
            "TDOA": np.float32(np.ravel(info["TDOA"])[0]
                               if "TDOA" in info else np.nan),
            "SNR": np.float32(snr),
        }
        room_sz = info.get("room_sz", self.room_sz_for_abs)
        annos["ABS"] = (np.float32(mean_absorption(room_sz, annos["T60"]))
                        if room_sz is not None else np.float32(np.nan))
        return mic, annos
