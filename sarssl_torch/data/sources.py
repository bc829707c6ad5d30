"""Source-speech corpora readers (WSJ0-style speaker trees; the port's own
copy of ``sarssl_tpu/data/sources.py``: the same draws give the same
signals).

Equivalent of reference utils_src.py: walk a speaker-subdirectory tree of
wavs, draw a random utterance, and pad to the requested duration with more
utterances from the same speaker, removing the mean
(utils_src.py:65-122). The LibriSpeech variant optionally drops silent
stretches (webrtcvad when installed, else an energy gate).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import scipy.signal

from .wavio import read_wav


def remove_silence(sig: np.ndarray, fs: int, frame_ms: float = 30.0,
                   rel_threshold: float = 0.02,
                   min_keep_ratio: float = 0.1) -> np.ndarray:
    """Drop silent frames from an utterance, LibriSpeech-cleaning style
    (reference utils_src.py:125-231 uses webrtcvad frame decisions; this is
    the energy-gate equivalent for environments without it: 30-ms frames
    whose RMS falls below ``rel_threshold`` x the utterance's active RMS are
    removed, unless that would delete almost everything)."""
    n = int(fs * frame_ms / 1000)
    nt = len(sig) // n
    if nt == 0:
        return sig
    frames = sig[: nt * n].reshape(nt, n)
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    ref = np.percentile(rms, 90) + 1e-12
    keep = rms >= rel_threshold * ref
    if keep.sum() < max(1, int(min_keep_ratio * nt)):
        return sig
    out = frames[keep].reshape(-1)
    tail = sig[nt * n:]
    return np.concatenate([out, tail]) if tail.size else out


class SpeakerTreeDataset:
    """dir/<speaker>/**.wav (or .flac) corpora: WSJ0, LibriSpeech, ...

    ``clean_silence=True`` reproduces the reference's LibriSpeech reader
    behavior (VAD-trimmed utterances, utils_src.py:125-231)."""

    def __init__(self, data_dir: str, T: float, fs: int = 16000,
                 num_source: int = 1, seed: int = 0,
                 exts: tuple = (".wav",), clean_silence: bool = False):
        self.T = T
        self.fs = fs
        self.num_source = num_source
        self.clean_silence = clean_silence
        self._rng = np.random.default_rng(seed)
        self.by_speaker: Dict[str, List[str]] = {}
        root = Path(data_dir)
        for p in sorted(root.rglob("*")):
            if p.suffix in exts:
                rel = p.relative_to(root)
                spk = rel.parts[0] if len(rel.parts) > 1 else "_"
                self.by_speaker.setdefault(spk, []).append(str(p))
        assert self.by_speaker, f"no source utterances under {data_dir}"
        self.speakers = sorted(self.by_speaker)

    def __len__(self):
        return sum(len(v) for v in self.by_speaker.values())

    def _read(self, path: str) -> np.ndarray:
        sig, file_fs = read_wav(path)
        sig = sig[:, 0]
        if file_fs != self.fs:
            sig = scipy.signal.resample_poly(sig, self.fs, file_fs)
        if self.clean_silence:
            sig = remove_silence(sig, self.fs)
        return sig.astype(np.float32)

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(nsample, num_source): per source, a random speaker padded to T
        with same-speaker utterances, mean-removed."""
        rng = rng or self._rng
        n = int(self.T * self.fs)
        out = np.zeros((n, self.num_source), np.float32)
        for s in range(self.num_source):
            spk = self.speakers[int(rng.integers(len(self.speakers)))]
            utts = self.by_speaker[spk]
            sig = self._read(utts[int(rng.integers(len(utts)))])
            while sig.shape[0] < n:
                extra = self._read(utts[int(rng.integers(len(utts)))])
                sig = np.concatenate([sig, extra])
            st = int(rng.integers(0, max(sig.shape[0] - n, 1)))
            seg = sig[st: st + n]
            out[:, s] = seg - seg.mean()
        return out

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.sample(np.random.default_rng(idx))


def energy_vad_trim(sig: np.ndarray, fs: int, frame_ms: float = 30.0,
                    threshold_db: float = -40.0) -> np.ndarray:
    """Drop frames whose energy is below threshold relative to the peak
    frame (fallback for the reference's webrtcvad silence cleaning,
    utils_src.py:125-231)."""
    n = int(fs * frame_ms / 1000)
    nfr = len(sig) // n
    frames = sig[: nfr * n].reshape(nfr, n)
    e = 10 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
    keep = e > (e.max() + threshold_db)
    if not keep.any():
        return sig
    return frames[keep].reshape(-1)
