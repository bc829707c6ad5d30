"""Real-recording microphone-pair datasets (the port's own copy of
``sarssl_tpu/data/real.py``: the same seed draws the same crops).

Equivalent of the reference real-data layer
(the reference's ``data_generation/utils_real_micsig.py`` and
utils_LOCATA.py): select 2-mic pairs within a distance range from known array
geometries, build a duration/micpair-probability-weighted item table over a
corpus tree, and serve random fixed-length crops resampled to the target fs.

Design differences from the reference: corpora are described by a
``CorpusSpec`` (glob patterns + array geometry + fs) instead of one bespoke
class per corpus; the per-corpus classes below are thin specs. This keeps the
reader testable with synthetic trees while supporting the same corpora
(LOCATA, MC-WSJ-AV, LibriCSS, AMI, AISHELL-4, M2MeT, CHiME3, RealMAN, ...).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.signal

from .wavio import audio_info, read_audio

# Published microphone geometries (meters). LOCATA arrays follow the official
# challenge documentation (also tabulated in the reference at
# utils_LOCATA.py:295-368).
ARRAY_GEOMETRIES: Dict[str, np.ndarray] = {
    "locata_dummy": np.array([
        (-0.079, 0.000, 0.000), (-0.079, -0.009, 0.000),
        (0.079, 0.000, 0.000), (0.079, -0.009, 0.000)]),
    "locata_benchmark2": np.array([
        (-0.028, 0.030, -0.040), (0.006, 0.057, 0.000),
        (0.022, 0.022, -0.046), (-0.055, -0.024, -0.025),
        (-0.031, 0.023, 0.042), (-0.032, 0.011, 0.046),
        (-0.025, -0.003, 0.051), (-0.036, -0.027, 0.038),
        (-0.035, -0.043, 0.025), (0.029, -0.048, -0.012),
        (0.034, -0.030, 0.037), (0.035, 0.025, 0.039)]),
    "locata_dicit": np.array([
        (0.96, 0.00, 0.00), (0.64, 0.00, 0.00), (0.32, 0.00, 0.00),
        (0.16, 0.00, 0.00), (0.08, 0.00, 0.00), (0.04, 0.00, 0.00),
        (0.00, 0.00, 0.00), (0.96, 0.00, 0.32), (-0.04, 0.00, 0.00),
        (-0.08, 0.00, 0.00), (-0.16, 0.00, 0.00), (-0.32, 0.00, 0.00),
        (-0.64, 0.00, 0.00), (-0.96, 0.00, 0.00), (-0.96, 0.00, 0.32)]),
}


def select_mic_pairs(mic_pos: np.ndarray, nmic: int = 2,
                     dist_range: Tuple[float, float] = (0.03, 0.20)
                     ) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """All ordered mic tuples whose pair distance lies in ``dist_range``
    (reference _select_microphone_pairs, utils_real_micsig.py:33-53)."""
    out = []
    for idxes in itertools.permutations(range(mic_pos.shape[0]), nmic):
        pos = mic_pos[list(idxes)]
        d = float(np.linalg.norm(pos[0] - pos[1]))
        if dist_range[0] <= d <= dist_range[1]:
            out.append((idxes, pos))
    if not out:
        raise ValueError(f"no mic pairs within distance range {dist_range}")
    return out


@dataclass
class CorpusSpec:
    """Description of a multi-channel wav corpus."""

    name: str
    glob: str = "**/*.wav"
    geometry: Optional[np.ndarray] = None   # (nmic, 3); None -> unknown, use
                                            # adjacent channel pairs
    fs: Optional[int] = None                # None -> read from files
    channel_per_file: bool = False          # e.g. AMI: one wav per channel
    channel_file_pattern: Optional[str] = None  # '{stem}{ch}.wav' style
    exclude: Sequence[str] = ()


class RealMicSigDataset:
    """Random fixed-length 2-channel crops from a real corpus.

    Item probabilities are proportional to duration x available mic pairs
    when prob_mode includes those terms (reference utils_real_micsig.py:55-166).
    """

    def __init__(self, data_dir: str, spec: CorpusSpec, T: float = 4.112,
                 fs: int = 16000,
                 mic_dist_range: Tuple[float, float] = (0.03, 0.20),
                 prob_mode: Sequence[str] = ("duration", "micpair"),
                 dataset_sz: Optional[int] = None, seed: int = 0):
        self.spec = spec
        self.T = T
        self.fs = fs
        self.seed = seed
        self._rng = np.random.default_rng(seed)

        if spec.geometry is not None:
            self.mic_pairs = select_mic_pairs(spec.geometry, 2, mic_dist_range)
        else:
            self.mic_pairs = None  # adjacent channels at read time

        paths = [p for p in Path(data_dir).rglob(spec.glob.replace("**/", ""))
                 if p.suffix == ".wav"
                 and not any(x in str(p) for x in spec.exclude)]
        assert paths, f"no wavs for corpus {spec.name} under {data_dir}"

        if spec.channel_per_file:
            # AMI-style corpora: one wav per channel, grouped by common stem
            # (trailing digits identify the channel)
            groups = {}
            for p in sorted(paths):
                stem = p.stem.rstrip("0123456789")
                groups.setdefault((str(p.parent), stem), []).append(str(p))
            groups = {k: v for k, v in groups.items() if len(v) >= 2}
            assert groups, f"no multi-channel groups for {spec.name}"
            self._group_list = sorted(groups.values(), key=lambda v: v[0])
            paths = [Path(v[0]) for v in self._group_list]
        else:
            self._group_list = None
            paths = sorted(paths)

        items, weights = [], []
        for gi, p in enumerate(paths):
            try:
                # header-only probe: no decoding while building the table
                info = audio_info(str(p))
            except Exception:
                continue
            dur, file_fs = info.duration, info.fs
            if dur < T:  # seconds; resampling preserves duration
                continue
            nch = (len(self._group_list[gi]) if self._group_list
                   else info.channels)
            npair = len(self.mic_pairs) if self.mic_pairs else max(nch - 1, 1)
            w = 1.0
            if "duration" in prob_mode:
                w *= dur
            if "micpair" in prob_mode:
                w *= npair
            items.append((str(p), dur, file_fs, nch)
                         if not self._group_list else
                         (gi, dur, file_fs, nch))
            weights.append(w)
        assert items, f"no usable items for corpus {spec.name}"
        self.items = items
        probs = np.asarray(weights, np.float64)
        self.probs = probs / probs.sum()
        self.dataset_sz = dataset_sz or len(items)

    def __len__(self):
        return self.dataset_sz

    def __getitem__(self, idx=None) -> np.ndarray:
        # seeded per index, stable across processes (no id()/salted hash)
        rng = self._rng if idx is None else np.random.default_rng(
            (self.seed * 2654435761 + idx + 1) % (2 ** 31))
        return self.sample(rng)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        item = self.items[int(rng.choice(len(self.items), p=self.probs))]
        path_or_gi, dur, file_fs, nch = item
        nsample_desired = int(self.T * file_fs)
        nframes = int(dur * file_fs)
        st = (int(rng.integers(0, nframes - nsample_desired))
              if nframes > nsample_desired else 0)
        ed = st + min(nsample_desired, nframes)
        # ranged reads: decode only the crop, not the whole recording
        if self._group_list is not None:
            files = self._group_list[path_or_gi]
            cols = [read_audio(f, st, ed)[0][:, 0] for f in files]
            n = min(len(c) for c in cols)
            data = np.stack([c[:n] for c in cols], axis=1)
        else:
            data, _ = read_audio(path_or_gi, st, ed)
        # pick a mic pair
        if self.mic_pairs is not None:
            idxes, _ = self.mic_pairs[int(rng.integers(len(self.mic_pairs)))]
            idxes = [i for i in idxes if i < nch][:2]
            if len(idxes) < 2:
                idxes = [0, min(1, nch - 1)]
        else:
            if nch < 2:
                raise ValueError(
                    f"corpus {self.spec.name}: item has a single channel — "
                    "a mono file cannot form a mic pair. If the corpus "
                    "stores one file per channel, set "
                    "CorpusSpec(channel_per_file=True) or use the bespoke "
                    "data/corpora.py reader.")
            a = int(rng.integers(0, max(nch - 1, 1)))
            idxes = [a, min(a + 1, nch - 1)]
        sig = data[:, idxes]
        if file_fs != self.fs:
            sig = scipy.signal.resample_poly(sig, self.fs, file_fs)
        n = int(self.T * self.fs)
        if sig.shape[0] < n:
            reps = int(np.ceil(n / sig.shape[0]))
            sig = np.tile(sig, (reps, 1))
        return sig[:n].astype(np.float32)


class RandomRealDataset:
    """Probability-weighted mixture over several real corpora
    (reference RandomRealDataset, dataset.py:15-104)."""

    def __init__(self, datasets: Sequence, probs: Optional[Sequence[float]] = None,
                 dataset_sz: int = 10000, seed: int = 0):
        assert datasets
        self.datasets = list(datasets)
        p = np.asarray(probs if probs is not None
                       else [1.0] * len(datasets), np.float64)
        self.probs = p / p.sum()
        self.dataset_sz = dataset_sz
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self.dataset_sz

    def __getitem__(self, idx=None) -> np.ndarray:
        if idx is None:
            return self.sample(self._rng)
        # indexed access must be a pure function of idx (thread and process
        # pools call out of order): derive the corpus choice from an
        # idx-seeded rng, not the shared stateful one
        rng = np.random.default_rng((self.seed * 2654435761 + idx + 1)
                                    % (2 ** 31))
        return self.sample(rng)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        d = int(rng.choice(len(self.datasets), p=self.probs))
        ds = self.datasets[d]
        if hasattr(ds, "sample"):
            return ds.sample(rng)
        return ds[int(rng.integers(len(ds)))]


# Thin per-corpus specs mirroring the reference classes
# (utils_real_micsig.py: RealMAN/LOCATA/MCWSJ/LibriCSS/AMI/AISHELL4/M2MeT/CHiME3)
CORPUS_SPECS: Dict[str, CorpusSpec] = {
    "LOCATA_dicit": CorpusSpec("LOCATA_dicit",
                               geometry=ARRAY_GEOMETRIES["locata_dicit"]),
    "LOCATA_benchmark2": CorpusSpec(
        "LOCATA_benchmark2", geometry=ARRAY_GEOMETRIES["locata_benchmark2"]),
    "MCWSJ": CorpusSpec("MCWSJ"),
    "LibriCSS": CorpusSpec("LibriCSS"),
    # channel-per-file corpora: one wav per channel, grouped by stem
    # (the bespoke data/corpora.py readers encode the full per-corpus
    # layouts/geometry; these generic specs cover ad-hoc trees)
    "AMI": CorpusSpec("AMI", channel_per_file=True),
    "AISHELL4": CorpusSpec("AISHELL4"),
    "M2MeT": CorpusSpec("M2MeT"),
    "CHiME3": CorpusSpec("CHiME3", channel_per_file=True),
    "RealMAN": CorpusSpec("RealMAN", channel_per_file=True),
}
