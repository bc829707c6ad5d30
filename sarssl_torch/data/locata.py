"""LOCATA challenge dataset: real recordings with ground-truth TDOA from
optically tracked array/source positions (the port's own copy of
``sarssl_tpu/data/locata.py``; its position tables are read with the
``csv`` module, not pandas).

Equivalent of the reference's ``data_generation/utils_LOCATA.py``: walks the
official corpus layout ``<dev|eval>/task{K}/recording{R}/<array>/`` with
``audio_array_<array>.wav``, ``position_array_<array>.txt``,
``position_source_<name>.txt`` and ``required_time.txt`` TSV files; selects
2-mic pairs within a distance range from the array geometry; crops random
T-second windows (train 0-0.8 / val 0.8-1 position ratio inside 'eval'
recordings, test = 'dev'); and interpolates the geometric TDOA of the pair
over the crop (utils_LOCATA.py:132-261).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.signal

from .real import ARRAY_GEOMETRIES, select_mic_pairs
from .tables import read_table
from .wavio import read_wav

ARRAY_GEOMS = {
    "dummy": ARRAY_GEOMETRIES["locata_dummy"],
    "benchmark2": ARRAY_GEOMETRIES["locata_benchmark2"],
    "dicit": ARRAY_GEOMETRIES["locata_dicit"],
}

SPLIT_SUBSETS = {"train": ["eval"], "val": ["eval"], "test": ["dev"]}
SPLIT_RATIO = {"train": (0.0, 0.8), "val": (0.8, 1.0), "test": (0.0, 1.0)}


def _read_tsv(path: str) -> Dict[str, np.ndarray]:
    return read_table(path, sep="\t")


def silence_onset(sig: np.ndarray, fs: int, max_dura: float = 4.0) -> float:
    """Leading-silence duration: first sample above 15% of the early peak
    (reference utils_LOCATA.py:190-195)."""
    head = sig[: int(fs * max_dura), 0]
    return float(np.argmax(head > head.max() * 0.15)) / fs


class LOCATADataset:
    def __init__(self, data_dir: str, T: float = 1.04, fs: int = 16000,
                 stage: str = "train", tasks: Sequence[int] = (1, 3, 5),
                 arrays: Sequence[str] = ("dicit", "benchmark2"),
                 mic_dist_range: Tuple[float, float] = (0.03, 0.20),
                 load_anno: bool = True, dataset_sz: Optional[int] = None,
                 c: float = 343.0, seed: int = 0):
        self.T, self.fs, self.c = T, fs, c
        self.stage = stage
        self.load_anno = load_anno
        self._rng = np.random.default_rng(seed)

        self.items: List[Tuple] = []
        pairs_by_array = {
            a: select_mic_pairs(ARRAY_GEOMS[a], 2, mic_dist_range)
            for a in arrays if a in ARRAY_GEOMS}
        for subset in SPLIT_SUBSETS[stage]:
            for task in tasks:
                task_dir = Path(data_dir) / subset / f"task{task}"
                if not task_dir.exists():
                    continue
                for rec_dir in sorted(task_dir.glob("recording*")):
                    for array in arrays:
                        adir = rec_dir / array
                        wav = adir / f"audio_array_{array}.wav"
                        if not wav.exists():
                            continue
                        for idxes, pos in pairs_by_array.get(array, []):
                            self.items.append((str(wav), str(adir), array,
                                               idxes, pos, task))
        assert self.items, f"no LOCATA items under {data_dir} ({stage})"
        self.dataset_sz = dataset_sz or len(self.items)

    def __len__(self):
        return self.dataset_sz

    def __getitem__(self, idx=None):
        import zlib
        # stable across processes/runs (str hash() is salted per process)
        rng = (self._rng if idx is None
               else np.random.default_rng(
                   (zlib.crc32(self.stage.encode()) ^ (idx + 1)) % (2 ** 31)))
        wav_path, adir, array, mic_idxes, mic_pos, task = \
            self.items[int(rng.integers(len(self.items)))]

        sig, file_fs = read_wav(wav_path)
        sil = silence_onset(sig, file_fs)
        nsil = int(sil * file_fs)
        usable = sig.shape[0] - nsil
        n_desired = round(self.T * file_fs)
        lo, hi = SPLIT_RATIO[self.stage]
        st_min = nsil + int(usable * lo)
        st_max = max(nsil + int(usable * hi) - n_desired, st_min + 1)
        st = int(rng.integers(st_min, st_max))
        crop = sig[st: st + n_desired, list(mic_idxes)]

        if self.load_anno:
            tdoa = self._tdoa_track(adir, array, mic_pos, st, n_desired,
                                    file_fs, task)
            anno = {"TDOA": np.float32(np.mean(tdoa))}
        if file_fs != self.fs:
            crop = scipy.signal.resample_poly(crop, self.fs, file_fs)
        n = round(self.T * self.fs)
        if crop.shape[0] < n:
            crop = np.pad(crop, ((0, n - crop.shape[0]), (0, 0)))
        crop = crop[:n]
        crop = crop / (np.max(np.abs(crop)) + 1e-8) * 0.9

        if self.load_anno:
            return crop.astype(np.float32), anno
        return crop.astype(np.float32)

    def _tdoa_track(self, adir: str, array: str, mic_pos_rel: np.ndarray,
                    st: int, n: int, fs: int, task: int) -> np.ndarray:
        """Geometric TDOA of the pair over crop samples, interpolated from
        the position tracks (utils_LOCATA.py:209-261)."""
        tt = _read_tsv(os.path.join(adir, "required_time.txt"))
        tstamp = (tt["hour"] * 3600 + tt["minute"] * 60 + tt["second"])
        tstamp = tstamp - tstamp[0]

        ap = _read_tsv(os.path.join(adir, f"position_array_{array}.txt"))
        array_pos = np.stack([ap["x"], ap["y"], ap["z"]], axis=-1)
        rot = np.zeros((array_pos.shape[0], 3, 3))
        for i in range(3):
            for j in range(3):
                rot[:, i, j] = ap[f"rotation_{i + 1}{j + 1}"]
        mic_rel = (rot[0] @ mic_pos_rel.T).T  # static-array tasks use rot[0]
        if task in (1, 2, 3, 4):
            mic_abs = mic_rel + array_pos[0]          # (2, 3), static
            mic_abs = np.tile(mic_abs[None], (len(tstamp), 1, 1))
        else:  # moving array (tasks 5/6)
            mic_abs = mic_rel[None] + array_pos[:, None, :]

        src_files = sorted(Path(adir).glob("position_source_*.txt"))
        assert src_files, f"no source tracks in {adir}"
        sp = _read_tsv(str(src_files[0]))
        src = np.stack([sp["x"], sp["y"], sp["z"]], axis=-1)  # (npt, 3)

        npt = min(len(tstamp), len(src), len(mic_abs))
        d = np.linalg.norm(src[:npt, None, :] - mic_abs[:npt], axis=-1)
        tdoa_pts = (d[:, 1] - d[:, 0]) / self.c  # (npt,)

        t = (st + np.arange(n)) / fs
        return np.interp(t, tstamp[:npt], tdoa_pts)
