"""Bespoke real-recording corpus readers (the port's own copy of
``sarssl_tpu/data/corpora.py``: the same seed draws the same crops).

Equivalent of the reference's ``data_generation/utils_real_micsig.py``: one
reader per corpus, each encoding that corpus's directory layout, channel
naming, published array geometry, and train/val/test splits. All share the
same machinery: enumerate (file, mic-pair[, time-window]) items ONCE with
header-only duration probes (wavio.audio_info — no decoding), weight them by
duration x mic-pair count, then serve random fixed-length 2-channel crops
resampled to the target rate.

Corpora (citations are reference utils_real_micsig.py):

  RealMAN    scene-based splits (27 train / 5 val scenes), 32-mic
             high-resolution array (three concentric 8-mic circles at
             3/6/9 cm + linear + vertical extensions), *.CH<k>.flac
             channel-per-file (:169-357);
  LOCATA     task recordings of dicit/benchmark2/eigenmike/dummy arrays,
             train={eval,dev}, test={dev} (:542-698);
  MCWSJ      MC-WSJ-AV 8-mic 20-cm circular arrays, ``*-<k>_T.wav``
             channel-per-file under MC_WSJ_AV_{Dev,Eval} (:701-817);
  LibriCSS   7-mic (center + 6 at 4.25 cm) multichannel utterances under
             exp/data/7ch/utterances (:820-927);
  AMI        Array1 8-mic meetings, ``*.Array1-0<k>.wav`` channel-per-file;
             geometry unpublished -> all mic pairs (:930-1035);
  AISHELL4   8-mic 10-cm circular array flac sessions with room-coded
             train/val splits and TextGrid speaker-overlap removal
             (:1038-1226);
  M2MeT      AliMeeting 8-mic 10.2-cm circular array with room splits and
             TextGrid overlap removal (:1229-1407);
  CHiME3     6-mic tablet array, ``*.CH<k>.wav`` channel-per-file under
             isolated/{tr05,dt05,et05}_* (:1410-1499).

Layering note: ``data/real.py`` is the generic, config-driven counterpart
(CorpusSpec + RealMicSigDataset + the RandomRealDataset prob-mixer). These
bespoke readers are what the pretrain CLI's ``--real-corpora`` uses; real.py
remains for ad-hoc trees (``--real-data-dirs``) and as the mixing wrapper.
The pair-distance filter (select_pairs / real.select_mic_pairs) implements
the same reference rule (utils_real_micsig.py:35-53) with different return
shapes for their respective callers.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.signal

from .wavio import audio_info, read_audio
from .textgrid import parse_textgrid, speech_intervals, single_speaker_windows

MIC_DIST_RANGE = (0.03, 0.20)


# ---------------------------------------------------------------------------
# geometries
# ---------------------------------------------------------------------------

def circular_array(radius: float, nmic: int, center: bool = False) -> np.ndarray:
    """nmic microphones evenly spaced on a circle (optionally + center mic)."""
    ang = np.arange(nmic) * 2 * np.pi / nmic
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(nmic)], axis=1)
    if center:
        return np.concatenate([np.zeros((1, 3)), ring], axis=0)
    return ring


def realman_high_resolution_array() -> np.ndarray:
    """RealMAN 32-mic array: center mic, 8-mic circles at 3/6/9 cm, linear
    extensions at +/-12 and 15 cm, vertical pair stack at +/-4.5/9 cm
    (reference utils_real_micsig.py:303-324)."""
    R, L = 0.03, 0.045
    pos = np.zeros((32, 3))
    pos[1:9] = circular_array(R, 8)
    pos[9:17] = circular_array(2 * R, 8)
    pos[17:25] = circular_array(3 * R, 8)
    pos[25] = [-4 * R, 0, 0]
    pos[26] = [4 * R, 0, 0]
    pos[27] = [5 * R, 0, 0]
    pos[28] = [0, 0, 2 * L]
    pos[29] = [0, 0, L]
    pos[30] = [0, 0, -L]
    pos[31] = [0, 0, -2 * L]
    return pos


LOCATA_ARRAYS: Dict[str, np.ndarray] = {
    "dummy": np.array([(-0.079, 0.000, 0.000), (-0.079, -0.009, 0.000),
                       (0.079, 0.000, 0.000), (0.079, -0.009, 0.000)]),
    "benchmark2": np.array([
        (-0.028, 0.030, -0.040), (0.006, 0.057, 0.000),
        (0.022, 0.022, -0.046), (-0.055, -0.024, -0.025),
        (-0.031, 0.023, 0.042), (-0.032, 0.011, 0.046),
        (-0.025, -0.003, 0.051), (-0.036, -0.027, 0.038),
        (-0.035, -0.043, 0.025), (0.029, -0.048, -0.012),
        (0.034, -0.030, 0.037), (0.035, 0.025, 0.039)]),
    # em32 capsule table; the reference duplicates capsule 6's position at
    # index 7 (utils_LOCATA.py:309,311) — fixed to the symmetric -z capsule
    # so pair distances/TDOA stay physical
    "eigenmike": np.array([
        (0.000, 0.039, 0.015), (-0.022, 0.036, 0.000),
        (0.000, 0.039, -0.015), (0.022, 0.036, 0.000),
        (0.000, 0.022, 0.036), (-0.024, 0.024, 0.024),
        (-0.039, 0.015, 0.000), (-0.024, 0.024, -0.024),
        (0.000, 0.022, -0.036), (0.024, 0.024, -0.024),
        (0.039, 0.015, 0.000), (0.024, 0.024, 0.024),
        (-0.015, 0.000, 0.039), (-0.036, 0.000, 0.022),
        (-0.036, 0.000, -0.022), (-0.015, 0.000, -0.039),
        (0.000, -0.039, 0.015), (0.022, -0.036, 0.000),
        (0.000, -0.039, -0.015), (-0.022, -0.036, 0.000),
        (0.000, -0.022, 0.036), (0.024, -0.024, 0.024),
        (0.039, -0.015, 0.000), (0.024, -0.024, -0.024),
        (0.000, -0.022, -0.036), (-0.024, -0.024, -0.024),
        (-0.039, -0.015, 0.000), (-0.024, -0.024, 0.024),
        (0.015, 0.000, 0.039), (0.036, 0.000, 0.022),
        (0.036, 0.000, -0.022), (0.015, 0.000, -0.039)]),
    "dicit": np.array([
        (0.96, 0.00, 0.00), (0.64, 0.00, 0.00), (0.32, 0.00, 0.00),
        (0.16, 0.00, 0.00), (0.08, 0.00, 0.00), (0.04, 0.00, 0.00),
        (0.00, 0.00, 0.00), (0.96, 0.00, 0.32), (-0.04, 0.00, 0.00),
        (-0.08, 0.00, 0.00), (-0.16, 0.00, 0.00), (-0.32, 0.00, 0.00),
        (-0.64, 0.00, 0.00), (-0.96, 0.00, 0.00), (-0.96, 0.00, 0.32)]),
}

MCWSJ_ARRAY = circular_array(0.10, 8)          # 20 cm diameter
LIBRICSS_ARRAY = circular_array(0.0425, 6, center=True)
AISHELL4_ARRAY = 0.5 * circular_array(0.10, 8)     # 10 cm diameter
M2MET_ARRAY = 0.51 * circular_array(0.10, 8)
CHIME3_ARRAY = np.array([(-0.100, 0.950, 0.000), (0.000, 0.950, 0.000),
                         (0.100, 0.950, 0.000), (-0.100, -0.950, 0.000),
                         (0.000, -0.950, 0.000), (0.100, -0.950, 0.000)])


def select_pairs(mic_pos: np.ndarray, dist_range=MIC_DIST_RANGE,
                 nmic: int = 2) -> List[Tuple[int, ...]]:
    """All ordered mic index tuples spaced within ``dist_range``
    (reference select_microphone_pairs, utils_real_micsig.py:35-53)."""
    out = []
    for idxes in itertools.permutations(range(mic_pos.shape[0]), nmic):
        d = float(np.linalg.norm(mic_pos[idxes[0]] - mic_pos[idxes[1]]))
        if dist_range[0] <= d <= dist_range[1]:
            out.append(idxes)
    return out


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Item:
    """One sampleable unit: a mic pair of one recording (+ optional
    overlap-free time window in seconds)."""

    paths: Tuple[str, ...]            # 1 multichannel file or 1 per channel
    mic_idxes: Tuple[int, ...]        # channel indices (into file / names)
    duration: float                   # usable seconds
    fs: int
    frames: int                       # total frames of the file
    window: Optional[Tuple[float, float]] = None  # (start, end) seconds


class CorpusReader:
    """Build-once item table + seeded random fixed-length crops."""

    name = "base"

    def __init__(self, data_dir: str, T: float = 4.112, fs: int = 16000,
                 stage: str = "train",
                 mic_dist_range: Tuple[float, float] = MIC_DIST_RANGE,
                 prob_mode: Sequence[str] = ("duration", "micpair"),
                 dataset_sz: Optional[int] = None, seed: int = 0,
                 remove_spkoverlap: bool = False):
        self.data_dir = str(data_dir)
        self.T = T
        self.fs = fs
        self.stage = stage
        self.mic_dist_range = mic_dist_range
        self.prob_mode = tuple(prob_mode)
        self.remove_spkoverlap = remove_spkoverlap
        self._rng = np.random.default_rng(seed)

        items: List[Item] = []
        weights: List[float] = []
        for item in self._iter_items():
            if item.duration < T:
                continue
            w = 1.0
            if "duration" in self.prob_mode:
                w *= item.duration
            if "micpair" not in self.prob_mode:
                w /= max(self._npairs_of(item), 1)
            items.append(item)
            weights.append(w)
        assert items, f"no usable items for corpus {self.name} ({stage})"
        self.items = items
        probs = np.asarray(weights, np.float64)
        self._cum = np.cumsum(probs / probs.sum())
        self._cum[-1] = 1.0
        self.dataset_sz = len(items) if dataset_sz is None else dataset_sz

    # per-corpus: yield Items ------------------------------------------------
    def _iter_items(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _npairs_of(self, item: Item) -> int:
        return 1

    # helpers ----------------------------------------------------------------
    def _probe(self, path) -> Optional[Tuple[float, int, int]]:
        try:
            info = audio_info(str(path))
        except (OSError, ValueError):
            return None
        return info.duration, info.fs, info.frames

    def _emit_pairs(self, paths_fn, pairs, duration, fs, frames,
                    window=None):
        """One Item per mic pair; ``paths_fn(pair) -> tuple of paths``."""
        for pair in pairs:
            yield Item(paths=tuple(str(p) for p in paths_fn(pair)),
                       mic_idxes=tuple(pair), duration=duration, fs=fs,
                       frames=frames, window=window)

    # sampling ---------------------------------------------------------------
    def __len__(self):
        return self.dataset_sz

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self._rng
        item = self.items[int(np.searchsorted(self._cum, rng.uniform()))]
        return self._read_crop(item, rng)

    def __getitem__(self, idx=None) -> np.ndarray:
        if idx is None:
            return self.sample()
        import zlib
        # stable across processes/runs (str hash() is salted per process)
        return self.sample(np.random.default_rng(
            (zlib.crc32(self.name.encode()) ^ (idx + 1)) % (2 ** 31)))

    def _read_crop(self, item: Item, rng) -> np.ndarray:
        nsample_desired = int(self.T * item.fs)
        if item.window is not None:
            w_st = int(item.window[0] * item.fs)
            n_avail = int(item.duration * item.fs)
            extra = max(0, n_avail - nsample_desired)
            st = w_st + (int(rng.integers(0, extra)) if extra else 0)
            sig = self._read(item, st, st + nsample_desired)
        else:
            extra = item.frames - nsample_desired
            if extra <= 0:
                sig = self._read(item, None, None)
                sig = self._pad_cut(sig, nsample_desired, rng)
            else:
                st = int(rng.integers(0, extra))
                sig = self._read(item, st, st + nsample_desired)
        if item.fs != self.fs:
            sig = scipy.signal.resample_poly(sig, self.fs, item.fs, axis=0)
        n = int(self.T * self.fs)
        return self._pad_cut(sig, n, rng)[:n].astype(np.float32)

    def _read(self, item: Item, st, ed) -> np.ndarray:
        if len(item.paths) == 1:
            data, _ = read_audio(item.paths[0], st, ed)
            return data[:, list(item.mic_idxes)]
        cols = []
        for p in item.paths:
            data, _ = read_audio(p, st, ed)
            cols.append(data[:, 0])
        n = min(len(c) for c in cols)
        return np.stack([c[:n] for c in cols], axis=1)

    @staticmethod
    def _pad_cut(sig: np.ndarray, n: int, rng) -> np.ndarray:
        from .noise import pad_cut_same
        return pad_cut_same(sig, n, rng)


def _glob_audio(root: Path, pattern: str) -> List[Path]:
    """rglob a pattern, also accepting a .wav twin of a .flac pattern (the
    environment decodes wav natively; flac needs optional soundfile)."""
    hits = list(root.rglob(pattern))
    if pattern.endswith(".flac"):
        hits += list(root.rglob(pattern[:-5] + ".wav"))
    return sorted(hits)


# ---------------------------------------------------------------------------
# per-corpus readers
# ---------------------------------------------------------------------------

class RealMANReader(CorpusReader):
    """RealMAN: scene splits + 32-mic high-resolution array, channel-per-file
    ``*.CH<k>.flac`` under ``*/ma_speech/<scene>/<task>/*/``."""

    name = "RealMAN"
    SCENES = {
        "train": ["LivingRoom1", "LivingRoom3", "LivingRoom4", "LivingRoom5",
                  "LivingRoom6", "LivingRoom7", "LivingRoom8", "Classroom1",
                  "Classroom2", "Classroom3", "OfficeRoom1", "OfficeRoom3",
                  "OfficeRoom4", "OfficeLobby", "Library", "Auditorium",
                  "BadmintonCourt1", "BadmintonCourt2", "BasketballCourt2",
                  "SunkenPlaza1", "Gym", "Cafeteria1", "UndergroundParking1",
                  "UndergroundParking2", "Car-Gasoline", "Car-Electric",
                  "Bus-Electric"],
        "val": ["LivingRoom2", "OfficeRoom2", "BasketballCourt1", "Market",
                "Cafeteria3"],
        "test": [],
    }

    def __init__(self, data_dir, tasks: Sequence[str] = ("static",), **kw):
        self.tasks = tuple(tasks)
        super().__init__(data_dir, **kw)

    def _iter_items(self):
        self._pairs = select_pairs(realman_high_resolution_array(),
                                   self.mic_dist_range)
        root = Path(self.data_dir)
        for scene in self.SCENES[self.stage]:
            for task in self.tasks:
                for ch0 in _glob_audio(root,
                                       f"ma_speech/{scene}/{task}/*/*.CH0.flac"):
                    probe = self._probe(ch0)
                    if probe is None:
                        continue
                    dur, fs, frames = probe
                    ext = ch0.suffix

                    def paths_fn(pair, ch0=ch0, ext=ext):
                        return [ch0.parent / ch0.name.replace(
                            f".CH0{ext}", f".CH{k}{ext}") for k in pair]

                    yield from self._emit_pairs(paths_fn, self._pairs,
                                                dur, fs, frames)

    def _npairs_of(self, item):
        return len(self._pairs)


class LOCATAReader(CorpusReader):
    """LOCATA challenge recordings; train uses eval+dev, test uses dev."""

    name = "LOCATA"
    SPLITS = {"train": ["eval", "dev"], "val": [], "test": ["dev"]}

    def __init__(self, data_dir, tasks: Sequence[int] = (1,),
                 arrays: Sequence[str] = ("dicit", "benchmark2", "eigenmike"),
                 **kw):
        self.tasks = tuple(tasks)
        self.arrays = tuple(arrays)
        super().__init__(data_dir, **kw)

    def _iter_items(self):
        self._array_pairs = {a: select_pairs(LOCATA_ARRAYS[a],
                                             self.mic_dist_range)
                             for a in self.arrays}
        for ds in self.SPLITS[self.stage]:
            for task in self.tasks:
                task_dir = Path(self.data_dir) / ds / f"task{task}"
                if not task_dir.is_dir():
                    continue
                for rec in sorted(os.listdir(task_dir)):
                    for array in self.arrays:
                        wav = (task_dir / rec / array /
                               f"audio_array_{array}.wav")
                        if not wav.exists():
                            continue
                        probe = self._probe(wav)
                        if probe is None:
                            continue
                        dur, fs, frames = probe
                        yield from self._emit_pairs(
                            lambda pair, wav=wav: [wav],
                            self._array_pairs[array], dur, fs, frames)

    def _npairs_of(self, item):
        # weight by the pair count of the item's OWN array (reference
        # utils_real_micsig.py:602-607 divides per array)
        array = Path(item.paths[0]).parent.name
        pairs = self._array_pairs.get(array)
        return len(pairs) if pairs else 1


class MCWSJReader(CorpusReader):
    """MC-WSJ-AV: 8-mic 20-cm circular arrays, ``*-<k>_T.wav`` per channel."""

    name = "MCWSJ"
    SPLITS = {"train": ["Dev", "Eval"], "val": [], "test": []}

    def __init__(self, data_dir, tasks: Sequence[str] = ("stat",),
                 arrays: Sequence[str] = ("array1", "array2"), **kw):
        self.tasks = tuple(tasks)
        self.arrays = tuple(arrays)
        super().__init__(data_dir, **kw)

    def _iter_items(self):
        self._pairs = select_pairs(MCWSJ_ARRAY, self.mic_dist_range)
        for ds in self.SPLITS[self.stage]:
            base = Path(self.data_dir) / f"MC_WSJ_AV_{ds}" / "audio"
            for task in self.tasks:
                task_dir = base / task
                if not task_dir.is_dir():
                    continue
                for ch1 in sorted(task_dir.rglob("*-1_T*.wav")):
                    if not any(a in ch1.parts for a in self.arrays):
                        continue
                    probe = self._probe(ch1)
                    if probe is None:
                        continue
                    dur, fs, frames = probe

                    def paths_fn(pair, ch1=ch1):
                        return [ch1.parent / ch1.name.replace(
                            "-1_T", f"-{k + 1}_T") for k in pair]

                    yield from self._emit_pairs(paths_fn, self._pairs,
                                                dur, fs, frames)

    def _npairs_of(self, item):
        return len(self._pairs)


class LibriCSSReader(CorpusReader):
    """LibriCSS 7-ch utterances under exp/data/7ch/utterances."""

    name = "LibriCSS"

    def __init__(self, data_dir,
                 tasks: Sequence[str] = ("overlap_ratio_0.0_*",), **kw):
        self.tasks = tuple(tasks)
        super().__init__(data_dir, **kw)

    def _iter_items(self):
        self._pairs = select_pairs(LIBRICSS_ARRAY, self.mic_dist_range)
        base = Path(self.data_dir).expanduser() / "exp" / "data" / "7ch" / \
            "utterances"
        utts: List[Path] = []
        for task in self.tasks:
            for ovlp in sorted(base.glob(task)):
                utts += sorted(ovlp.rglob("*.wav"))
        # reference shuffles with a fixed seed and puts everything in train
        rng = np.random.default_rng(2024)
        utts = list(utts)
        rng.shuffle(utts)
        rng.shuffle(utts)
        if self.stage != "train":
            return
        for wav in utts:
            probe = self._probe(wav)
            if probe is None:
                continue
            dur, fs, frames = probe
            yield from self._emit_pairs(lambda pair, wav=wav: [wav],
                                        self._pairs, dur, fs, frames)

    def _npairs_of(self, item):
        return len(self._pairs)


class AMIReader(CorpusReader):
    """AMI meetings, Array1 ``*.Array1-0<k>.wav`` per channel; array size is
    unpublished so every mic pair is used (reference :1015-1035)."""

    name = "AMI"
    NMIC = 8
    SPLITS = {"train": ["ES", "IS", "TS", "EN", "IB", "IN"], "val": [],
              "test": []}

    def __init__(self, data_dir,
                 tasks: Sequence[str] = ("ScenarioMeetings",
                                         "NonScenarioMeetings"),
                 arrays: Sequence[str] = ("Array1",), **kw):
        self.tasks = tuple(tasks)
        self.arrays = tuple(arrays)
        super().__init__(data_dir, **kw)

    def _iter_items(self):
        self._pairs = list(itertools.permutations(range(self.NMIC), 2))
        prefixes = tuple(self.SPLITS[self.stage])
        for task in self.tasks:
            task_dir = Path(self.data_dir) / task
            if not task_dir.is_dir():
                continue
            for session in sorted(os.listdir(task_dir)):
                if not session.startswith(prefixes):
                    continue
                wav_dir = task_dir / session / "audio"
                for array in self.arrays:
                    for ch1 in sorted(wav_dir.rglob(
                            f"{session[:2]}*.{array}-01.wav")):
                        probe = self._probe(ch1)
                        if probe is None:
                            continue
                        dur, fs, frames = probe

                        def paths_fn(pair, ch1=ch1):
                            return [ch1.parent / ch1.name.replace(
                                "-01.wav", f"-0{k + 1}.wav") for k in pair]

                        yield from self._emit_pairs(paths_fn, self._pairs,
                                                    dur, fs, frames)

    def _npairs_of(self, item):
        return len(self._pairs)


class AISHELL4Reader(CorpusReader):
    """AISHELL-4: 8-mic 10-cm circular array sessions; room-coded splits;
    optional TextGrid speaker-overlap removal (reference :1067-1193)."""

    name = "AISHELL4"
    ROOMS = {
        "train": {"train_L": ["L_R001", "L_R002"],
                  "train_M": ["M_R001", "M_R002"],
                  "train_S": ["S_R001"],
                  "test": ["S_R003", "S_R004", "L_R003", "L_R004"]},
        "val": {"train_L": [], "train_M": [], "train_S": [],
                "test": ["M_R003"]},
        "test": {"test": []},
    }
    BAD_TEXTGRIDS = ("20200622_M_R002S07C01.TextGrid",
                     "20200710_M_R002S06C01.TextGrid")

    ARRAY = AISHELL4_ARRAY

    def _iter_items(self):
        self._pairs = select_pairs(self.ARRAY, self.mic_dist_range)
        root = Path(self.data_dir).expanduser()
        if self.remove_spkoverlap:
            for ds, rooms in self.ROOMS[self.stage].items():
                for room in rooms:
                    for tg in sorted((root / ds).rglob(f"*{room}*.TextGrid")):
                        if tg.name in self.BAD_TEXTGRIDS:
                            continue
                        yield from self._windows_of(tg)
        else:
            for ds, rooms in self.ROOMS[self.stage].items():
                for room in rooms:
                    for wav in _glob_audio(root / ds / "wav",
                                           f"*{room}*.flac"):
                        probe = self._probe(wav)
                        if probe is None:
                            continue
                        dur, fs, frames = probe
                        yield from self._emit_pairs(
                            lambda pair, wav=wav: [wav], self._pairs,
                            dur, fs, frames)

    def _windows_of(self, tg_path: Path):
        audio = self._find_audio(tg_path)
        if audio is None:
            return
        probe = self._probe(audio)
        if probe is None:
            return
        total_dur, fs, frames = probe
        try:
            tiers = parse_textgrid(str(tg_path))
        except Exception:
            return
        windows = single_speaker_windows(speech_intervals(tiers), self.T,
                                         total_dur)
        for st, ed, dur in windows:
            yield from self._emit_pairs(
                lambda pair, audio=audio: [audio], self._pairs,
                dur, fs, frames, window=(st, ed))

    def _find_audio(self, tg_path: Path) -> Optional[Path]:
        for ext in (".flac", ".wav"):
            hits = list(tg_path.parent.parent.rglob(
                tg_path.name.replace(".TextGrid", ext)))
            if hits:
                return hits[0]
        return None

    def _npairs_of(self, item):
        return len(self._pairs)


class M2MeTReader(AISHELL4Reader):
    """AliMeeting (M2MeT): 8-mic 10.2-cm circular array; room splits over
    Train/Eval/Test_Ali; TextGrids under <ds>/textgrid_dir, audio under
    <ds>/audio_dir (reference :1258-1377)."""

    name = "M2MeT"
    ROOMS = {
        "train": {"Train_Ali/Train_Ali_far": [
                      "R0003", "R0004", "R0005", "R0008", "R0014", "R0015",
                      "R0020", "R1019", "R1021", "R2001", "R2105", "R2108"],
                  "Eval_Ali/Eval_Ali_far": [
                      "R8001", "R8003", "R8007", "R8008", "R8009"],
                  "Test_Ali/Test_Ali_far": [
                      "R8004", "R8005", "R8008", "R8009"]},
        "val": {"Train_Ali/Train_Ali_far": [],
                "Eval_Ali/Eval_Ali_far": [],
                "Test_Ali/Test_Ali_far": ["R8002", "R8006"]},
        "test": {"Train_Ali/Train_Ali_far": [],
                 "Eval_Ali/Eval_Ali_far": [],
                 "Test_Ali/Test_Ali_far": []},
    }
    BAD_TEXTGRIDS = ()
    ARRAY = M2MET_ARRAY

    def _iter_items(self):
        self._pairs = select_pairs(self.ARRAY, self.mic_dist_range)
        root = Path(self.data_dir).expanduser()
        if self.remove_spkoverlap:
            for ds, rooms in self.ROOMS[self.stage].items():
                for room in rooms:
                    for tg in sorted((root / ds / "textgrid_dir").glob(
                            f"{room}*.TextGrid")):
                        yield from self._windows_of(tg)
        else:
            for ds, rooms in self.ROOMS[self.stage].items():
                for room in rooms:
                    for wav in _glob_audio(root / ds / "audio_dir",
                                           f"{room}*.wav"):
                        probe = self._probe(wav)
                        if probe is None:
                            continue
                        dur, fs, frames = probe
                        yield from self._emit_pairs(
                            lambda pair, wav=wav: [wav], self._pairs,
                            dur, fs, frames)

    def _find_audio(self, tg_path: Path) -> Optional[Path]:
        wav_dir = tg_path.parent.parent / "audio_dir"
        for ext in (".wav", ".flac"):
            hits = sorted(wav_dir.glob(
                tg_path.name.replace(".TextGrid", f"*{ext}")))
            if hits:
                return hits[0]
        return None


class CHiME3Reader(CorpusReader):
    """CHiME-3 tablet recordings: ``*.CH<k>.wav`` per channel under
    isolated/{tr05,dt05,et05}_{bth,bus,caf,ped,str}."""

    name = "CHiME3"
    ENVIRS = ["bth", "bus_real", "caf_real", "ped_real", "str_real"]
    SPLITS = {"train": ["tr05"], "val": ["dt05"], "test": ["et05"]}

    def _iter_items(self):
        self._pairs = select_pairs(CHIME3_ARRAY, self.mic_dist_range)
        base = Path(self.data_dir) / "data" / "audio" / "16kHz" / "isolated"
        for ds in self.SPLITS[self.stage]:
            for env in self.ENVIRS:
                d = base / f"{ds}_{env}"
                if not d.is_dir():
                    continue
                for ch0 in sorted(d.rglob("*.CH0.wav")):
                    probe = self._probe(ch0)
                    if probe is None:
                        continue
                    dur, fs, frames = probe

                    def paths_fn(pair, ch0=ch0):
                        return [ch0.parent / ch0.name.replace(
                            ".CH0.wav", f".CH{k}.wav") for k in pair]

                    yield from self._emit_pairs(paths_fn, self._pairs,
                                                dur, fs, frames)

    def _npairs_of(self, item):
        return len(self._pairs)


REAL_CORPORA = {
    "RealMAN": RealMANReader,
    "LOCATA": LOCATAReader,
    "MCWSJ": MCWSJReader,
    "LibriCSS": LibriCSSReader,
    "AMI": AMIReader,
    "AISHELL4": AISHELL4Reader,
    "M2MeT": M2MeTReader,
    "CHiME3": CHiME3Reader,
}
