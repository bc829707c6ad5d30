"""File-backed and on-the-fly datasets + batching (the port's own copy of
``sarssl_tpu/data/datasets.py``: host numpy, the same rows in the same order
for the same seed; batches reach the card through ``prefetch.device_prefetch``).

Equivalents of the reference dataset layer (``dataset.py``):

  FixMicSigDataset        — rglob '*.wav' (minus '*_dp.wav') with optional
                            '{idx}_info.npz' annotations {TDOA,T60,DRR,C50,ABS}
                            (dataset.py:107-178);
  OnTheFlyMicSigDataset   — per-index seeded scene synthesis (the v1
                            fully-on-the-fly pipeline, code_v1/dataset.py);
  Selecting               — crop transform (dataset.py:386-395);
  batch_iterator          — shuffled host batching with a worker pool.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .wavio import read_wav
from .scene import SceneSynthesizer

TASKS = ("TDOA", "T60", "DRR", "C50", "C80", "ABS", "SNR", "DOA", "SUR", "VOL")


@dataclass
class Selecting:
    """Crop waveforms to a sample range (reference dataset.py:386-395)."""
    select_range: Tuple[int, int]

    def __call__(self, sig: np.ndarray) -> np.ndarray:
        st, ed = self.select_range
        return sig[st:ed]


@dataclass
class Segmenting:
    """Split a waveform into fixed-length segments
    (reference code_v1/dataset.py:2352 'Segmenting' transform):
    (nsample, nch) -> (nseg, seg_len, nch), truncating the remainder."""
    seg_len: int
    seg_shift: Optional[int] = None

    def __call__(self, sig: np.ndarray) -> np.ndarray:
        shift = self.seg_shift or self.seg_len
        nseg = (sig.shape[0] - self.seg_len) // shift + 1
        if nseg <= 0:  # shorter than one segment: empty result, not a crash
            return np.zeros((0, self.seg_len) + sig.shape[1:], sig.dtype)
        return np.stack([sig[i * shift: i * shift + self.seg_len]
                         for i in range(nseg)])


class FixMicSigDataset:
    """Pre-generated wav (+ info npz) tree."""

    def __init__(self, data_dir: str, load_anno: bool = False,
                 fs: int = 16000, data_num: Optional[int] = None,
                 transforms: Sequence = ()):  # noqa: D401
        self.data_paths = sorted(
            p for p in Path(data_dir).rglob("*.wav")
            if not p.name.endswith("_dp.wav"))
        if data_num is not None:
            self.data_paths = self.data_paths[:data_num]
        assert self.data_paths, f"no wav files under {data_dir}"
        self.load_anno = load_anno
        self.fs = fs
        self.transforms = list(transforms)

    def __len__(self):
        return len(self.data_paths)

    def __getitem__(self, idx: int):
        path = self.data_paths[idx]
        sig, fs = read_wav(str(path))
        assert fs == self.fs, f"{path}: fs {fs} != {self.fs}"
        for t in self.transforms:
            sig = t(sig)
        if not self.load_anno:
            return sig.astype(np.float32)
        info_path = str(path).replace(".wav", "_info.npz")
        annos: Dict[str, float] = {}
        if os.path.exists(info_path):
            info = np.load(info_path, allow_pickle=True)
            for k in TASKS:
                key = "T60_edc" if (k == "T60" and "T60_edc" in info) else k
                annos[k] = (np.float32(info[key]) if key in info
                            else np.float32(np.nan))
        else:
            annos = {k: np.float32(np.nan) for k in TASKS}
        return sig.astype(np.float32), annos


class FixMicSigDatasetLOCATA(FixMicSigDataset):
    """LOCATA-materialized wav tree: TDOA annotation only, NaN elsewhere
    (reference FixMicSigDatasetLOCATA, dataset.py:180-230)."""

    def __getitem__(self, idx: int):
        out = super().__getitem__(idx)
        if not self.load_anno:
            return out
        sig, annos = out
        keep = annos.get("TDOA", np.float32(np.nan))
        annos = {k: np.float32(np.nan) for k in TASKS}
        annos["TDOA"] = keep
        return sig, annos


class OnTheFlyMicSigDataset:
    """Per-index seeded scene synthesis — no files needed."""

    def __init__(self, synthesizer: SceneSynthesizer, length: int,
                 seed: int = 1, transforms: Sequence = ()):  # noqa: D401
        self.synth = synthesizer
        self.length = length
        self.seed = seed
        self.transforms = list(transforms)

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        sig, info = self.synth.generate(self.seed + idx)
        for t in self.transforms:
            sig = t(sig)
        annos = {k: np.float32(info.get(k if k != "T60" else "T60_edc",
                                        np.nan)) for k in TASKS}
        return sig.astype(np.float32), annos


class RandomMixDataset:
    """Probability-mixed view over several datasets — the mixing mechanism
    of the reference's RandomMicSigDataset (presaved real + sim wav trees)
    and RandomMicSigFromRIRDataset (real-RIR + sim-RIR on-the-fly arms),
    the reference's ``dataset.py:232-382``.

    Unlike the reference (global ``np.random`` per __getitem__), item i is a
    pure function of (seed, i): a per-index Generator picks the arm and the
    inner index, so epochs are reproducible and worker-safe."""

    def __init__(self, datasets: Sequence, length: int, seed: int = 1,
                 probs: Optional[Sequence[float]] = None):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        self.length = length
        self.seed = seed
        if probs is None:
            probs = [1.0 / len(self.datasets)] * len(self.datasets)
        p = np.asarray(probs, np.float64)
        assert len(p) == len(self.datasets) and p.sum() > 0
        self._cum = np.cumsum(p / p.sum())

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, 0x5EED, idx))
        arm = int(np.searchsorted(self._cum, rng.random(), side="right"))
        arm = min(arm, len(self.datasets) - 1)
        d = self.datasets[arm]
        return d[int(rng.integers(len(d)))]


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   num_workers: int = 0) -> Iterator:
    """Yield (wave (nb, nsample, nch)[, labels dict of (nb,)]) host batches.

    Replaces torch DataLoader (reference run_pretrain.py:191-199) with a
    thread pool; items are decoded/synthesized concurrently while the
    accelerator runs the previous step.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if drop_last:
        order = order[: (n // batch_size) * batch_size]

    def fetch(i):
        return dataset[int(i)]

    collate = collate_items

    if num_workers <= 0:
        for s in range(0, len(order), batch_size):
            idxs = order[s: s + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            yield collate([fetch(i) for i in idxs])
        return

    with cf.ThreadPoolExecutor(num_workers) as pool:
        batches = [order[s: s + batch_size]
                   for s in range(0, len(order), batch_size)
                   if len(order[s: s + batch_size]) == batch_size or not drop_last]
        futures: List = []
        PREFETCH = 4
        it = iter(batches)
        for _ in range(PREFETCH):
            b = next(it, None)
            if b is None:
                break
            futures.append(pool.map(fetch, b))
        while futures:
            items = list(futures.pop(0))
            b = next(it, None)
            if b is not None:
                futures.append(pool.map(fetch, b))
            yield collate(items)


def collate_items(items):
    """(wave[, annos-dict]) items -> stacked batch; shared by the thread and
    process loaders so label formats cannot diverge between them."""
    first = items[0]
    if isinstance(first, tuple):
        waves = np.stack([it[0] for it in items])
        keys = first[1].keys()
        return waves, {k: np.stack([it[1][k] for it in items]) for k in keys}
    return np.stack(items)


# worker side of mp_batch_iterator: {path: dataset} of the last dataset file
# this worker loaded
_MP_CACHE: dict = {}


def _mp_fetch(task):
    path, idx = task
    dataset = _MP_CACHE.get(path)
    if dataset is None:
        with open(path, "rb") as f:
            dataset = pickle.load(f)
        _MP_CACHE.clear()
        _MP_CACHE[path] = dataset
    return dataset[int(idx)]


def mp_batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                      seed: int = 0, drop_last: bool = True,
                      num_workers: int = 4, prefetch_batches: int = 4,
                      pool=None) -> Iterator:
    """Process-pool batch iterator for CPU-bound per-index datasets.

    ``batch_iterator``'s thread pool cannot scale item *synthesis* (scene
    generation, speech x RIR convolution) under the GIL; this is the
    torch-DataLoader(num_workers=N) replacement for those datasets. Requires
    the repo-wide per-index-purity convention: dataset[i] must be a pure
    function of i, so worker assignment cannot change the data.

    The dataset is pickled once per call into a file of its own, which each
    worker loads once at its first task of the call; a task then carries that
    file's path and an index, and only finished items cross back. So the
    speaker and RIR path lists of a large corpus cross the pipe once a worker
    and call, not once an item.

    ``pool``: a spawned process pool to reuse (``num_workers`` is then its
    size), so one pool serves every epoch and split of a run; without it the
    call spawns a pool of its own, whose workers each import torch again. The
    batches are the same either way.
    """
    import multiprocessing as mp
    import tempfile
    import uuid

    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if drop_last:
        order = order[: (n // batch_size) * batch_size]
    batches = [order[s: s + batch_size]
               for s in range(0, len(order), batch_size)
               if len(order[s: s + batch_size]) == batch_size or not drop_last]

    path = os.path.join(tempfile.gettempdir(), f"sarssl_loader_{uuid.uuid4().hex}.pkl")
    with open(path, "xb") as f:
        pickle.dump(dataset, f, protocol=pickle.HIGHEST_PROTOCOL)

    def submit(batch):
        return workers.map_async(_mp_fetch, [(path, int(i)) for i in batch])

    own = None if pool is not None else mp.get_context("spawn").Pool(num_workers)
    workers = pool if own is None else own
    try:
        pending: List = []
        it = iter(batches)
        for _ in range(prefetch_batches):
            b = next(it, None)
            if b is None:
                break
            pending.append(submit(b))
        while pending:
            items = pending.pop(0).get()
            b = next(it, None)
            if b is not None:
                pending.append(submit(b))
            yield collate_items(items)
    finally:
        if own is not None:
            own.terminate()
        os.unlink(path)
