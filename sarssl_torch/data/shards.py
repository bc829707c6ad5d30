"""Packed contiguous shards: feeding the card without per-file decode (the
port's own copy of ``sarssl_tpu/data/shards.py``; the directory format is
the same, so a tree packed by either package is read by the other).

The reference feeds its GPU one decoded wav per DataLoader item
(``run_pretrain.py:191-199``, num_workers=8), and thread workers cannot
scale per-file decode under the GIL.

Here utterances are packed into contiguous float32 ``shard_%05d.npy`` arrays
of shape (n, nsample, nch) plus per-shard ``shard_%05d_annos.npz`` label
columns and a ``packed_meta.json``. Reading a batch is then one (page-cached)
memmap gather, with no open/parse/decode per item. ``pack_wav_tree``
converts a generated corpus once; ``PackedDataset.iter_batches`` streams
batches, with the JAX package's host-sharding hooks (``shard_i`` /
``shard_n``: every host the same number of equal-size batches).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

META_NAME = "packed_meta.json"


def is_packed(data_dir: str) -> bool:
    return os.path.exists(os.path.join(data_dir, META_NAME))


def pack_dataset(dataset, out_dir: str, items_per_shard: int = 512,
                 dtype: str = "float32") -> Dict:
    """Pack any indexable dataset yielding ``wave`` or ``(wave, annos)``
    into contiguous shards. Returns the written meta dict."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    assert n > 0
    first = dataset[0]
    with_annos = isinstance(first, tuple)
    wave0 = first[0] if with_annos else first
    nsample, nch = wave0.shape
    anno_keys = sorted(first[1].keys()) if with_annos else []

    nshards = -(-n // items_per_shard)
    for s in range(nshards):
        lo, hi = s * items_per_shard, min((s + 1) * items_per_shard, n)
        waves = np.empty((hi - lo, nsample, nch), dtype)
        annos = {k: [] for k in anno_keys}
        for j, i in enumerate(range(lo, hi)):
            item = dataset[i]
            w = item[0] if with_annos else item
            assert w.shape == (nsample, nch), (
                f"item {i} shape {w.shape} != {(nsample, nch)}; pack only "
                "fixed-length corpora (crop with a Selecting transform)")
            waves[j] = w
            if with_annos:
                for k in anno_keys:
                    annos[k].append(np.asarray(item[1][k], np.float32))
        np.save(os.path.join(out_dir, f"shard_{s:05d}.npy"), waves)
        if with_annos:
            np.savez(os.path.join(out_dir, f"shard_{s:05d}_annos.npz"),
                     **{k: np.stack(v) for k, v in annos.items()})
    meta = {"n": n, "nsample": int(nsample), "nch": int(nch),
            "items_per_shard": items_per_shard, "nshards": nshards,
            "dtype": dtype, "anno_keys": anno_keys}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def room_id_of_path(path) -> Optional[int]:
    """Room index of a certain-room tree item: its parent directory is
    ``R{idx}`` (gen_simu_certain_room layout, reference
    gen_simu_certain_room.py:32-423 / opt.py:283-290). None otherwise."""
    import re
    m = re.fullmatch(r"R(\d+)", Path(path).parent.name)
    return int(m.group(1)) if m else None


class _WithRoomColumn:
    """Wrap an annotated dataset to add a per-item 'room' label column."""

    def __init__(self, ds, rooms: Sequence[int]):
        self.ds, self.rooms = ds, rooms

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        wave, annos = self.ds[i]
        return wave, {**annos, "room": np.float32(self.rooms[i])}


def pack_wav_tree(data_dir: str, out_dir: str, nsample: Optional[int] = None,
                  load_anno: bool = True, items_per_shard: int = 512,
                  data_num: Optional[int] = None) -> Dict:
    """Pack a generated wav(+info npz) tree (gen_simu layout). Certain-room
    trees (every item under an ``R{idx}/`` subdir) get a 'room' anno column
    so per-trial room subsets survive packing (run_downstream
    --room-trials)."""
    from .datasets import FixMicSigDataset, Selecting

    tr = [Selecting((0, nsample))] if nsample else []
    ds = FixMicSigDataset(data_dir, load_anno=load_anno, data_num=data_num,
                          transforms=tr)
    if load_anno:
        rooms = [room_id_of_path(p) for p in ds.data_paths]
        if all(r is not None for r in rooms):
            ds = _WithRoomColumn(ds, rooms)
    return pack_dataset(ds, out_dir, items_per_shard)


class PackedDataset:
    """Reader for a packed-shard directory.

    ``__getitem__`` serves the generic dataset protocol (wave or
    (wave, annos)); ``iter_batches`` is the fast path — one fancy-indexed
    memmap read per batch, annotations gathered from RAM-resident columns.
    """

    def __init__(self, data_dir: str, load_anno: Optional[bool] = None):
        with open(os.path.join(data_dir, META_NAME)) as f:
            self.meta = json.load(f)
        self.dir = data_dir
        self.n = self.meta["n"]
        self.ips = self.meta["items_per_shard"]
        self._mm: Dict[int, np.ndarray] = {}
        self.anno_keys = list(self.meta["anno_keys"])
        self.load_anno = (bool(self.anno_keys) if load_anno is None
                          else load_anno)
        if self.load_anno:
            assert self.anno_keys, f"{data_dir} was packed without annos"
        self._annos: Optional[Dict[str, np.ndarray]] = None

    def __len__(self):
        return self.n

    def _shard(self, s: int) -> np.ndarray:
        if s not in self._mm:
            self._mm[s] = np.load(
                os.path.join(self.dir, f"shard_{s:05d}.npy"), mmap_mode="r")
        return self._mm[s]

    def annos(self) -> Dict[str, np.ndarray]:
        """All label columns, concatenated in index order (RAM-resident)."""
        if self._annos is None:
            cols = {k: [] for k in self.anno_keys}
            for s in range(self.meta["nshards"]):
                z = np.load(os.path.join(self.dir,
                                         f"shard_{s:05d}_annos.npz"))
                for k in self.anno_keys:
                    cols[k].append(z[k])
            self._annos = {k: np.concatenate(v) for k, v in cols.items()}
        return self._annos

    def __getitem__(self, idx: int):
        s, j = divmod(int(idx), self.ips)
        wave = np.array(self._shard(s)[j], np.float32)
        if not self.load_anno:
            return wave
        a = self.annos()
        # asarray, not float32(): annotation columns may be vectors
        # (multi-pair TDOA, per-wall absorption)
        return wave, {k: np.asarray(a[k][idx], np.float32)
                      for k in self.anno_keys}

    def batch_indices(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = True,
                      shard_i: int = 0, shard_n: int = 1,
                      subset: Optional[np.ndarray] = None) -> Iterator:
        """The index sequence behind ``iter_batches`` — one sorted (nb,)
        int array per batch. Exposed so device-resident training (the
        whole split staged in HBM, per-epoch index gathers) draws the
        EXACT batches the streaming path would.

        subset: restrict the index universe to these rows (e.g. a fixed
        per-trial training subset); the per-epoch shuffle permutes within
        it. Default is every row of the split."""
        order = (np.arange(self.n) if subset is None
                 else np.asarray(subset, np.int64).copy())
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        chunk = batch_size * shard_n
        if drop_last:
            if len(order) < chunk:
                # e.g. --fixed-train-subset with train_num < bs: silently
                # yielding zero batches would report an untrained model
                raise ValueError(
                    f"index universe of {len(order)} rows yields no full "
                    f"batch (batch_size {batch_size} x {shard_n} hosts) — "
                    f"shrink the batch size or grow the subset")
            order = order[: (len(order) // chunk) * chunk]
        order = order[shard_i::shard_n]
        for lo in range(0, len(order), batch_size):
            idxs = order[lo: lo + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            yield np.sort(idxs)  # sorted gather: sequential page access

    def all_waves(self, nsample: Optional[int] = None,
                  limit: Optional[int] = None) -> np.ndarray:
        """Materialize every waveform (or the first ``limit``), head-cropped
        to nsample — the device-resident staging source (one contiguous
        (n, ns, nch) array)."""
        ns = self.meta["nsample"] if nsample is None else nsample
        n = self.n if limit is None else min(limit, self.n)
        out = np.empty((n, ns, self.meta["nch"]), np.float32)
        for s in range((n + self.ips - 1) // self.ips):
            sh = self._shard(s)
            lo = s * self.ips
            out[lo: min(lo + sh.shape[0], n)] = sh[: n - lo, :ns]
        return out

    def all_waves_i16(self, nsample: Optional[int] = None,
                      limit: Optional[int] = None
                      ) -> Tuple[np.ndarray, float]:
        """``all_waves`` quantized to int16 with one global scale: half the
        device memory of resident staging (a 24,576-utt 4.112 s corpus is
        12.9 GB in f32, 6.5 GB in int16). Quantization noise at the sim
        corpora's 0.9-peak normalization is ~-90 dB, far below the pretext
        training noise floor. Returns (int16 (n, ns, nch), scale);
        dequantize as ``waves.astype(f32) * scale``."""
        w = self.all_waves(nsample, limit=limit)
        # chunked abs-max + in-place scale/round: full-size f32 temporaries
        # would triple the host peak (a 12.9 GB corpus -> ~39 GB RSS)
        gmax = max((float(np.max(np.abs(w[i: i + 1024])))
                    for i in range(0, len(w), 1024)), default=0.0) or 1.0
        np.multiply(w, 32767.0 / gmax, out=w)
        np.round(w, out=w)
        return w.astype(np.int16), gmax / 32767.0

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     seed: int = 0, drop_last: bool = True,
                     shard_i: int = 0, shard_n: int = 1,
                     subset: Optional[np.ndarray] = None) -> Iterator:
        """Stream (wave (nb, nsample, nch)[, labels]) batches.

        shard_i/shard_n: host sharding — host i reads rows i::n of the
        (shuffled) order, trimmed so every host yields the same number of
        equal-size batches.
        """
        a = self.annos() if self.load_anno else None
        for idxs in self.batch_indices(batch_size, shuffle, seed,
                                       drop_last, shard_i, shard_n,
                                       subset=subset):
            waves = np.empty((len(idxs), self.meta["nsample"],
                              self.meta["nch"]), np.float32)
            s_of = idxs // self.ips
            for s in np.unique(s_of):
                sel = s_of == s
                waves[sel] = self._shard(int(s))[idxs[sel] - s * self.ips]
            if a is None:
                yield waves
            else:
                yield waves, {k: a[k][idxs] for k in self.anno_keys}
