"""What ``run_downstream --mp-loader`` costs on a speaker corpus of WSJ0's size.

Builds, under a temporary directory that it removes afterwards:
  * an ACE-layout tree (3 rooms x Chromebook (2 mics) and Mobile (3 mics) x
    2 positions, 48 kHz) and extracts it with ``gen_real_rir``'s ACE
    extractor, as phase real_data of ``chip_smoke.py`` does;
  * a WSJ0-style speaker tree of ``--utts`` utterances over ``--speakers``
    speakers (WSJ0's si_tr_s: 12,776 over 101). Every utterance of a speaker
    is a hard link of one 4.5 s int16 wav, so the tree holds the corpus's
    paths in a few MB.

Then it makes run_downstream's on-the-fly item (``MicSigFromRIRDataset``,
T = 4.112 s, batch 16) through three loaders, each over ``--batches``
batches from its first call on (worker start-up excluded: the pool is
started and warmed before):
  threads      ``batch_iterator`` on ``--workers`` threads;
  pool         ``mp_batch_iterator`` on a pool of ``--workers`` spawned
               processes (the dataset pickled once a call into a file);
  pool_per_item  the same pool, every task carrying the pickled dataset
               beside its index (an earlier dispatch of the port).
It reports the dataset's pickled bytes, the bytes and the parent's seconds
to pickle one batch's tasks under each pool dispatch, s per batch of each
loader, and a cProfile of 16 items made in one process (share of the items'
time per function). The JSON goes to --out and to the last line of stdout.

    python3 scripts/mp_loader_cost.py [--utts 12776] [--speakers 101] \\
        [--workers 8] [--batches 16] [--out chiprun_out/mp_loader_cost.json]
"""
from __future__ import annotations

import os
import sys

# the repo root in place of scripts/, whose profile.py would shadow the
# standard library's (cProfile imports it)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import cProfile  # noqa: E402
import json  # noqa: E402
import multiprocessing as mp  # noqa: E402
import pickle  # noqa: E402
import pstats  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from sarssl_torch.data import (MicSigFromRIRDataset, NpyRIRDataset,  # noqa: E402
                               SpeakerTreeDataset, batch_iterator, mp_batch_iterator)
from sarssl_torch.data.datasets import collate_items  # noqa: E402
from sarssl_torch.data.extractors import EXTRACTORS, ACEExtractor  # noqa: E402

FS, T, BS = 16000, 4.112, 16
ROOMS = ("Office_1", "Office_2", "Meeting_Room_1")
ARRAYS = {"Chromebook": 2, "Mobile": 3}


def _int16_wav(path, sig, fs):
    from scipy.io import wavfile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, fs, np.clip(sig * 32767, -32768, 32767).astype(np.int16))


def _ace_tree(root, rng):
    rows = ["Mic config:, Room decode:, Room config:, Chan:, FB T60:, FB DRR:"]
    for r, room in enumerate(ROOMS):
        for array, nmic in ARRAYS.items():
            for pos in ("1", "2"):
                base = os.path.join(root, "RIRN", array, room, pos)
                t60, n = 0.35 + 0.2 * r, int(1.5 * (0.35 + 0.2 * r) * 48000)
                rir = rng.standard_normal((n, nmic)) * 0.05
                rir *= np.exp(-6.91 * np.arange(n) / (t60 * 48000))[:, None]
                for m in range(nmic):
                    rir[200 + 3 * m, m] = 1.0
                os.makedirs(base)
                from sarssl_torch.data.wavio import write_wav
                write_wav(os.path.join(base, f"{room}_{pos}_RIR.wav"), rir.astype(np.float32),
                          48000)
                _int16_wav(os.path.join(base, f"{room}_{pos}_Noise_Ambient.wav"),
                           rng.standard_normal((6 * 48000, nmic)) * 0.01, 48000)
                rows += [f"{array}, {room}, {pos}, {ch}, {t60:.3f}, {5.0 - 2 * r:.2f}"
                         for ch in range(1, nmic + 1)]
    os.makedirs(os.path.join(root, "Data"))
    with open(os.path.join(root, "Data", ACEExtractor.ANNO_CSV), "w") as f:
        f.write("\n".join(rows) + "\n")


def _speaker_tree(root, rng, utts, speakers):
    for s in range(speakers):
        d = os.path.join(root, f"{s:03x}")
        first = os.path.join(d, f"{s:03x}c0000.wav")
        _int16_wav(first, rng.standard_normal(int(4.5 * FS)) * 0.1, FS)
        for u in range(1, utts // speakers + (s < utts % speakers)):
            os.link(first, os.path.join(d, f"{s:03x}c{u:04x}.wav"))


def _fetch_with_dataset(task):
    dataset, idx = task
    return dataset[int(idx)]


def _per_item_batches(dataset, pool, seed, prefetch=4):
    """mp_batch_iterator's order and prefetch, each task carrying the dataset."""
    order = np.arange(len(dataset))
    np.random.default_rng(seed).shuffle(order)
    batches = [order[s: s + BS] for s in range(0, len(order) - BS + 1, BS)]
    pending = [pool.map_async(_fetch_with_dataset, [(dataset, int(i)) for i in b])
               for b in batches[:prefetch]]
    nxt = prefetch
    while pending:
        items = pending.pop(0).get()
        if nxt < len(batches):
            pending.append(pool.map_async(_fetch_with_dataset,
                                          [(dataset, int(i)) for i in batches[nxt]]))
            nxt += 1
        yield collate_items(items)


def _timed(batches):
    t0 = time.perf_counter()
    got = [b for b in batches]
    return time.perf_counter() - t0, got


def _pickle_cost(tasks, reps=5):
    t0 = time.perf_counter()
    for _ in range(reps):
        nbytes = sum(len(pickle.dumps(t, protocol=pickle.HIGHEST_PROTOCOL)) for t in tasks)
    return nbytes, (time.perf_counter() - t0) / reps


def _profile(ds, n=16):
    prof = cProfile.Profile()
    prof.enable()
    for i in range(n):
        ds[i]
    prof.disable()
    st = pstats.Stats(prof)
    total = st.total_tt
    rows = []
    for (fname, _, func), (_, _, tt, ct, _) in st.stats.items():
        rows.append({"function": f"{os.path.basename(fname)}:{func}", "tottime_share":
                     tt / total, "cumtime_share": ct / total})
    top = sorted(rows, key=lambda r: -r["tottime_share"])[:8]
    named = {r["function"]: r["cumtime_share"] for r in rows if r["function"] in (
        "annotations.py:t60_from_rir", "_stats_py.py:linregress", "_signaltools.py:fftconvolve",
        "_upfirdn.py:upfirdn", "_signaltools.py:resample_poly", "wavio.py:read_wav",
        "real_rir.py:get", "sources.py:sample", "annotations.py:drr", "annotations.py:c50")}
    return {"items": n, "seconds": total, "top_by_own_time": top, "cumulative_share": named}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=12776)
    ap.add_argument("--speakers", type=int, default=101)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/mp_loader_cost.json")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="mp_loader_cost_")
    try:
        rng = np.random.default_rng(0)
        _ace_tree(os.path.join(tmp, "ace"), rng)
        EXTRACTORS["ACE"](os.path.join(tmp, "ace")).extract(os.path.join(tmp, "rir"))
        _speaker_tree(os.path.join(tmp, "src"), rng, args.utts, args.speakers)
        srcs = SpeakerTreeDataset(os.path.join(tmp, "src"), T=T, fs=FS)
        ds = MicSigFromRIRDataset(NpyRIRDataset(os.path.join(tmp, "rir"), fs=FS), srcs, T=T,
                                  fs=FS, seed=8, length=args.batches * BS)
        res = {"utterances": len(srcs), "speakers": len(srcs.speakers),
               "rirs": len(ds.rirs), "workers": args.workers, "batch": BS,
               "batches": args.batches, "T": T,
               "dataset_pickled_bytes": len(pickle.dumps(ds, protocol=pickle.HIGHEST_PROTOCOL))}
        b0 = range(BS)
        res["pool_per_item_batch_bytes"], res["pool_per_item_batch_pickle_s"] = \
            _pickle_cost([(ds, i) for i in b0])
        res["pool_batch_bytes"], res["pool_batch_pickle_s"] = \
            _pickle_cost([(os.path.join(tmp, "sarssl_loader_x.pkl"), i) for i in b0])
        t0 = time.perf_counter()
        pickle.dumps(ds, protocol=pickle.HIGHEST_PROTOCOL)
        res["pool_call_pickle_s"] = time.perf_counter() - t0
        res["profile"] = _profile(ds)

        with mp.get_context("spawn").Pool(args.workers) as pool:
            pool.map(int, range(4 * args.workers))  # every worker up before timing
            runs = {}
            s, runs["threads"] = _timed(batch_iterator(ds, BS, seed=3,
                                                       num_workers=args.workers))
            res["threads_s_per_batch"] = s / args.batches
            s, runs["pool"] = _timed(mp_batch_iterator(ds, BS, seed=3, pool=pool,
                                                       num_workers=args.workers))
            res["pool_s_per_batch"] = s / args.batches
            s, runs["pool_per_item"] = _timed(_per_item_batches(ds, pool, seed=3))
            res["pool_per_item_s_per_batch"] = s / args.batches
        for name in ("pool", "pool_per_item"):  # the same items, whatever the loader
            for (w, lab), (wt, labt) in zip(runs[name], runs["threads"]):
                np.testing.assert_array_equal(w, wt)
                for k in labt:
                    np.testing.assert_array_equal(lab[k], labt[k])
        res["threads_over_pool"] = res["threads_s_per_batch"] / res["pool_s_per_batch"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
