"""Microphone signals from extracted real RIRs (port of
``sarssl_tpu/cli/gen_sig_from_real_rir.py``: the same flags and seeds write
the same tree).

Equivalent of the reference's ``data_generation/gen_sig_from_real_rir.py``:
convolve source speech (WSJ0-style speaker tree) with extracted 2-channel
real RIRs (``SP*_MP*.npy`` trees from the corpus extractors), add matched
recorded noise when present, and write reference-compatible
``{idx}.wav`` / ``{idx}_info.npz`` trees (102,400 pretrain / 2,560 preval
per corpus in the reference, :327-330).

Room-level train/val splits (reference :350-387) are applied automatically
when ``--corpus`` is given: DCASE and BUTReverb hold rooms out for preval;
the other corpora are pretrain-only, and asking for a stage a corpus has no
rooms for is an error — this is what prevents room leakage between pretrain
and preval.

Usage:
  python -m sarssl_torch.cli.gen_sig_from_real_rir --corpus DCASE \
      --rir-dir rirs/DCASE --src-dir wsj0/tr --save-dir out \
      --num 102400 --stage pretrain
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .gen_simu import STAGE_SEEDS

# per-corpus seed offsets, reference gen_sig_from_real_rir.py:332,424
CORPUS_ORDER = ["DCASE", "MIR", "MeshRIR", "dEchorate", "BUTReverb", "ACE"]


def main(argv=None):
    p = argparse.ArgumentParser("sarssl_torch gen_sig_from_real_rir")
    p.add_argument("--rir-dir", required=True)
    p.add_argument("--src-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--num", type=int, required=True)
    p.add_argument("--stage", default="pretrain", choices=list(STAGE_SEEDS))
    p.add_argument("--corpus", default=None, choices=CORPUS_ORDER,
                   help="apply this corpus's room train/val split and seed "
                        "offset")
    p.add_argument("--T", type=float, default=4.112)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--rooms", type=str, nargs="*", default=None,
                   help="explicit room subdirs (overrides --corpus split)")
    p.add_argument("--snr-range", type=float, nargs=2, default=[15.0, 30.0])
    args = p.parse_args(argv)

    from ..data.extractors import rooms_for_stage
    from ..data.real_rir import NpyRIRDataset, MicSigFromRIRDataset
    from ..data.sources import SpeakerTreeDataset
    from ..data.wavio import write_wav

    rooms = args.rooms
    seed = STAGE_SEEDS[args.stage]
    if args.corpus is not None:
        if rooms is None:
            rooms = rooms_for_stage(args.corpus, args.stage)
        seed = int(seed + CORPUS_ORDER.index(args.corpus) * 10e6)

    rirs = NpyRIRDataset(args.rir_dir, fs=args.fs, rooms=rooms)
    srcs = SpeakerTreeDataset(args.src_dir, T=args.T, fs=args.fs)
    ds = MicSigFromRIRDataset(rirs, srcs, T=args.T, fs=args.fs,
                              snr_range=tuple(args.snr_range),
                              seed=seed, length=args.num)
    os.makedirs(args.save_dir, exist_ok=True)
    for i in range(args.num):
        sig, annos = ds[i]
        write_wav(os.path.join(args.save_dir, f"{i}.wav"), sig, args.fs)
        np.savez(os.path.join(args.save_dir, f"{i}_info.npz"), **annos)
        if (i + 1) % 1000 == 0:
            print(f"{i + 1}/{args.num}")
    print(f"wrote {args.num} items to {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
