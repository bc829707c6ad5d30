"""Materialize LOCATA train/val/test wav+npz trees (port of
``sarssl_tpu/cli/gen_locata.py``: the same flags and seed write the same
tree).

Equivalent of the reference's ``data_generation/gen_LOCATA.py``: draws
random crops from the LOCATA corpus via LOCATADataset and writes
``{idx}.wav`` + ``{idx}_info.npz`` (TDOA only) trees consumable by
FixMicSigDatasetLOCATA.

Usage:
  python -m sarssl_torch.cli.gen_locata --data-dir LOCATA --save-dir out \
      --stage train --num 80000
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser("sarssl_torch gen_locata")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--stage", default="train", choices=["train", "val", "test"])
    p.add_argument("--num", type=int, required=True)
    p.add_argument("--T", type=float, default=1.04)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--tasks", type=int, nargs="+", default=[1, 3, 5])
    p.add_argument("--arrays", type=str, nargs="+",
                   default=["dicit", "benchmark2"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..data.locata import LOCATADataset
    from ..data.wavio import write_wav

    ds = LOCATADataset(args.data_dir, T=args.T, fs=args.fs, stage=args.stage,
                       tasks=args.tasks, arrays=args.arrays, seed=args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    for i in range(args.num):
        sig, anno = ds[i]
        write_wav(os.path.join(args.save_dir, f"{i}.wav"), sig, args.fs)
        np.savez(os.path.join(args.save_dir, f"{i}_info.npz"), **anno)
        if (i + 1) % 1000 == 0:
            print(f"{i + 1}/{args.num}")
    print(f"wrote {args.num} items to {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
