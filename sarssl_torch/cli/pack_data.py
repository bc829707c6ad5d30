"""Pack a generated wav(+info) tree into contiguous shards (port of
``sarssl_tpu/cli/pack_data.py``; either package reads the other's packed
directory).

One-time conversion (data/shards.py): per-file wav decode becomes page-cached
memmap gathers. The packed directory is accepted anywhere the CLIs take
--data-dir.

Usage:
  python -m sarssl_torch.cli.pack_data --data-dir data/simu/train \
      --out data/simu/train_packed [--nsample 65792] [--no-anno]
"""
from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser("sarssl_torch pack_data")
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--nsample", type=int, default=None,
                   help="crop length (default: native file length)")
    p.add_argument("--data-num", type=int, default=None)
    p.add_argument("--items-per-shard", type=int, default=512)
    p.add_argument("--no-anno", action="store_true",
                   help="pack waveforms only (pretraining corpora)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data.shards import pack_wav_tree

    meta = pack_wav_tree(args.data_dir, args.out, nsample=args.nsample,
                         load_anno=not args.no_anno,
                         items_per_shard=args.items_per_shard,
                         data_num=args.data_num)
    gb = meta["n"] * meta["nsample"] * meta["nch"] * 4 / 1e9
    print(f"packed {meta['n']} items into {meta['nshards']} shards "
          f"({gb:.2f} GB) at {args.out}; anno keys: {meta['anno_keys']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
