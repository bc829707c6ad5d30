"""Real-RIR extraction CLI (port of ``sarssl_tpu/cli/gen_real_rir.py``: the
same flags and the same output tree).

Equivalent of the reference's ``data_generation/gen_real_rir.py``: run a
per-corpus extractor over a downloaded corpus tree, writing the reference
schema ``<room>/<array>/SP*_MP*-a-b.npy`` pair RIRs (+ info npz, matched
noise wavs).

Usage:
  python -m sarssl_torch.cli.gen_real_rir --corpus ACE \
      --data-dir corpora/ACE --save-dir rirs/ACE --data-type rir noise
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..data.extractors import EXTRACTORS

    p = argparse.ArgumentParser("sarssl_torch gen_real_rir")
    p.add_argument("--corpus", required=True, nargs="+",
                   choices=sorted(EXTRACTORS))
    p.add_argument("--data-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--data-type", nargs="+", default=["rir", "noise"],
                   choices=["rir", "noise"])
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--mic-dist-range", type=float, nargs=2,
                   default=[0.03, 0.20])
    args = p.parse_args(argv)

    total = 0
    for corpus in args.corpus:
        ex = EXTRACTORS[corpus](args.data_dir, fs=args.fs,
                                mic_dist_range=tuple(args.mic_dist_range))
        counts = ex.extract(args.save_dir, what=tuple(args.data_type))
        total += sum(counts.values())
    return 0 if total > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
