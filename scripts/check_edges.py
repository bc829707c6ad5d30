#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s card, build and edges phases alone on one CUDA
card: the inputs the hand-written kernels take past one launch's grid or
32-bit offsets, each held against its plain version and timed (about 1-2
minutes with the build; tensors of up to 17 GiB, ~64 GiB at once).

    python3 scripts/check_edges.py [--out FILE]

``--out`` also writes the edges' rows of the ``kernels`` line, as JSON, to
FILE. The short check of an edited kernel wrapper's launch planning;
``chip_smoke.py`` is the whole run.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the edges' rows here as JSON")
    args = ap.parse_args()
    if not chip_smoke.torch.cuda.is_available():
        sys.exit("check_edges: torch.cuda.is_available() is False; this script needs a GPU")
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    rows = chip_smoke.phase_edges()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"kernels": rows}, indent=1))
    print(json.dumps({"edges": len(rows), "ok": True}))


if __name__ == "__main__":
    main()
