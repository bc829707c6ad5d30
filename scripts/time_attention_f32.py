#!/usr/bin/env python3
"""Time the f32 attention route (the 3xTF32 kernels of
``csrc/attention_f32_mma.cu``) at the full f32 shapes: batch 128, 4 heads,
dropout 0.1, L = 256 at D = 128 and 64, L = 512 at D = 64.

    python3 scripts/time_attention_f32.py [--root DIR] [--label NAME]

``--root`` imports ``sarssl_torch`` from another checkout (default: this
one), which builds its own kernels into its own ``_build``. So two versions
of the kernels are compared in one call on one card by running this script
for each in turns (A, B, B, A). Each time is the mean device time of 20
launches queued behind a sleeping kernel (CUDA events), after 3 warm-ups.
Prints one JSON line.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((256, 128), (512, 64), (256, 64))  # (L, D)
BATCH, HEADS, RATE, SEED = 128, 4, 0.1, 0x9E3779B9


def cuda_ms_queued(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose sarssl_torch is timed")
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from sarssl_torch.kernels.attention import (launch_attention_bwd_tf32,
                                                launch_attention_fwd_tf32)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for L, D in SHAPES:
        qu, k, v, g = (torch.randn((BATCH, HEADS, L, D), generator=gen, device="cuda")
                       for _ in range(4))
        bias = torch.randn((BATCH, HEADS, L, L), generator=gen, device="cuda")
        a = (SEED, 1.0 / (HEADS * D) ** 0.5, RATE)
        out, lse = launch_attention_fwd_tf32(qu, k, v, bias, *a)
        rows.append({"L": L, "D": D,
                     "fwd_ms": cuda_ms_queued(torch, lambda: launch_attention_fwd_tf32(
                         qu, k, v, bias, *a)),
                     "bwd_ms": cuda_ms_queued(torch, lambda: launch_attention_bwd_tf32(
                         qu, k, v, bias, g, out, lse, *a))})
        del qu, k, v, g, bias, out, lse
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": args.root, "card": card, "rows": rows}),
          flush=True)


if __name__ == "__main__":
    main()
