#!/usr/bin/env python3
"""Device time of each kernel of the wide attention forward at a small batch.

    python3 scripts/profile_wide_forward.py [--batch 8] [--head-dims 300 1000]
        [--splits S ...] [--launches 5]

At (B, 4, 256, D), rate 0.1, in bf16 and f32, each D padded as
``fused_attention`` pads it (300 -> 320, 1000 -> 1024): a ``torch.profiler``
trace of ``--launches`` forward launches gives each kernel's device ms a
launch, and CUDA events the forward's ms queued behind a sleeping kernel
(``chip_smoke.py::cuda_ms_queued``), and back to back (``cuda_ms``).
``--splits`` forces the number of key splits of the scores pass (the
launcher's private ``splits``), each in turn; without it the launcher
chooses. The trace's other device kernels, if any, are listed beside. Prints
the card's name and power limit first.
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from sarssl_torch.kernels import attention  # noqa: E402


def profile(fwd, launches):
    """{kernel name: device ms a launch} of ``launches`` calls of ``fwd``."""
    fwd()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fwd()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"attn_\w+", evt.name)
            name = name.group(0) if name else evt.name[:60]
            per[name] = per.get(name, 0.0) + evt.device_time_total / 1e3
    return {n: ms / launches for n, ms in per.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--head-dims", type=int, nargs="+", default=[300, 1000])
    ap.add_argument("--splits", type=int, nargs="+", default=None,
                    help="force these numbers of key splits, each in turn")
    ap.add_argument("--launches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = 0x9E3779B9
    for dtype in (torch.bfloat16, torch.float32):
        for D in args.head_dims:
            Dp = attention.padded_head_dim(D)
            qu, k, v, bias, _ = cs._attention_inputs(Dp, dtype, gen, cs.SEQ, args.batch)
            route = attention.attention_route(dtype, cs.SEQ, Dp)
            call = (seed, 1.0 / np.sqrt(cs.HEADS * D), cs.RATE)
            for s in args.splits or [None]:
                fwd = lambda: attention._launch_fwd(route, qu, k, v, bias, *call,  # noqa: E731
                                                    splits=s)
                per = profile(fwd, args.launches)
                ms, back = cs.cuda_ms_queued(fwd), cs.cuda_ms(fwd)
                print(f"({args.batch}, {cs.HEADS}, {cs.SEQ}, {D} -> {Dp}) {str(dtype)[6:]} "
                      f"splits {'chosen' if s is None else s}: forward {ms:.4f} ms queued, "
                      f"{back:.4f} back to back; device ms a launch: "
                      + (", ".join(f"{n} {t:.4f}" for n, t in per.items()) or "none recorded"),
                      flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
