#!/usr/bin/env python3
"""Time one tree's hand-written kernels at the shapes of the kernel table's
rows (PERF.md §6), each launch queued behind a sleeping kernel, so that two
trees' kernels can be held against each other in one call on one card
(parent, change, change, parent).

    python3 scripts/time_tree_kernels.py [--root DIR] [--out FILE]

``--root`` runs the kernels of another tree (e.g. a parent commit unpacked
with ``git archive``), built there; the timing itself is this tree's
``chip_smoke.cuda_ms_queued``. Prints one JSON line: ms a launch by row.
Rows: attention bf16 (128, 4, 256, D) at D = 128 and 64, f32 at D = 128,
bf16 at D = 512 (wide), rate 0.1, forward and backward; hash_dropout at
(128, 256, 2048) bf16; the lane-seeded launch at (8, 8, 64, 2048) f32 (also
back to back, where the host's launch time sets it); conv3x3 forward and
conv3x3_s2d dx at (128, 256, 256, 64) bf16.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="the tree whose kernels run")
    ap.add_argument("--out", type=Path, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_tree_kernels: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, cuda_ms_queued  # noqa: E402  (this tree's timing)

    sys.path.insert(0, str(args.root.resolve()))  # chip_smoke imports no sarssl_torch at the top
    from sarssl_torch.kernels import attention as A  # noqa: E402
    from sarssl_torch.kernels.conv3x3 import conv3x3_fwd  # noqa: E402
    from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx  # noqa: E402
    from sarssl_torch.kernels.dropout import launch_dropout, launch_dropout_lanes  # noqa: E402

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed, rate, ms = 0x9E3779B9, 0.1, {}
    for D, dtype in ((128, torch.bfloat16), (64, torch.bfloat16), (128, torch.float32),
                     (512, torch.bfloat16)):
        shape = (128, 4, 256, D)
        qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        bias = torch.randn((128, 4, 256, 256), generator=gen, device="cuda").to(dtype)
        fwd, bwd = A._TC_LAUNCHES[A.attention_route(dtype, 256, D)]
        scale = (4 * D) ** -0.5
        out, lse = fwd(qu, k, v, bias, seed, scale, rate)
        tag = f"attention_d{D}_{str(dtype)[6:]}"
        ms[f"{tag}_fwd"] = cuda_ms_queued(lambda: fwd(qu, k, v, bias, seed, scale, rate))
        ms[f"{tag}_bwd"] = cuda_ms_queued(
            lambda: bwd(qu, k, v, bias, g, out, lse, seed, scale, rate))
        del qu, k, v, g, bias, out, lse
    x = torch.randn((128, 256, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    ms["hash_dropout"] = cuda_ms_queued(lambda: launch_dropout(x, seed, rate))
    lanes = torch.randn((8, 8, 64, 2048), generator=gen, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (8,), generator=gen, device="cuda")
    ms["hash_dropout_lanes"] = cuda_ms_queued(lambda: launch_dropout_lanes(lanes, seeds, rate))
    # back to back, where the host's launch time sets it (chip_smoke's launch_ms)
    ms["hash_dropout_lanes_launch"] = cuda_ms(lambda: launch_dropout_lanes(lanes, seeds, rate))
    xc = torch.randn((128, 256, 256, 64), generator=gen, device="cuda").to(torch.bfloat16)
    wc = (torch.randn((3, 3, 64, 64), generator=gen, device="cuda") / 24).to(torch.bfloat16)
    ms["conv3x3_fwd"] = cuda_ms_queued(lambda: conv3x3_fwd(xc, wc), iters=10)
    ms["conv3x3_s2d_dx"] = cuda_ms_queued(lambda: conv3x3_s2d_dx(xc, wc), iters=10)
    line = json.dumps({"tree": str(args.root.resolve()), "card": torch.cuda.get_device_name(0),
                       "ms": ms})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
