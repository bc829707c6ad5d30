#!/usr/bin/env python3
"""Build the port's conv kernels on a CUDA card, print ptxas' report for the
tensor-core kernel, hold every instance against the plain version at small,
ragged and full shapes, and time the launches beside the FMA kernel.

    python3 scripts/check_conv_kernels.py

The short first check of an edited ``csrc/conv3x3_mma.cu``; ``chip_smoke.py``
is the whole run.
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sarssl_torch.kernels._build import build_all  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, conv3x3_plain,  # noqa: E402
                                          launch_conv3x3_fma, launch_conv3x3_mma,
                                          pack_weights, rot180_io)
from sarssl_torch.kernels.conv_s2d import (conv3x3_s2d_dx, conv3x3_s2d_fwd,  # noqa: E402
                                           conv3x3_s2d_plain)

TOL = 1e-2  # bf16 output rounding, relative to max |plain|


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def ms(fn, iters=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    logs = build_all(["conv3x3_mma", "conv3x3", "attention_mma"])
    for line in logs["conv3x3_mma"].splitlines():
        if "conv3x3_mma_kernel" in line or "registers" in line or "spill" in line:
            print(line.strip()[:200])
    bad = check()
    print("FAILED" if bad else "OK")
    sys.exit(1 if bad else 0)


def check():
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0

    def rand(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    shapes = [(1, 1, 1), (1, 2, 2), (2, 15, 17), (2, 16, 32), (3, 17, 33), (2, 37, 50),
              (1, 40, 70)]
    for C, CO in ((64, 64), (128, 128), (64, 128), (128, 64)):
        for N, H, W in shapes:
            x, dy, w = rand((N, H, W, C)), rand((N, H, W, CO)), rand((3, 3, C, CO), 0.05)
            e1 = rel(conv3x3_fwd(x, w), conv3x3_plain(x.float(), w.float()))
            e2 = rel(conv3x3_dx(dy, w), conv3x3_plain(dy.float(), rot180_io(w).float()))
            bad += e1 > TOL or e2 > TOL
            print(f"conv3x3 ({C},{CO}) {(N, H, W)}: fwd {e1:.2e} dx {e2:.2e}")
    for N, H, W in shapes:
        x, w = rand((N, H, 2 * W, 64)), rand((3, 3, 64, 64), 0.05)
        e1 = rel(conv3x3_s2d_fwd(x, w), conv3x3_s2d_plain(x.float(), w.float()))
        e2 = rel(conv3x3_s2d_dx(x, w), conv3x3_s2d_plain(x.float(), rot180_io(w).float()))
        bad += e1 > TOL or e2 > TOL
        print(f"conv3x3_s2d {(N, H, 2 * W)}: fwd {e1:.2e} dx {e2:.2e}")
    torch.cuda.synchronize()

    full = (128, 256, 256, 64)
    x, w = rand(full), rand((3, 3, 64, 64), 0.05)
    ref = conv3x3_plain(x.float(), w.float())
    for name, fn in (("conv3x3_fwd", conv3x3_fwd), ("conv3x3_s2d_fwd", conv3x3_s2d_fwd)):
        out = fn(x, w)
        e = rel(out, ref)
        same = torch.equal(out, fn(x, w))
        bad += e > TOL or not same
        print(f"{name} {full}: rel err {e:.2e}, run-to-run identical {same}")
    del ref
    packed = pack_weights(w)
    flop = 2 * x.numel() * 64 * 9
    for name, fn in (
            ("conv3x3 launch", lambda: launch_conv3x3_mma(x, packed, "t")),
            ("conv3x3_fwd", lambda: conv3x3_fwd(x, w)),
            ("conv3x3_dx", lambda: conv3x3_dx(x, w)),
            ("conv3x3_s2d_fwd", lambda: conv3x3_s2d_fwd(x, w)),
            ("conv3x3_s2d_dx", lambda: conv3x3_s2d_dx(x, w)),
            ("FMA conv3x3", lambda: launch_conv3x3_fma(x, w, "t"))):
        t = ms(fn, 5 if "FMA" in name else 20)
        print(f"{name}: {t:.4f} ms, {flop / t / 1e9:.1f} TFLOP/s, "
              f"{2 * x.numel() * 2 / t / 1e9:.3f} TB/s")
    return bad


if __name__ == "__main__":
    main()
