#!/usr/bin/env python3
"""Build ``csrc/conv3x3_any_mma_groups.cu`` (``conv3x3_any_mma.cu``'s image
groups) on a CUDA card, print ptxas' report for its kernels, hold the image
groups against the plain version (forward and dx, small, ragged and full
shapes, run to run bit for bit) and time them beside the row-tile kernels
launched directly on the same inputs, cuDNN and the bound; then
``conv3x3_s2d`` on x against its launch on the 2C view with the expanded
weight (its route before).

    python3 scripts/check_conv_groups.py [--out FILE]

The short first check of an edited image-group mode (~1 min with the build);
``chip_smoke.py`` phase ``edges`` is the whole run. ``--out`` also writes
the JSON line of readings there.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BF16_FLOPS, bound_ms, cuda_ms  # noqa: E402
from sarssl_torch.kernels import launches  # noqa: E402
from sarssl_torch.kernels._build import build_all  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, conv3x3_plain,  # noqa: E402
                                          conv_kernel, conv_tiling, launch_conv3x3,
                                          launch_conv3x3_any_mma, launch_conv3x3_mma,
                                          pack_weights, rot180_io)
from sarssl_torch.kernels.conv_s2d import (conv3x3_s2d_dx, conv3x3_s2d_fwd,  # noqa: E402
                                           expand_weights_s2d2)

TOL = 1e-2  # bf16 output rounding, relative to max |plain|
# (N, H, W) x (C, Cout): the GPU tests' shapes and the edges' rows
SMALL = [(1, 1, 1), (7, 1, 1), (300, 1, 1), (33, 3, 5), (9, 5, 17), (5, 2, 4), (4099, 3, 5),
         (3, 9, 21), (2, 16, 16)]
PAIRS = [(64, 64), (3, 64), (128, 128), (13, 24), (64, 128), (96, 160), (256, 256), (5, 3)]
TIMED = [(65600, 4, 8, 64, 64), (65600, 4, 8, 3, 64), (4099, 3, 5, 13, 24), (65600, 2, 4, 64, 64)]


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rows_launch(x, w, rot=False):
    """The row-tile kernel the pair takes without groups, launched directly."""
    C, cout = x.shape[3], (w.shape[2] if rot else w.shape[3])
    if conv_kernel(torch.bfloat16, C, cout) == "tc":
        return launch_conv3x3_mma(x, pack_weights(rot180_io(w) if rot else w), "rows")
    return launch_conv3x3_any_mma(x, w, "rows", rot=rot)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("check_conv_groups: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    log = build_all(["conv3x3_any_mma_groups", "conv3x3_any_mma", "conv3x3_mma",
                     "conv3x3"])["conv3x3_any_mma_groups"]
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?(conv3x3_any_mma_groups_kernel"
                          r"ILi(\d+)ELi(\d+)E)", line)
        if entry:
            kernel = f"groups<{entry.group(2)}, {entry.group(3)}>"
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.strip()[:160]}")
            if "registers" in line:
                kernel = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0

    def rand(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    for N, H, W in SMALL:
        for C, cout in PAIRS:
            x, dy = rand((N, H, W, C)), rand((N, H, W, cout))
            w = rand((3, 3, C, cout), 1 / (3 * C ** 0.5))
            # dx is the conv of dy at (cout, C): its own route
            G = (conv_tiling(torch.bfloat16, H, W, C, cout),
                 conv_tiling(torch.bfloat16, H, W, cout, C))
            before = launches["conv3x3_fwd_tc_groups"], launches["conv3x3_dx_tc_groups"]
            y, gx = conv3x3_fwd(x, w), conv3x3_dx(dy, w)
            rose = (launches["conv3x3_fwd_tc_groups"] - before[0],
                    launches["conv3x3_dx_tc_groups"] - before[1])
            e1 = rel(y, conv3x3_plain(x.float(), w.float()))
            e2 = rel(gx, conv3x3_plain(dy.float(), rot180_io(w).float()))
            same = torch.equal(y, conv3x3_fwd(x, w))
            ok = e1 <= TOL and e2 <= TOL and same and rose == tuple(int(g > 0) for g in G)
            bad += not ok
            print(f"{'ok ' if ok else 'BAD'} ({N}, {H}, {W}) {C} -> {cout} G fwd / dx {G}: "
                  f"fwd {e1:.2e} dx {e2:.2e} run-to-run {same} counted {rose}", flush=True)
    torch.cuda.synchronize()

    res = {"card": card, "rows": {}}
    for N, H, W, C, cout in TIMED:
        x, dy = rand((N, H, W, C)), rand((N, H, W, cout))
        w = rand((3, 3, C, cout), 1 / (3 * C ** 0.5))
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        wo = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = conv3x3_fwd(x, w)
        e = rel(y, conv3x3_plain(x.float(), w.float()))
        same = torch.equal(y, conv3x3_fwd(x, w)) and torch.equal(conv3x3_dx(dy, w),
                                                                 conv3x3_dx(dy, w))
        bad += e > TOL or not same
        nbytes = (N * H * W * (C + cout) + 9 * C * cout) * 2
        bound = bound_ms(nbytes, 2 * 9 * N * H * W * C * cout, BF16_FLOPS)
        r = {"rel_err": e, "run_to_run_identical": same, "bound_ms": bound[0],
             "bound_by": bound[1]}
        # groups, rows, cuDNN, rows, groups: each pair within one window
        for kind, inp, lib in (
                ("fwd", x, lambda: torch.nn.functional.conv2d(xn, wo, padding=1)),
                ("dx", dy, lambda: torch.nn.grad.conv2d_input(xn.shape, wo, dyn, padding=1))):
            grp = (lambda: conv3x3_fwd(x, w)) if kind == "fwd" else (lambda: conv3x3_dx(dy, w))
            rws = lambda: rows_launch(inp, w, rot=kind == "dx")  # noqa: E731
            t = [cuda_ms(f, iters=10, warmup=2) for f in (grp, rws, lib, rws, grp)]
            r[kind] = {"groups_ms": [t[0], t[4]], "rows_ms": [t[1], t[3]], "cudnn_ms": t[2]}
        res["rows"][f"({N}, {H}, {W}) {C}->{cout}"] = r
        print(f"({N}, {H}, {W}) {C} -> {cout}: rel {e:.2e} identical {same}; "
              + "; ".join(f"{k} groups {r[k]['groups_ms'][0]:.4f}/{r[k]['groups_ms'][1]:.4f} "
                          f"rows {r[k]['rows_ms'][0]:.4f}/{r[k]['rows_ms'][1]:.4f} cuDNN "
                          f"{r[k]['cudnn_ms']:.4f}" for k in ("fwd", "dx"))
              + f"; bound {bound[0]:.4f} ({bound[1]})", flush=True)
        del x, dy, xn, dyn, y
        torch.cuda.empty_cache()

    # conv3x3_s2d on x (this tree's route) against its launch on the 2C view
    # with the expanded weight (the route before), one window each in turns
    for C, (N, H, W) in ((32, (16, 64, 64)), (256, (16, 64, 64)), (32, (65600, 4, 8))):
        x, w = rand((N, H, W, C)), rand((3, 3, C, C), 1 / (3 * C ** 0.5))
        ref = conv3x3_plain(x.float(), w.float())
        on_x = lambda: conv3x3_s2d_fwd(x, w)  # noqa: E731
        # the view's launch as the wrapper made it: the expanded weight built
        # each call
        view = lambda: launch_conv3x3(  # noqa: E731
            x.view(N, H, W // 2, 2 * C), expand_weights_s2d2(w), "view")
        e1, e2 = rel(on_x(), ref), rel(view().view(x.shape), ref)
        bad += e1 > TOL or e2 > TOL
        dx_x = lambda: conv3x3_s2d_dx(x, w)  # noqa: E731
        dx_view = lambda: launch_conv3x3(x.view(N, H, W // 2, 2 * C),  # noqa: E731
                                         expand_weights_s2d2(rot180_io(w)), "view")
        t = [cuda_ms(f, iters=20, warmup=2) for f in (on_x, view, view, on_x)]
        td = [cuda_ms(f, iters=20, warmup=2) for f in (dx_x, dx_view, dx_view, dx_x)]
        res["rows"][f"s2d ({N}, {H}, {W}) C={C}"] = {
            "on_x": conv_kernel(torch.bfloat16, C, C, H, W),
            "view": conv_kernel(torch.bfloat16, 2 * C, 2 * C, H, W // 2),
            "fwd_on_x_ms": [t[0], t[3]], "fwd_view_ms": [t[1], t[2]],
            "dx_on_x_ms": [td[0], td[3]], "dx_view_ms": [td[1], td[2]], "rel_err": [e1, e2]}
        print(f"s2d ({N}, {H}, {W}) C = {C}: on x ({conv_kernel(torch.bfloat16, C, C, H, W)}) "
              f"fwd {t[0]:.4f}/{t[3]:.4f} dx {td[0]:.4f}/{td[3]:.4f}; view "
              f"({conv_kernel(torch.bfloat16, 2 * C, 2 * C, H, W // 2)}) fwd {t[1]:.4f}/"
              f"{t[2]:.4f} dx {td[1]:.4f}/{td[2]:.4f}; rel {e1:.2e} / {e2:.2e}", flush=True)
        del x, ref
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print("FAILED" if bad else "OK")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
