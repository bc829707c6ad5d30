#!/usr/bin/env python3
"""Build ``csrc/conv3x3_any_mma_groups.cu`` (``conv3x3_any_mma.cu``'s image
groups) on a CUDA card, print ptxas' report for its kernels, hold the image
groups against the plain version (forward and dx, small, ragged and full
shapes, run to run bit for bit) and time them beside the row-tile kernels
launched directly on the same inputs, cuDNN and the bound; then
``conv3x3_s2d`` on x against its launch on the 2C view with the expanded
weight (its route before).

With ``--dtype float32`` the same for the 3xTF32 kernels
(``csrc/conv3x3_tf32.cu`` and its image groups ``conv3x3_tf32_groups.cu``),
row tiles and image groups alike, within 1e-4 of the plain f32 version; then
their error against the float64 conv at K = 9 C up to 18432 beside the FMA
kernel's, and the groups against the row tiles at small images, with cuDNN in
f32 (TF32 off), the FMA kernel launched directly and the bound.

    python3 scripts/check_conv_groups.py [--dtype bfloat16|float32] [--out FILE]

The short first check of an edited image-group mode or f32 kernel (~1-2 min
with the build); ``chip_smoke.py`` phases ``kernels`` and ``edges`` are the
whole run. ``--out`` also writes the JSON line of readings there.
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

from chip_smoke import (BF16_FLOPS, TF32_FLOPS, TF32_SPLIT, bound_ms,  # noqa: E402
                        cuda_ms)
from sarssl_torch.kernels import launches  # noqa: E402
from sarssl_torch.kernels._build import build_all  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (CHANNELS, conv3x3_dx, conv3x3_fwd,  # noqa: E402
                                          conv3x3_plain, conv3x3_tf32x3, conv_kernel,
                                          conv_tiling, launch_conv3x3, launch_conv3x3_any,
                                          launch_conv3x3_any_mma, launch_conv3x3_fma,
                                          launch_conv3x3_mma, launch_conv3x3_tf32,
                                          pack_weights, rot180_io)
from sarssl_torch.kernels.conv_s2d import (conv3x3_s2d_dx, conv3x3_s2d_fwd,  # noqa: E402
                                           expand_weights_s2d2)

TOL = 1e-2  # bf16 output rounding, relative to max |plain|
# (N, H, W) x (C, Cout): the GPU tests' shapes and the edges' rows
SMALL = [(1, 1, 1), (7, 1, 1), (300, 1, 1), (33, 3, 5), (9, 5, 17), (5, 2, 4), (4099, 3, 5),
         (3, 9, 21), (2, 16, 16)]
PAIRS = [(64, 64), (3, 64), (128, 128), (13, 24), (64, 128), (96, 160), (256, 256), (5, 3)]
TIMED = [(65600, 4, 8, 64, 64), (65600, 4, 8, 3, 64), (4099, 3, 5, 13, 24), (65600, 2, 4, 64, 64)]
TOL_F32 = 1e-4  # f32 against f32, the sums in another order, relative to max |plain|
# float32: more channel pairs (C % 4 != 0, Cout odd), more tile edges
F32_SMALL = SMALL + [(1, 17, 34), (2, 19, 37), (1, 33, 2)]
F32_PAIRS = [(64, 64), (3, 64), (13, 24), (64, 48), (96, 160), (256, 256), (5, 3), (33, 7)]
# float32: the image sizes where the groups and the row tiles are timed
# against each other, and C of the error against float64
F32_TIMED = TIMED + [(32800, 8, 8, 64, 64), (8200, 12, 20, 64, 64), (8200, 16, 16, 64, 64)]
F64_C = [64, 128, 256, 512, 1024, 2048]


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rows_launch(x, w, rot=False):
    """The row-tile kernel the pair takes without groups, launched directly."""
    C, cout = x.shape[3], (w.shape[2] if rot else w.shape[3])
    if conv_kernel(torch.bfloat16, C, cout) == "tc":
        return launch_conv3x3_mma(x, pack_weights(rot180_io(w) if rot else w), "rows")
    return launch_conv3x3_any_mma(x, w, "rows", rot=rot)


def ptxas_report(log, pattern):
    """ptxas' registers and spills of each instance of the kernels `pattern`
    names (its first group: the kernel; then NB and KT)."""
    kernel = None
    for line in log.splitlines():
        entry = re.search(rf"Compiling entry function '.*?({pattern})ILi(\d+)ELi(\d+)E", line)
        if entry:
            kernel = f"{entry.group(1)}<{entry.group(entry.lastindex - 1)}, " \
                     f"{entry.group(entry.lastindex)}>"
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.strip()[:160]}")
            if "registers" in line:
                kernel = None
        elif "serialized" in line:
            print(f"  {line.strip()[:200]}")


def fma_launch(x, w):
    """conv3x3.cu's f32 kernel for the pair, launched directly (the yardstick)."""
    if (x.shape[3], w.shape[3]) in CHANNELS:
        return launch_conv3x3_fma(x, w, "fma")
    return launch_conv3x3_any(x, w, "fma_any")


def conv64(x, w):
    """The conv in float64 (cuDNN), NHWC."""
    return torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                      w.double().permute(3, 2, 0, 1), padding=1
                                      ).permute(0, 2, 3, 1)


def check_f32(card, gen):
    """The 3xTF32 kernels: small and ragged shapes through conv3x3_fwd /
    conv3x3_dx (counted, against the plain f32 version and the 3xTF32 plain
    version, run to run), rows and groups launched directly at the same
    shapes, the error against float64, and the times. Returns (failures,
    readings)."""
    ptxas_report("\n".join(build_all(["conv3x3_tf32", "conv3x3_tf32_groups",
                                       "conv3x3"]).values()),
                 "conv3x3_tf32_(groups_)?kernel")
    bad = 0

    def rand(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    for N, H, W in F32_SMALL:
        for C, cout in F32_PAIRS:
            x, dy = rand((N, H, W, C)), rand((N, H, W, cout))
            w = rand((3, 3, C, cout), 1 / (3 * C ** 0.5))
            G = (conv_tiling(torch.float32, H, W, C, cout),
                 conv_tiling(torch.float32, H, W, cout, C))
            tags = [f"conv3x3_{k}_tf32" + ("_groups" if g else "")
                    for k, g in zip(("fwd", "dx"), G)]
            before = [launches[t] for t in tags]
            y, gx = conv3x3_fwd(x, w), conv3x3_dx(dy, w)
            rose = tuple(launches[t] - b for t, b in zip(tags, before))
            e1 = rel(y, conv3x3_plain(x, w))
            e2 = rel(gx, conv3x3_plain(dy, rot180_io(w)))
            p1 = rel(y, conv3x3_tf32x3(x, w, G[0]))
            p2 = rel(gx, conv3x3_tf32x3(dy, rot180_io(w), G[1]))
            same = torch.equal(y, conv3x3_fwd(x, w))
            ok = e1 <= TOL_F32 and e2 <= TOL_F32 and same and rose == (1, 1)
            bad += not ok
            print(f"{'ok ' if ok else 'BAD'} ({N}, {H}, {W}) {C} -> {cout} G fwd / dx {G}: "
                  f"f32 plain fwd {e1:.2e} dx {e2:.2e}, 3xTF32 plain {p1:.2e} / {p2:.2e}, "
                  f"run-to-run {same}, counted {rose}", flush=True)
    for N, H, W, C, cout in ((9, 4, 8, 40, 24), (7, 3, 5, 64, 64)):  # both modes, launched directly
        x, w = rand((N, H, W, C)), rand((3, 3, C, cout), 1 / (3 * C ** 0.5))
        ref = conv3x3_plain(x, w)
        for G in (0, conv_tiling(torch.float32, H, W, C, cout), 1):
            e = rel(launch_conv3x3_tf32(x, w, "direct", groups=G), ref)
            bad += e > TOL_F32
            print(f"{'ok ' if e <= TOL_F32 else 'BAD'} ({N}, {H}, {W}) {C} -> {cout} groups {G}: "
                  f"{e:.2e}", flush=True)

    res = {"card": card, "float64": {}, "rows": {}}
    for C in F64_C:  # the error against float64, beside the FMA kernel's
        for dist in ("normal", "positive"):
            if dist == "normal":
                x, w = rand((2, 16, 16, C)), rand((3, 3, C, 32), 1 / (3 * C ** 0.5))
            else:
                x = torch.rand((2, 16, 16, C), generator=gen, device="cuda")
                w = torch.rand((3, 3, C, 32), generator=gen, device="cuda") / (9 * C)
            ref = conv64(x, w)
            for G in (0, 1):
                r = {"tf32": rel(launch_conv3x3_tf32(x, w, "f64", groups=G), ref),
                     "fma": rel(fma_launch(x, w), ref)}
                bad += r["tf32"] > TOL_F32
                res["float64"][f"C={C} {dist} groups={G}"] = r
                print(f"against float64 C = {C} (K = {9 * C}) {dist} "
                      f"{'groups' if G else 'rows'}: 3xTF32 {r['tf32']:.2e}, FMA kernel "
                      f"{r['fma']:.2e} (relative to max |float64|)", flush=True)
    torch.cuda.empty_cache()

    for N, H, W, C, cout in F32_TIMED:
        x, dy = rand((N, H, W, C)), rand((N, H, W, cout))
        w = rand((3, 3, C, cout), 1 / (3 * C ** 0.5))
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        wo = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = (N * H * W * (C + cout) + 9 * C * cout) * 4
        bound = bound_ms(nbytes, TF32_SPLIT * 2 * 9 * N * H * W * C * cout, TF32_FLOPS)
        r = {"bound_ms": bound[0], "bound_by": bound[1],
             "kernel": [conv_kernel(torch.float32, C, cout, H, W),
                        conv_kernel(torch.float32, cout, C, H, W)]}
        # groups, rows, cuDNN, rows, groups: each pair within one window
        for kind, inp, wk, rot, lib in (
                ("fwd", x, w, False, lambda: torch.nn.functional.conv2d(xn, wo, padding=1)),
                ("dx", dy, rot180_io(w).contiguous(), True,
                 lambda: torch.nn.grad.conv2d_input(xn.shape, wo, dyn, padding=1))):
            G = max(conv_tiling(torch.float32, H, W, inp.shape[3], wk.shape[3]), 1)
            grp = lambda: launch_conv3x3_tf32(inp, w, "g", rot=rot, groups=G)  # noqa: E731
            rws = lambda: launch_conv3x3_tf32(inp, w, "r", rot=rot)  # noqa: E731
            e = rel(grp(), conv3x3_plain(inp, wk))
            bad += e > TOL_F32
            t = [cuda_ms(f, iters=10, warmup=2) for f in (grp, rws, lib, rws, grp)]
            fma = cuda_ms(lambda: fma_launch(inp, wk), iters=2, warmup=1)
            r[kind] = {"groups_ms": [t[0], t[4]], "rows_ms": [t[1], t[3]], "cudnn_ms": t[2],
                       "fma_ms": fma, "G": G, "rel_err": e}
        res["rows"][f"({N}, {H}, {W}) {C}->{cout}"] = r
        print(f"({N}, {H}, {W}) {C} -> {cout} ({r['kernel']}): "
              + "; ".join(f"{k} groups of {r[k]['G']} {r[k]['groups_ms'][0]:.4f}/"
                          f"{r[k]['groups_ms'][1]:.4f} rows {r[k]['rows_ms'][0]:.4f}/"
                          f"{r[k]['rows_ms'][1]:.4f} cuDNN f32 {r[k]['cudnn_ms']:.4f} FMA "
                          f"{r[k]['fma_ms']:.4f} rel {r[k]['rel_err']:.2e}" for k in ("fwd", "dx"))
              + f"; bound {bound[0]:.4f} ({bound[1]})", flush=True)
        del x, dy, xn, dyn, w, wo
        torch.cuda.empty_cache()
    return bad, res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("check_conv_groups: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.dtype == "float32":
        bad, res = check_f32(card, gen)
        finish(res, bad, args.out)
    ptxas_report(build_all(["conv3x3_any_mma_groups", "conv3x3_any_mma", "conv3x3_mma",
                            "conv3x3"])["conv3x3_any_mma_groups"],
                 "conv3x3_any_mma_groups_kernel")
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
    finish(res, bad, args.out)


def finish(res, bad, out):
    line = json.dumps(res)
    print(line)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print("FAILED" if bad else "OK")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
