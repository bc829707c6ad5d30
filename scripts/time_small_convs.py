#!/usr/bin/env python3
"""Where a small conv call's time goes, the port's and cuDNN's: the conv
shapes of ``chip_smoke.py``'s phase ``edges`` (``EDGE_CONV_CHANNELS`` at
``EDGE_CONV_SHAPE`` in both dtypes, at ``EDGE_CONV_SMALL`` in bf16, and
``EDGE_CONV_RAGGED`` in both), forward (``conv3x3_fwd``) and dx
(``conv3x3_dx``), beside cuDNN's ``F.conv2d`` / ``conv2d_input`` on the
same inputs (NHWC memory, TF32 off).

Each call gets ``chip_smoke.call_readings`` (the median of 5 back-to-back
windows of 20 calls, the device time queued behind a sleeping kernel, the
host's microseconds to issue a call) and, for the port,
``chip_smoke.host_split`` (the C entry's ctypes call timed inside the call,
the rest being the Python path; the same call returned at its first check,
the ctypes share, the rest being the launches; the launch calls a call
makes, by torch.profiler); cuDNN's launch calls a call too.

    python3 scripts/time_small_convs.py [--parent DIR] [--rounds 2] [--out FILE]

``--parent DIR`` (a parent commit unpacked with ``git archive``) loads that
tree's kernels beside this one's in the same process, and each round reads
both, in turns (parent, change, then change, parent). Prints a line per
reading and one JSON line of them all.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def shapes():
    from chip_smoke import (EDGE_CONV_CHANNELS, EDGE_CONV_RAGGED, EDGE_CONV_SHAPE,
                            EDGE_CONV_SMALL)

    out = []
    for C, Cout in EDGE_CONV_CHANNELS:
        for dtype in (torch.bfloat16, torch.float32):
            out.append((*EDGE_CONV_SHAPE, C, Cout, dtype))
        out.append((*EDGE_CONV_SMALL, C, Cout, torch.bfloat16))
    for dtype in (torch.bfloat16, torch.float32):
        out.append((*EDGE_CONV_RAGGED, dtype))
    return out


def entry_of(conv, dtype, C, Cout, H, W):
    """The library and C entry the tree's wrapper calls at this shape."""
    kernel = conv.conv_kernel(dtype, C, Cout, H, W)
    if kernel == "tc":
        return kernel, conv._library_mma(), "conv3x3_mma"
    if kernel in ("tc_any", "tc_groups"):
        return kernel, conv._library_any_mma(kernel == "tc_groups"), "conv3x3_any_mma"
    return kernel, conv._library_tf32(kernel == "tf32_groups"), "conv3x3_tf32"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_small_convs: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "scripts"))
    from chip_smoke import call_readings, host_split, launches_a_call
    from time_kernel_pairs import load_kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {}
    if args.parent:
        trees["parent"] = load_kernels(args.parent.resolve(), "parent_kernels")
    trees["change"] = load_kernels(HERE, "change_kernels")
    from importlib import import_module

    convs = {t: import_module(m.__name__ + ".conv3x3") for t, m in trees.items()}
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for N, H, W, C, Cout, dtype in shapes():
        x = torch.randn((N, H, W, C), generator=gen, device="cuda", dtype=dtype)
        dy = torch.randn((N, H, W, Cout), generator=gen, device="cuda", dtype=dtype)
        w = (torch.randn((3, 3, C, Cout), generator=gen, device="cuda") / (9 * C) ** 0.5).to(dtype)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        for kind, inp, lib_fn in (
                ("fwd", x, lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)),
                ("dx", dy, lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_nchw,
                                                              padding=1))):
            cin, cout = (C, Cout) if kind == "fwd" else (Cout, C)
            row = {"shape": [N, H, W, C, Cout], "dtype": str(dtype)[6:], "kind": kind,
                   "cudnn": [], **{t: [] for t in trees}}
            fns = {t: (lambda c=c: c.conv3x3_fwd(x, w)) if kind == "fwd"
                   else (lambda c=c: c.conv3x3_dx(dy, w)) for t, c in convs.items()}
            outs = [f() for f in fns.values()]
            assert all(torch.equal(outs[0], o) for o in outs), "the trees' outputs differ"
            for r in range(args.rounds):
                order = list(trees) if r % 2 == 0 else list(reversed(trees))
                for t in order + order[::-1]:
                    kernel, lib, entry = entry_of(convs[t], dtype, cin, cout, H, W)
                    reading = call_readings(fns[t])
                    reading.update(host_split(fns[t], lib, entry))
                    reading["python_us"] = reading["host_us"] - reading["c_entry_us"]
                    reading["kernel"] = kernel
                    row[t].append(reading)
                reading = call_readings(lib_fn)
                reading["launches"] = launches_a_call(lib_fn)
                row["cudnn"].append(reading)
            for who in list(trees) + ["cudnn"]:
                rs = row[who]
                med = {k: statistics.median(r[k] for r in rs) for k in rs[0]
                       if isinstance(rs[0][k], (int, float)) and rs[0][k] is not None}
                row[f"median_{who}"] = med
                print(f"{(N, H, W, C)} -> {Cout} {str(dtype)[6:]} {kind} {who}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in med.items()), flush=True)
            results.append(row)
        del x, dy, w, w_oihw
        torch.cuda.empty_cache()
    line = json.dumps({"card": card, "rounds": args.rounds, "rows": results})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
