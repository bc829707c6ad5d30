#!/usr/bin/env python3
"""Time two trees' dropout and FMA conv kernels in alternating pairs in one
process on one card: the short, host-bound launches (the lane-seeded
dropout back to back) vary more from process to process than between two
kernels, so both trees' kernels are loaded side by side and each round
times parent then change, or change then parent, by turns.

``DIR`` holds the other tree (e.g. a parent commit unpacked with ``git
archive``); its ``sarssl_torch/kernels`` is loaded under another name and
builds in its own ``_build``. The timing is this tree's ``chip_smoke``
``cuda_ms_queued`` (launches queued behind a sleeping kernel) and
``cuda_ms`` (back to back). Rows: hash_dropout at (128, 256, 2048) bf16,
unsharded and with the index map (1024, 2048, 1024); the lane-seeded launch
at (8, 8, 64, 2048) f32, queued and back to back, and at (65600, 64) f32
(lanes shorter than a block); the bf16 attention forward and backward at
(128, 4, 256, D), D = 128, 64 and 512, rate 0.1; conv3x3 forward in f32 on the FMA instances at
(16, 64, 64) with 64 -> 64 and 128 -> 128 channels; conv3x3 forward and dx
in bf16 at (128, 256, 256, 64) 64 -> 64 (``conv3x3_mma.cu``) and at (16, 64,
64) 96 -> 160 and 256 -> 256 (``conv3x3_any_mma.cu``'s row tiles), and in
bf16 and f32 (``conv3x3_tf32``, 3xTF32) at (128, 256, 256, 64) 64 -> 64 (f32
only: bf16 is the row above), (16, 64, 64) 256 -> 256 and (65600, 4, 8) 64
-> 64 and 3 -> 64 (the image groups); the f32 (3xTF32)
attention forward and backward at (128, 4, 256, D), D = 16, 64, 128, 256,
512, and at (1, 16, 4096, D), D = 16, 64, 128, 512 (``long``: the
partial-sum instances), rate 0.1. ``--rows`` keeps the rows whose names start with one of its
words. Each row's two trees give equal outputs, bit for bit, but for the
attention rows past ``F32_PSUM_MIN_L``, where a change to the sums' rounding
is what is timed: there within 1e-4 of each other, relative to the largest
value.

``--psum`` (no ``DIR``) times this tree's f32 attention rows at (128, 4, 256,
D) as shipped (``running``: the running sums in the ``mma``'s C operand)
against the same launches with the partial-sum instances
(``attention_f32_mma_psum.cu``) taken at every L (``psum``), outputs within
1e-4 of each other: the cost that keeps those instances past
``F32_PSUM_MIN_L`` only.

    python3 scripts/time_kernel_pairs.py (--parent DIR | --psum) [--rounds 8]
                                         [--rows NAME ...] [--out FILE]

Prints one JSON line: each row's readings by tree in round order, their
medians, and the second tree's median over the first's.
"""
import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def load_kernels(root: Path, name: str):
    """``root``'s ``sarssl_torch.kernels`` as the package ``name``."""
    pkg = root / "sarssl_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# (name, shape): the f32 route at the flagship's batch and length, and at L =
# 4096 (past kernels/attention.py's F32_PSUM_MIN_L: the partial-sum instances)
ATTENTION_F32_SHAPES = tuple((f"d{D}", (128, 4, 256, D)) for D in (16, 64, 128, 256, 512)) + \
    tuple((f"long_d{D}", (1, 16, 4096, D)) for D in (16, 64, 128, 512))


def attention_rows(kernels, gen_seed=1):
    """The attention rows: (how, callable, exact) by name, the backward on
    the tree's own forward's out and lse; f32 exact up to the tree's
    ``F32_PSUM_MIN_L`` (every L in a tree without it); bf16 at the flagship's
    head dims 128 and 64 and the wide instance's 512, (128, 4, 256, D)."""
    from importlib import import_module

    att = import_module(kernels.__name__ + ".attention")
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    rows = {}
    for D in (128, 64, 512):
        qu, k, v, g = (torch.randn((128, 4, 256, D), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        bias = torch.randn((128, 4, 256, 256), generator=gen, device="cuda").bfloat16()
        args = (0x9E3779B9, D ** -0.5, 0.1)
        out, lse = att.launch_attention_fwd_mma(qu, k, v, bias, *args)
        rows[f"attention_bf16_fwd_d{D}"] = (
            "queued", lambda a=(qu, k, v, bias), r=args: att.launch_attention_fwd_mma(*a, *r)[0],
            True)
        rows[f"attention_bf16_bwd_d{D}"] = (
            "queued", lambda a=(qu, k, v, bias, g, out, lse), r=args:
            att.launch_attention_bwd_mma(*a, *r)[0], True)
    for tag, shape in ATTENTION_F32_SHAPES:
        B, H, L, D = shape
        qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        bias = torch.randn((B, H, L, L), generator=gen, device="cuda")
        args = (0x9E3779B9, D ** -0.5, 0.1)
        out, lse = att.launch_attention_fwd_tf32(qu, k, v, bias, *args)
        exact = L <= getattr(att, "F32_PSUM_MIN_L", L)
        rows[f"attention_f32_fwd_{tag}"] = (
            "queued", lambda a=(qu, k, v, bias), r=args: att.launch_attention_fwd_tf32(*a, *r)[0],
            exact)
        rows[f"attention_f32_bwd_{tag}"] = (
            "queued", lambda a=(qu, k, v, bias, g, out, lse), r=args:
            att.launch_attention_bwd_tf32(*a, *r)[0], exact)
    return rows


def rows_of(kernels, keep=None, gen_seed=0):
    """The rows' callables on one tree's kernels, on inputs made from one
    seed (both trees get equal inputs): (how, callable, exact) by name, only
    those whose names start with a word of ``keep`` if given."""
    from importlib import import_module

    drop = import_module(kernels.__name__ + ".dropout")
    conv = import_module(kernels.__name__ + ".conv3x3")
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    seed, rate = 0x9E3779B9, 0.1
    x = torch.randn((128, 256, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    lanes = torch.randn((8, 8, 64, 2048), generator=gen, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (8,), generator=gen, device="cuda")
    convs = {}
    for c in (64, 128):
        xc = torch.randn((16, 64, 64, c), generator=gen, device="cuda")
        wc = torch.randn((3, 3, c, c), generator=gen, device="cuda") / (3 * c ** 0.5)
        convs[c] = (xc, wc)
    tc = {}
    for tag, shape, cout in (("64", (128, 256, 256, 64), 64), ("96_160", (16, 64, 64, 96), 160),
                             ("256", (16, 64, 64, 256), 256),
                             ("n65600_64", (65600, 4, 8, 64), 64),
                             ("n65600_3", (65600, 4, 8, 3), 64)):
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and tag == "96_160":
                continue
            tc[(tag, dtype)] = (
                torch.randn(shape, generator=gen, device="cuda").to(dtype),
                (torch.randn((3, 3, c, cout), generator=gen, device="cuda")
                 / (3 * c ** 0.5)).to(dtype),
                torch.randn(shape[:3] + (cout,), generator=gen, device="cuda").to(dtype))
    short = torch.randn((65600, 64), generator=gen, device="cuda")
    short_seeds = torch.randint(0, 2 ** 32, (65600,), generator=gen, device="cuda")
    rows = {
        "hash_dropout": ("queued", lambda: drop.launch_dropout(x, seed, rate), True),
        "hash_dropout_mapped": ("queued", lambda: drop.launch_dropout(x, seed, rate,
                                                                      (1024, 2048, 1024)), True),
        "hash_dropout_lanes": ("queued", lambda: drop.launch_dropout_lanes(lanes, seeds, rate),
                               True),
        "hash_dropout_lanes_launch": ("back", lambda: drop.launch_dropout_lanes(lanes, seeds,
                                                                                rate), True),
        "hash_dropout_lanes_65600x64": (
            "queued", lambda: drop.launch_dropout_lanes(short, short_seeds, rate), True),
        # the FMA instances launched directly: f32 routes to the 3xTF32 kernel
        # since that kernel came, and the FMA kernels stay as its yardstick
        "conv3x3_fwd_f32_64": ("queued", lambda: conv.launch_conv3x3_fma(*convs[64], "fma"),
                               True),
        "conv3x3_fwd_f32_128": ("queued", lambda: conv.launch_conv3x3_fma(*convs[128], "fma"),
                                True),
    }
    for (tag, dtype), (xb, wb, dyb) in tc.items():
        kind = "bf16" if dtype == torch.bfloat16 else "tf32"
        rows[f"conv3x3_{kind}_fwd_{tag}"] = ("queued", lambda a=(xb, wb): conv.conv3x3_fwd(*a),
                                             True)
        rows[f"conv3x3_{kind}_dx_{tag}"] = ("queued", lambda a=(dyb, wb): conv.conv3x3_dx(*a),
                                            True)
    if keep is None or any(w.startswith("attention") for w in keep):
        rows.update(attention_rows(kernels))
    return {n: r for n, r in rows.items() if keep is None or any(n.startswith(w) for w in keep)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--parent", type=Path, help="the other tree's root")
    which.add_argument("--psum", action="store_true",
                       help="this tree's f32 attention at L = 256 against its partial-sum "
                            "instances")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--rows", nargs="+", help="keep the rows whose names start with these")
    ap.add_argument("--out", type=Path, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_kernel_pairs: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, cuda_ms_queued  # noqa: E402

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.psum:
        keep = args.rows or ["attention_f32_fwd_d", "attention_f32_bwd_d"]
        from importlib import import_module

        psum = load_kernels(HERE, "psum_kernels")
        import_module("psum_kernels.attention").F32_PSUM_MIN_L = 0
        trees = {"running": rows_of(load_kernels(HERE, "change_kernels"), keep),
                 "psum": rows_of(psum, keep)}
    else:
        trees = {"parent": rows_of(load_kernels(args.parent.resolve(), "parent_kernels"),
                                   args.rows),
                 "change": rows_of(load_kernels(HERE, "change_kernels"), args.rows)}
    first, second = trees
    # equal results first: the same inputs give the same outputs in both trees
    for name, (_, fn, exact) in trees[second].items():
        a, b = trees[first][name][1](), fn()
        if exact:
            assert torch.equal(a, b), f"{name}: the trees' outputs differ"
        else:
            rel = float((a - b).abs().max() / b.abs().max())
            assert rel <= 1e-4, f"{name}: the trees' outputs differ by {rel}"
    ms = {name: {first: [], second: []} for name in trees[first]}
    for r in range(args.rounds):
        order = (first, second) if r % 2 == 0 else (second, first)
        for name in ms:
            for tree in order:
                how, fn, _ = trees[tree][name]
                ms[name][tree].append(cuda_ms_queued(fn) if how == "queued" else cuda_ms(fn))
    summary = {}
    for name, by in ms.items():
        med = {t: statistics.median(v) for t, v in by.items()}
        summary[name] = {first: by[first], second: by[second],
                         f"median_{first}": med[first], f"median_{second}": med[second],
                         f"{second}_over_{first}": med[second] / med[first]}
    line = json.dumps({"card": torch.cuda.get_device_name(0), "rounds": args.rounds,
                       "ms": summary})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
