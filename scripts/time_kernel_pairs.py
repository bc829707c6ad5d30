#!/usr/bin/env python3
"""Time two trees' dropout and FMA conv kernels in alternating pairs in one
process on one card: the short, host-bound launches (the lane-seeded
dropout back to back) vary more from process to process than between two
kernels, so both trees' kernels are loaded side by side and each round
times parent then change, or change then parent, by turns.

    python3 scripts/time_kernel_pairs.py --parent DIR [--rounds 8] [--out FILE]

``DIR`` holds the other tree (e.g. a parent commit unpacked with ``git
archive``); its ``sarssl_torch/kernels`` is loaded under another name and
builds in its own ``_build``. The timing is this tree's ``chip_smoke``
``cuda_ms_queued`` (launches queued behind a sleeping kernel) and
``cuda_ms`` (back to back). Rows: hash_dropout at (128, 256, 2048) bf16,
unsharded and with the index map (1024, 2048, 1024); the lane-seeded launch
at (8, 8, 64, 2048) f32, queued and back to back; conv3x3 forward in f32 on
the FMA instances at (16, 64, 64) with 64 -> 64 and 128 -> 128 channels.
Prints one JSON line: each row's readings by tree in round order, their
medians, and change / parent of the medians.
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


def rows_of(kernels, gen_seed=0):
    """The rows' callables on one tree's kernels, on inputs made from one
    seed (both trees get equal inputs)."""
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
    return {
        "hash_dropout": ("queued", lambda: drop.launch_dropout(x, seed, rate)),
        "hash_dropout_mapped": ("queued", lambda: drop.launch_dropout(x, seed, rate,
                                                                      (1024, 2048, 1024))),
        "hash_dropout_lanes": ("queued", lambda: drop.launch_dropout_lanes(lanes, seeds, rate)),
        "hash_dropout_lanes_launch": ("back", lambda: drop.launch_dropout_lanes(lanes, seeds,
                                                                                rate)),
        "conv3x3_fwd_f32_64": ("queued", lambda: conv.conv3x3_fwd(*convs[64])),
        "conv3x3_fwd_f32_128": ("queued", lambda: conv.conv3x3_fwd(*convs[128])),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", type=Path, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_kernel_pairs: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, cuda_ms_queued  # noqa: E402

    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"parent": rows_of(load_kernels(args.parent.resolve(), "parent_kernels")),
             "change": rows_of(load_kernels(HERE, "change_kernels"))}
    # equal results first: the same inputs give the same outputs in both trees
    for name, (_, fn) in trees["parent"].items():
        a, b = fn(), trees["change"][name][1]()
        assert torch.equal(a, b), f"{name}: the trees' outputs differ"
    ms = {name: {"parent": [], "change": []} for name in trees["parent"]}
    for r in range(args.rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for name in ms:
            for tree in order:
                how, fn = trees[tree][name]
                ms[name][tree].append(cuda_ms_queued(fn) if how == "queued" else cuda_ms(fn))
    summary = {}
    for name, by in ms.items():
        med = {t: statistics.median(v) for t, v in by.items()}
        summary[name] = {"parent": by["parent"], "change": by["change"],
                         "median_parent": med["parent"], "median_change": med["change"],
                         "change_over_parent": med["change"] / med["parent"]}
    line = json.dumps({"card": torch.cuda.get_device_name(0), "rounds": args.rounds,
                       "ms": summary})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
