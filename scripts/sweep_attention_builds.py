#!/usr/bin/env python3
"""Build variants of one attention source on a CUDA card, print ptxas'
registers and spills for its kernels at the head dims asked for, and
(``--time``) hold each variant against the plain version and time it at
(B, 4, 256, D) for each D (B = ``--batch``, 128 by default).

    python3 scripts/sweep_attention_builds.py SOURCE PATTERN TEMPLATE VALUE ...
        [--head-dim 256 ...] [--batch 128] [--time]

Each VALUE builds ``csrc/SOURCE.cu`` with the text PATTERN replaced by
TEMPLATE.format(VALUE), all with nvcc at once, into a temporary directory;
the tree's own sources are not touched. E.g. the column chunk the 3xTF32
wide instance streams its score products in:

    python3 scripts/sweep_attention_builds.py attention_f32_mma \\
        'WKC = 32;' 'WKC = {};' 32 64 --head-dim 512 --time

A head dim past 256 reports the wide instance's kernels (every template
value) and times it; the wrapper then pads to the chunk width ``WDC`` of the
source each variant was built from, so the chunk itself can be swept:

    python3 scripts/sweep_attention_builds.py attention_f32_mma \\
        'WDC = 64' 'WDC = {}' 64 128 --head-dim 512 320 --time

``--batch 8`` times at the small batch where the wide forward splits its
keys over blocks.
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from sarssl_torch.kernels import attention  # noqa: E402
from sarssl_torch.kernels._build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

GETTERS = {"attention_mma": ("_library_mma", torch.bfloat16),
           "attention_f32_mma": ("_library_tf32", torch.float32)}


def build(source, pattern, template, values, tmp):
    """One nvcc process per value, started together; returns {value: (rc,
    compiler output, library path, the variant's WDC)}."""
    text = (CSRC_DIR / f"{source}.cu").read_text()
    if pattern not in text:
        sys.exit(f"{pattern!r} is not in csrc/{source}.cu")
    procs = {}
    for value in values:
        d = tmp / f"v{value}"
        d.mkdir()
        for header in CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d)
        variant = text.replace(pattern, template.format(value))
        (d / f"{source}.cu").write_text(variant)
        chunk = int(re.search(r"constexpr int WDC = (\d+);", variant).group(1))
        nvcc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
                                 str(d / f"{source}.cu")], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[value] = (chunk, nvcc, d / "lib.so")
    return {v: (p.wait(), p.stdout.read(), so, c) for v, (c, p, so) in procs.items()}


def report(log, head_dim):
    """ptxas' registers and spill stores of each kernel at ``head_dim`` (past
    256: of the wide instance's kernels, templated on their column widths)."""
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?(attn_[a-z0-9_]+?)ILi(\d+)ELb([01])E"
                          r"(?:Lb([01])E)?", line)
        if entry:
            name, value = entry.group(1), int(entry.group(2))
            trans = {None: "", "0": ", A x", "1": ", A^T x"}[entry.group(4)]
            ours = "wide" in name if head_dim > 256 else value == head_dim and "wide" not in name
            kernel = (f"{name}<{value}, {'exact' if entry.group(3) == '1' else 'any L'}{trans}>"
                      if ours else None)
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            stores = spill.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel:
            print(f"  {kernel}: {used.group(1)} registers, {stores} bytes spill stores",
                  flush=True)
            kernel = None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", choices=tuple(GETTERS))
    ap.add_argument("pattern")
    ap.add_argument("template")
    ap.add_argument("values", nargs="+")
    ap.add_argument("--head-dim", type=int, nargs="+", default=[256])
    ap.add_argument("--batch", type=int, default=cs.BATCH)
    ap.add_argument("--time", action="store_true",
                    help="check each variant against the plain version and time it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    getter, dtype = GETTERS[args.source]
    loader = getattr(attention, getter)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = 0x9E3779B9
    with tempfile.TemporaryDirectory() as tmp:
        built = build(args.source, args.pattern, args.template, args.values, Path(tmp))
        for value, (rc, log, so, chunk) in built.items():
            print(f"=== {args.template.format(value)}: nvcc rc {rc}", flush=True)
            if rc:
                print(log[-3000:], flush=True)
                continue
            for D in dict.fromkeys(min(D, 257) for D in args.head_dim):  # 257: the wide kernels
                report(log, D)
            if not args.time:
                continue
            # the wrappers call attention.<getter>() at each launch, and pad
            # past 256 to the build's chunk width
            attention.WIDE_CHUNK = chunk
            attention.load_library = lambda _name, so=so: ctypes.CDLL(str(so))
            lib = loader.__wrapped__()
            setattr(attention, getter, lambda lib=lib: lib)
            for D in args.head_dim:
                for L in (257, 33):
                    cs.check_attention(D, dtype, cs.RATE, seed, gen, L)
                t = cs.time_attention_route(cs.SEQ, D, dtype, seed, gen, args.batch)
                print(f"  ({args.batch}, 4, 256, {D}) {str(dtype)[6:]} padded to {t['Dp']}: fwd "
                      f"{t['fwd_ms']:.4f} ms, bwd {t['bwd_ms']:.4f} ms (sdpa {t['lib_fwd_ms']:.4f} "
                      f"/ {t['lib_bwd_ms']:.4f})", flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
