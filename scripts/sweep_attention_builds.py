#!/usr/bin/env python3
"""Build variants of one attention source on a CUDA card, print ptxas'
registers and spills for its kernels at one head dim, and (``--time``) hold
each variant against the plain version and time it at (128, 4, 256, D).

    python3 scripts/sweep_attention_builds.py SOURCE PATTERN TEMPLATE VALUE ...
        [--head-dim 256] [--time]

Each VALUE builds ``csrc/SOURCE.cu`` with the text PATTERN replaced by
TEMPLATE.format(VALUE), all with nvcc at once, into a temporary directory;
the tree's own sources are not touched. E.g. the unroll count of the 3xTF32
kernels' score products at D = 256:

    python3 scripts/sweep_attention_builds.py attention_f32_mma \\
        'KSTEP_UNROLL_256 = 3' 'KSTEP_UNROLL_256 = {}' 1 2 3 4 8 16 32 --time
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
    compiler output, library path)}."""
    text = (CSRC_DIR / f"{source}.cu").read_text()
    if pattern not in text:
        sys.exit(f"{pattern!r} is not in csrc/{source}.cu")
    procs = {}
    for value in values:
        d = tmp / f"v{value}"
        d.mkdir()
        for header in CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, d)
        (d / f"{source}.cu").write_text(text.replace(pattern, template.format(value)))
        procs[value] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
                                          str(d / f"{source}.cu")], stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), d / "lib.so")
    return {v: (p.wait(), p.stdout.read(), so) for v, (p, so) in procs.items()}


def report(log, head_dim):
    """ptxas' registers and spill stores of each kernel at ``head_dim``."""
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?(attn_[a-z0-9_]+?)ILi(\d+)ELb([01])E",
                          line)
        if entry:
            kernel = (f"{entry.group(1)}<{entry.group(2)}, "
                      f"{'exact' if entry.group(3) == '1' else 'any L'}>"
                      if int(entry.group(2)) == head_dim else None)
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
    ap.add_argument("--head-dim", type=int, default=256)
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
    seed, D = 0x9E3779B9, args.head_dim
    with tempfile.TemporaryDirectory() as tmp:
        built = build(args.source, args.pattern, args.template, args.values, Path(tmp))
        for value, (rc, log, so) in built.items():
            print(f"=== {args.template.format(value)}: nvcc rc {rc}", flush=True)
            if rc:
                print(log[-3000:], flush=True)
                continue
            report(log, D)
            if not args.time:
                continue
            # the wrappers call attention.<getter>() at each launch
            attention.load_library = lambda _name, so=so: ctypes.CDLL(str(so))
            lib = loader.__wrapped__()
            setattr(attention, getter, lambda lib=lib: lib)
            for L in (257, 33):
                cs.check_attention(D, dtype, cs.RATE, seed, gen, L)
            t = cs.time_attention_route(cs.SEQ, D, dtype, seed, gen)
            print(f"  (128, 4, 256, {D}) {str(dtype)[6:]}: fwd {t['fwd_ms']:.4f} ms, bwd "
                  f"{t['bwd_ms']:.4f} ms (sdpa {t['lib_fwd_ms']:.4f} / {t['lib_bwd_ms']:.4f})",
                  flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
