#!/usr/bin/env python3
"""Where a tensor-core conv kernel's time goes, read without a profiler.

    python3 scripts/conv_kernel_parts.py [--source conv3x3_mma|conv3x3_tf32]

Builds copies of the source with one part switched off by a condition that
is never true at run time (so the compiler keeps the code around it) and
times each. ``conv3x3_mma`` (the default) at (128, 256, 256, 64) bfloat16:

  full         the kernel as it is
  nomma        no products: copies in, the epilogue's stores out
  noload       no copies from device memory
  nostore      no stores to device memory
  nomem        neither: the products and the shared-memory traffic alone
  nomem_noldsm as nomem, the A fragments loaded once and never again

Before that the script runs the kernel for a few seconds and samples the SM
clock and the power draw with nvidia-smi: the card's peak rates hold at its
boost clock. ``conv3x3_tf32`` (the 3xTF32 f32 kernel) in row tiles and, as
``conv3x3_tf32_groups.cu`` builds it, in image groups, at the shapes of the
f32 rows of PERF.md's kernel table, three runs each:

  full      the kernel as it is
  noprod    no products: copies in, the epilogue's stores out
  one       one TF32 product a product (hi hi) in place of three
  nosplit   the fragments not split (hi = lo = the f32 word)
  noload    no copies of the input tile from device memory
  nostore   no stores to device memory
  cvt       the split by ``cvt.rna.tf32.f32`` (mma_common.cuh's split_tf32)
            in place of the integer operations (the same values)
  sets3     three sets of fragments in flight, ``wgmma_wait<2>`` (two groups
            ahead of the loads in place of one)

The variants' results are wrong by design; only their times are read (the
f32 kernel's weight packing, in the same launch, runs in each). The copies are built under
``sarssl_torch/_build/parts/``.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sarssl_torch.kernels import _build  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (TF32_BLOCK, conv_tiling, pack_weights,  # noqa: E402
                                          tf32_passes)

LOOP = "for (int jk = 0; jk < 3 * KH; ++jk) {"
LOAD = "cp_async16_zfill(dst + chunk_off<G::SH>(rc, piece), src, ok ? 16 : 0);"
STORE = "*reinterpret_cast<uint4*>(dst) = v;"
LDSM = "for (int k2 = 0; k2 < 2; ++k2) ldsm_x4(a[half][k2], a_addr ^ ((2 * half + k2) << 5));"
SHAPE = (128, 256, 256, 64)

THREE = ("  wgmma_tf32<NB>(d, al, dhi, sd);\n  wgmma_tf32<NB>(d, ah, dlo, 1);\n"
         "  wgmma_tf32<NB>(d, ah, dhi, 1);\n")
SPLIT = "for (int e = 0; e < 4; ++e) split_tf32_bits(r[e], ah[e], al[e]);"
CVT = "for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ah[e], al[e]);"
SETS = (("ah[2][KS][4], al[2][KS][4]", "ah[3][KS][4], al[3][KS][4]"),
        ("const int set = (rr * 3 + dw) & 1;", "const int set = (rr * 3 + dw) % 3;"),
        ("const int set = (tap * MT + m) & 1;", "const int set = (tap * MT + m) % 3;"),
        ("      wgmma_commit();\n      wgmma_wait<1>();",
         "      wgmma_commit();\n      wgmma_wait<2>();"))
LOADS_TF32 = ("cp_async16_zfill(xs + swz128(", "cp_async4_zfill(xs + swz128(")
STORES_TF32 = "    store_out<NB>(y, acc"
# (N, H, W, C, Cout) of each tile mode's f32 shapes
SHAPES_TF32 = {"rows": [(128, 256, 256, 64, 64), (16, 64, 64, 256, 256), (16, 64, 64, 3, 64)],
               "groups": [(65600, 4, 8, 3, 64), (65600, 4, 8, 64, 64), (65600, 4, 8, 64, 3)]}


def variants_tf32(src, groups):
    prod = "group_products<NB, " if groups else "stage_products<NB, "
    for text in (THREE, SPLIT, STORES_TF32) + LOADS_TF32 + tuple(old for old, _ in SETS):
        assert text in src, f"conv3x3_tf32.cu no longer holds: {text}"
    sets3 = src
    for old, new in SETS:
        sets3 = sets3.replace(old, new)
    head = "#define CONV_TF32_GROUPS 1\n" if groups else ""
    body = src.replace(f"{prod}KS_FULL>(", f"if (s.N < 0) {prod}KS_FULL>(").replace(
        f"{prod}KT>(", f"if (s.N < 0) {prod}KT>(")
    noload = src
    for text in LOADS_TF32:
        noload = noload.replace(text, "if (s.H < 0) " + text)
    return {name: head + text for name, text in {
        "full": src, "noprod": body,
        "one": src.replace(THREE, "  wgmma_tf32<NB>(d, ah, dhi, sd);\n"),
        "nosplit": src.replace(SPLIT, "for (int e = 0; e < 4; ++e) ah[e] = al[e] = r[e];"),
        "noload": noload,
        "nostore": src.replace(STORES_TF32, "    if (s.N < 0) " + STORES_TF32.strip()),
        "cvt": src.replace(SPLIT, CVT), "sets3": sets3}.items()}


def variants(src):
    for text in (LOOP, LOAD, STORE, LDSM):
        assert src.count(text) == 1, f"conv3x3_mma.cu no longer holds: {text}"
    nomem = src.replace(LOAD, "if (H < 0) " + LOAD).replace(STORE, "if (N < 0) " + STORE)
    return {
        "full": src,
        "nomma": src.replace(LOOP, "for (int jk = 0; jk < (N < 0 ? 3 * KH : 0); ++jk) {"),
        "noload": src.replace(LOAD, "if (H < 0) " + LOAD),
        "nostore": src.replace(STORE, "if (N < 0) " + STORE),
        "nomem": nomem,
        "nomem_noldsm": nomem.replace(LDSM, LDSM.replace(
            ") ldsm_x4", ") if (N < 0 || rr + jk + half == 0) ldsm_x4")),
    }


def build(sources, entry, n_ptr, n_int):
    """Builds each source in parallel; returns its library, with `entry`
    taking n_ptr pointers, n_int ints and a stream."""
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_common.cuh").write_bytes((_build.CSRC_DIR / "mma_common.cuh").read_bytes())
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
               str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, iters=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parts_tf32():
    src = (_build.CSRC_DIR / "conv3x3_tf32.cu").read_text()
    libs = build({f"{mode}_{name}": text for mode in SHAPES_TF32
                  for name, text in variants_tf32(src, mode == "groups").items()},
                 "conv3x3_tf32", 5, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for mode, shapes in SHAPES_TF32.items():
        for N, H, W, C, cout in shapes:
            x = torch.randn((N, H, W, C), generator=gen, device="cuda")
            w = 0.05 * torch.randn((3, 3, C, cout), generator=gen, device="cuda")
            y = torch.empty((N, H, W, cout), device="cuda")
            G = max(conv_tiling(torch.float32, H, W, C, cout), 1) if mode == "groups" else 0
            passes, nb = tf32_passes(cout, C)
            call = (ctypes.c_int * 8)(N, H, W, C, cout, nb, 0, G)
            wp = torch.empty((passes, -(-C // TF32_BLOCK), 2, 9, nb, TF32_BLOCK), device="cuda")
            for rep in range(3):
                line = []
                for name, lib in libs.items():
                    if not name.startswith(mode):
                        continue

                    def run(lib=lib):
                        code = lib.conv3x3_tf32(x.data_ptr(), w.data_ptr(), wp.data_ptr(),
                                                y.data_ptr(), ctypes.addressof(call),
                                                torch.cuda.current_stream().cuda_stream)
                        assert code == 0, code
                    line.append(f"{name.split('_', 1)[1]} {cuda_ms(run, iters=10):.4f}")
                print(f"{mode} ({N}, {H}, {W}) {C} -> {cout} run {rep}: " + ", ".join(line) +
                      " ms", flush=True)
            del x, y, wp
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=("conv3x3_mma", "conv3x3_tf32"), default="conv3x3_mma")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = ["nvidia-smi", "--format=csv,noheader", "--query-gpu="]
    print(subprocess.run(smi[:2] + [smi[2] + "name,power.limit"], capture_output=True,
                         text=True).stdout.strip())
    if args.source == "conv3x3_tf32":
        return parts_tf32()
    libs = build(variants((_build.CSRC_DIR / "conv3x3_mma.cu").read_text()), "conv3x3_mma", 3, 5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
    w = (0.05 * torch.randn((3, 3, 64, 64), generator=gen, device="cuda")).bfloat16()
    packed, y = pack_weights(w), torch.empty_like(x)
    B, H, W, C = SHAPE

    def launcher(lib):
        def run():
            code = lib.conv3x3_mma(x.data_ptr(), packed.data_ptr(), y.data_ptr(), B, H, W, C, C,
                                   torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
        return run

    run = launcher(libs["full"])
    for i in range(3000):  # a few seconds of load, sampled three times
        run()
        if i % 800 == 799:
            print("under load: SM clock, its maximum, power draw, temperature:",
                  subprocess.run(smi[:2] + [smi[2] + "clocks.sm,clocks.max.sm,power.draw,"
                                            "temperature.gpu"], capture_output=True,
                                 text=True).stdout.strip(), flush=True)
    torch.cuda.synchronize()
    flop = 2 * B * H * W * C * C * 9
    for rep in range(2):
        for name, lib in libs.items():
            t = cuda_ms(launcher(lib))
            print(f"conv3x3 run {rep} {name}: {t:.4f} ms ({flop / t * 1e-9:.1f} TFLOP/s and "
                  f"{2 * x.numel() * 2 / t * 1e-9:.3f} TB/s if it were the whole work)",
                  flush=True)


if __name__ == "__main__":
    main()
