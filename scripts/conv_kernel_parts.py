#!/usr/bin/env python3
"""Where the tensor-core conv kernel's time goes, read without a profiler.

    python3 scripts/conv_kernel_parts.py

Builds copies of ``sarssl_torch/csrc/conv3x3_mma.cu`` with one part switched
off by a condition that is never true at run time (so the compiler keeps the
code around it) and times each at (128, 256, 256, 64) bfloat16:

  full         the kernel as it is
  nomma        no products: copies in, the epilogue's stores out
  noload       no copies from device memory
  nostore      no stores to device memory
  nomem        neither: the products and the shared-memory traffic alone
  nomem_noldsm as nomem, the A fragments loaded once and never again

The variants' results are wrong by design; only their times are read. Before
that the script runs the kernel for a few seconds and samples the SM clock and
the power draw with nvidia-smi: the card's peak rates hold at its boost clock.
The copies are built under ``sarssl_torch/_build/parts/``.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sarssl_torch.kernels import _build  # noqa: E402
from sarssl_torch.kernels.conv3x3 import pack_weights  # noqa: E402

LOOP = "for (int jk = 0; jk < 3 * KH; ++jk) {"
LOAD = "cp_async16_zfill(dst + chunk_off<G::SH>(rc, piece), src, ok ? 16 : 0);"
STORE = "*reinterpret_cast<uint4*>(dst) = v;"
LDSM = "for (int k2 = 0; k2 < 2; ++k2) ldsm_x4(a[half][k2], a_addr ^ ((2 * half + k2) << 5));"
SHAPE = (128, 256, 256, 64)


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


def build(sources):
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
        lib.conv3x3_mma.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p])
        lib.conv3x3_mma.restype = ctypes.c_int
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = ["nvidia-smi", "--format=csv,noheader", "--query-gpu="]
    print(subprocess.run(smi[:2] + [smi[2] + "name,power.limit"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(variants((_build.CSRC_DIR / "conv3x3_mma.cu").read_text()))
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
