"""Every queued window's reading of a few attention launches, to tell a pause
of the host from a slow kernel.

    python3 scripts/time_queued_windows.py [--root DIR] [--windows 40]

Each window is ``chip_smoke.cuda_ms_queued``'s: 20 launches queued behind a
sleeping kernel (~25 ms), timed with CUDA events. Each reading is printed with
the host's time to queue the 20 launches and whether the card passed the
sleeping kernel before the last was queued (the window drained, and its
reading may hold the host's gaps). ``--root`` launches the kernels of another
tree (e.g. a parent commit unpacked with ``git archive``), built there.
Shapes: bf16 at (128, 4, 257, 64), rate 0.1, forward and backward (the
options' shape, with a ragged tail), and (128, 4, 256, 16) where the tree
routes head dim 16 to the tensor cores.
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

import torch


def windows(fn, n, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        drained = start.query()
        end.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end) / iters, host_ms, drained))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the tree whose kernels run (default this one)")
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from sarssl_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"tree {Path(args.root).resolve()}", flush=True)
    for L, D in ((257, 64), (256, 16)):
        if A.attention_route(torch.bfloat16, L, D) != "tc":
            print(f"L={L} D={D}: not on the tensor cores in this tree", flush=True)
            continue
        qu, k, v, g = (torch.randn((128, 4, L, D), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        bias = torch.randn((128, 4, L, L), generator=gen, device="cuda", dtype=torch.bfloat16)
        drop = (0x9E3779B9, 1.0 / (4 * D) ** 0.5, 0.1)
        out, lse = A.launch_attention_fwd_mma(qu, k, v, bias, *drop)
        for kind, fn in (("fwd", lambda: A.launch_attention_fwd_mma(qu, k, v, bias, *drop)),
                         ("bwd", lambda: A.launch_attention_bwd_mma(qu, k, v, bias, g, out,
                                                                    lse, *drop))):
            ws = windows(fn, args.windows)
            ms = [w[0] for w in ws]
            print(f"L={L} D={D} bf16 {kind}: median {statistics.median(ms):.4f} ms, min "
                  f"{min(ms):.4f}, max {max(ms):.4f}; {sum(w[2] for w in ws)} of {len(ws)} "
                  f"windows drained; host queueing ms max {max(w[1] for w in ws):.3f}",
                  flush=True)
            print("  windows (ms, host ms, drained): " + ", ".join(
                f"{a:.4f}/{b:.2f}{'/D' if c else ''}" for a, b, c in ws), flush=True)
        del qu, k, v, g, bias, out, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
