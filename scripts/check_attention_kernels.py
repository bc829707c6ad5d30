#!/usr/bin/env python3
"""Build the port's attention kernels on a CUDA card, print ptxas' report for
the tensor-core kernels, hold them against the plain version at small,
ragged and misaligned shapes, then at the full shapes (batch 128, 4 heads,
dropout 0.1) that the flagship and the model's options give them, timed
beside the FMA kernels, the plain version, SDPA and the bound.

    python3 scripts/check_attention_kernels.py [--small-only] [--dtype bf16|f32|both]

The short first check of an edited ``csrc/attention_mma.cu`` (bf16) or
``csrc/attention_f32_mma.cu`` (f32, 3xTF32); ``chip_smoke.py`` is the whole run
(its functions do the full-shape part here).
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from sarssl_torch.kernels import attention_plain, fused_attention, launches  # noqa: E402
from sarssl_torch.kernels._build import build_all  # noqa: E402

SMALL_L = (1, 17, 33, 64, 65, 100, 128, 257)
DTYPES = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
          "both": (torch.bfloat16, torch.float32)}


def vanishing_errors(qu, k, v, g, args, grads, ref_grads):
    """At L = 1 the softmax of one score is constant: dqu, dk and dbias of
    the plain version vanish up to f32 rounding, and the kernel's are the
    rounding of out (delta = g . out) left in ds = p (dp - delta). Each
    is measured against the terms that cancel there, ``scale * max |g . v| /
    (1 - rate)`` (times max |k| for dqu, max |qu| for dk); dv against its own
    max."""
    _, scale, rate = args
    cancel = scale * float((g.float() * v.float()).sum(-1).abs().max()) / (1.0 - rate)
    dqu, dk, dv, dbias = grads
    rdqu, rdk, rdv, rdbias = ref_grads
    return [cs.max_abs(dqu, rdqu) / (cancel * float(k.float().abs().max())),
            cs.max_abs(dk, rdk) / (cancel * float(qu.float().abs().max())),
            cs.rel_err(dv, rdv), cs.max_abs(dbias, rdbias) / cancel]


def check_small(gen, dtype):
    """fused_attention (forward and backward) against the plain version at B
    = 2, H = 3, rate 0.3, every small L (f32: and L = 768, past the FMA
    kernels' reach) and head dim of the tensor-core kernels, and with a bias
    that starts 1 or 3 elements into its storage; returns the number of
    failures."""
    bad = 0
    tag = "tc" if dtype == torch.bfloat16 else "tf32x3"
    tol = cs.TOL_BF16 if dtype == torch.bfloat16 else cs.TOL_F32
    for D in (32, 64, 128):
        for L in SMALL_L + ((768,) if dtype == torch.float32 else ()):
            for offset in ((0, 1, 3) if L in (64, 257) else (0,)):
                xs = [torch.randn((2, 3, L, D), generator=gen, device="cuda").to(dtype)
                      for _ in range(4)]
                store = torch.randn(offset + 2 * 3 * L * L, generator=gen,
                                    device="cuda").to(dtype)
                qu, k, v, g = xs
                bias = store[offset:].view(2, 3, L, L)
                args = (0x9E3779B9, D ** -0.5, 0.3)
                names = f"attention_fwd_{tag}_d{D}", f"attention_bwd_{tag}_d{D}"
                before = launches[names[0]], launches[names[1]]
                ins = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
                out = fused_attention(*ins, *args)
                grads = torch.autograd.grad(out, ins, g)
                rose = (launches[names[0]] - before[0], launches[names[1]] - before[1])
                ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
                ref = attention_plain(*ys, *args)
                ref_grads = torch.autograd.grad(ref, ys, g.float())
                torch.cuda.synchronize()
                errs = [cs.rel_err(a, b) for a, b in zip((out, *grads), (ref, *ref_grads))]
                if L == 1:
                    errs[1:5] = vanishing_errors(qu, k, v, g, args, grads, ref_grads)
                ok = rose == (1, 1) and max(errs) <= tol and all(
                    bool(torch.isfinite(t).all()) for t in (out, *grads))
                bad += not ok
                print(f"{str(dtype)[6:]} L={L} D={D} bias offset {offset}: out/dqu/dk/dv/dbias rel "
                      + " ".join(f"{e:.2e}" for e in errs)
                      + f" tensor-core launches {rose} {'ok' if ok else 'FAIL'}", flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small-only", action="store_true",
                    help="only the small shapes: no full-shape checks or times")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="both",
                    help="which tensor-core route to check (default both)")
    args = ap.parse_args()
    dtypes = DTYPES[args.dtype]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    logs = build_all(["attention_mma", "attention_f32_mma", "attention"])
    bad = 0
    for source in ("attention_mma", "attention_f32_mma"):
        try:
            cs.report_tensor_core_kernels(source, logs[source])
        except AssertionError as e:  # report it, check the rest, fail at the end
            print(f"FAIL {source}: {e}; ptxas:", flush=True)
            for line in logs[source].splitlines():
                if "Compiling entry" in line or "spill" in line or "Used" in line:
                    print("  " + line.strip()[:160], flush=True)
            bad += 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad += sum(check_small(gen, dtype) for dtype in dtypes)
    if bad:
        print(f"FAILED: {bad} small case(s) or kernel report(s)")
    if not args.small_only:
        seed = 0x9E3779B9
        for L, D, dtype in cs.OPTION_ATTENTION_SHAPES:
            if dtype not in dtypes:
                continue
            cs.check_attention(D, dtype, cs.RATE, seed, gen, L)
            t = cs.time_attention_route(L, D, dtype, seed, gen)
            fma = {kind: (f"FMA {t[f'fma_{kind}_ms']:.4f} " if t["tc"] else "")
                   for kind in ("fwd", "bwd")}
            print(f"L={L} D={D} {str(dtype)[6:]} ({cs.ROUTE_WORDS[t['route']]}): "
                  f"fwd {t['fwd_ms']:.4f} ms ({fma['fwd']}plain {t['plain_fwd_ms']:.4f} sdpa "
                  f"{t['lib_fwd_ms']:.4f} bound {t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.4f} "
                  f"ms ({fma['bwd']}plain {t['plain_bwd_ms']:.4f} sdpa {t['lib_bwd_ms']:.4f} "
                  f"bound {t['bwd_bound'][0]:.4f})", flush=True)
            torch.cuda.empty_cache()
        for D in (cs.HEAD_DIMS if torch.bfloat16 in dtypes else ()):
            t = cs.time_attention(D, seed, gen)
            print(f"L={cs.SEQ} D={D} bfloat16 (tensor-core): fwd {t['fwd_ms']:.4f} ms (FMA "
                  f"{t['fma_fwd_ms']:.4f} sdpa {t['lib_fwd_ms']:.4f} bound "
                  f"{t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.4f} ms (FMA "
                  f"{t['fma_bwd_ms']:.4f} sdpa {t['lib_bwd_ms']:.4f} bound "
                  f"{t['bwd_bound'][0]:.4f})", flush=True)
    if bad:
        sys.exit(1)
    print("OK")


if __name__ == "__main__":
    main()
