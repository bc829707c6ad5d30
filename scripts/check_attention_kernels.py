#!/usr/bin/env python3
"""Build the port's attention kernels on a CUDA card, print ptxas' report for
the tensor-core kernels, hold them against the plain version at small,
ragged and misaligned shapes, then at the full shapes (batch 128, 4 heads,
dropout 0.1) that the flagship and the model's options give them, timed
beside the FMA kernels, the plain version, SDPA and the bound.

    python3 scripts/check_attention_kernels.py [--small-only] [--dtype bf16|f32|both]
        [--head-dims D ...] [--small-head-dims D ...]

The short first check of an edited ``csrc/attention_mma.cu`` (bf16) or
``csrc/attention_f32_mma.cu`` (f32, 3xTF32); ``chip_smoke.py`` is the whole run
(its functions do the full-shape part here). Small shapes run head dims 16,
32, 64, 128 and 256, through the padding 8, 48 and 200, and on the wide
instance 512 and 320 (blocks of 128 and of 64 output columns) and, padded to
the next multiple of its chunk width (``attention.WIDE_CHUNK``), 300 and 1000;
then the bf16 wide forward launched at D = 256 (where the route takes the
D = 256 instance), and the wide forward at a batch of 8 at every number of
key splits. ``--small-head-dims`` keeps the small shapes to those head dims
(the wide forward at 256 runs when 256 is among them, the key splits when
300 or 1000 is), ``--head-dims`` the full-shape part.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from sarssl_torch.kernels import attention, attention_plain, fused_attention, launches  # noqa: E402
from sarssl_torch.kernels._build import build_all  # noqa: E402

SMALL_L = (1, 17, 33, 64, 65, 100, 128, 257)
# the instances, three head dims padded, the wide instance at two multiples
# of its chunk and at two that are not
SMALL_D = (16, 32, 64, 128, 256, 8, 48, 200, 512, 320, 300, 1000)
DTYPES = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
          "both": (torch.bfloat16, torch.float32)}


def check_small(gen, dtype, dims=SMALL_D):
    """fused_attention (forward and backward) against the plain version at B
    = 2, H = 3, rate 0.3, every small L (f32, D = 16 and D = 256: and L =
    768, past the FMA kernels' reach) and head dim of the tensor-core
    kernels, and with a bias
    that starts 1 or 3 elements into its storage; returns the number of
    failures."""
    bad = 0
    tag = "tc" if dtype == torch.bfloat16 else "tf32x3"
    tol = cs.TOL_BF16 if dtype == torch.bfloat16 else cs.TOL_F32
    for D in dims:
        Dp = attention.padded_head_dim(D)
        for L in SMALL_L + ((768,) if dtype == torch.float32 or D in (16, 256) else ()):
            for offset in ((0, 1, 3) if L in (64, 257) else (0,)):
                xs = [torch.randn((2, 3, L, D), generator=gen, device="cuda").to(dtype)
                      for _ in range(4)]
                store = torch.randn(offset + 2 * 3 * L * L, generator=gen,
                                    device="cuda").to(dtype)
                qu, k, v, g = xs
                bias = store[offset:].view(2, 3, L, L)
                args = (0x9E3779B9, D ** -0.5, 0.3)
                names = f"attention_fwd_{tag}_d{Dp}", f"attention_bwd_{tag}_d{Dp}"
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
                    errs[1:5] = cs._vanishing_errors(qu, k, v, g, args, grads, ref_grads)
                ok = rose == (1, 1) and max(errs) <= tol and all(
                    bool(torch.isfinite(t).all()) for t in (out, *grads))
                bad += not ok
                print(f"{str(dtype)[6:]} L={L} D={D} bias offset {offset}: out/dqu/dk/dv/dbias rel "
                      + " ".join(f"{e:.2e}" for e in errs)
                      + f" tensor-core launches {rose} {'ok' if ok else 'FAIL'}", flush=True)
    return bad


def check_wide_at_256(gen):
    """The bf16 wide forward launched at D = 256 (``_wide_launches``; the
    route runs the D = 256 instance there) against the plain version at B =
    2, H = 3, rate 0.3, ragged and whole L; returns the number of failures."""
    fwd = attention._wide_launches("tc")
    bad = 0
    for L in (1, 33, 64, 257):
        qu, k, v = (torch.randn((2, 3, L, 256), generator=gen, device="cuda").bfloat16()
                    for _ in range(3))
        bias = torch.randn((2, 3, L, L), generator=gen, device="cuda").bfloat16()
        args = (0x9E3779B9, 256 ** -0.5, 0.3)
        names = ["attention_fwd_tc_wide_d256", "attention_fwd_tc_d256"]
        before = [launches[n] for n in names]
        out, _ = fwd(qu, k, v, bias, *args)
        rose = tuple(launches[n] - b for n, b in zip(names, before))
        ref = attention_plain(*(t.float() for t in (qu, k, v, bias)), *args)
        err = cs.rel_err(out, ref)
        ok = rose == (1, 0) and err <= cs.TOL_BF16
        bad += not ok
        print(f"bfloat16 L={L} D=256 forward on the wide instance: out rel {err:.2e} "
              f"launches (wide, d256) {rose} {'ok' if ok else 'FAIL'}", flush=True)
    return bad


def check_splits(gen, dtype, dims=cs.WIDE_SMALL_HEAD_DIMS):
    """The wide forward at a batch of ``cs.WIDE_B``, H = 4, rate 0.3, at D
    in ``dims`` (launched at their padded head dims) and L = 1, 33, 256 and
    257, with every number of key splits from 1 to ceil(L/64) forced and the
    one the launcher chooses: out and lse against the plain version (lse
    against the log-sum-exp of the scaled scores, within the same tolerance
    of its largest value), and at L = 257 (where S = 4 leaves one split no
    key tile) the dropped positions those of the plain mask (v the
    identity). Returns the number of failures."""
    from sarssl_torch.kernels import hash_keep_mask

    route = attention.attention_route(dtype, 1, 320)
    tol = cs.TOL_BF16 if dtype == torch.bfloat16 else cs.TOL_F32
    B, H, seed, rate = cs.WIDE_B, cs.HEADS, 0x9E3779B9, 0.3
    bad = 0
    for D in dims:
        Dp = attention.padded_head_dim(D)
        for L in (1, 33, 256, 257):
            qu, k, v = (torch.randn((B, H, L, Dp), generator=gen, device="cuda").to(dtype)
                        for _ in range(3))
            bias = torch.randn((B, H, L, L), generator=gen, device="cuda").to(dtype)
            args = (seed, 1.0 / (H * D) ** 0.5, rate)
            x = [t.float() for t in (qu, k, v, bias)]
            ref = attention_plain(*x, *args)
            ref_lse = torch.logsumexp((x[0] @ x[1].transpose(-1, -2) + x[3]) * args[1], -1)
            if L == 257:
                keep = hash_keep_mask(B * H * L * L, seed, rate, "cuda").reshape(B, H, L, L)
                eye = torch.eye(L, Dp, device="cuda", dtype=dtype).expand(B, H, L, Dp).contiguous()
            nt = -(-L // 64)
            for splits in (*range(1, nt + 1), None):
                out, lse = attention._launch_fwd(route, qu, k, v, bias, *args, splits=splits)
                errs = (cs.rel_err(out, ref), cs.rel_err(lse, ref_lse))
                same = True
                if L == 257:
                    pd = attention._launch_fwd(route, qu, k, eye, bias, *args, splits=splits)[0]
                    same = torch.equal(pd[..., :L] != 0, keep)
                ok = max(errs) <= tol and same
                bad += not ok
                print(f"{str(dtype)[6:]} B={B} L={L} D={D} (-> {Dp}) key splits "
                      f"{'chosen' if splits is None else splits} of {nt}: out rel {errs[0]:.2e}, "
                      f"lse rel {errs[1]:.2e}" + (", dropped positions identical" if
                                                  L == 257 and same else "")
                      + f" {'ok' if ok else 'FAIL'}", flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small-only", action="store_true",
                    help="only the small shapes: no full-shape checks or times")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="both",
                    help="which tensor-core route to check (default both)")
    ap.add_argument("--head-dims", type=int, nargs="+", default=None,
                    help="only the full shapes at these head dims (default all)")
    ap.add_argument("--small-head-dims", type=int, nargs="+", default=SMALL_D,
                    help=f"only the small shapes at these head dims (default {SMALL_D})")
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
    bad += sum(check_small(gen, dtype, args.small_head_dims) for dtype in dtypes)
    if 256 in args.small_head_dims and torch.bfloat16 in dtypes:
        bad += check_wide_at_256(gen)
    split_dims = [D for D in cs.WIDE_SMALL_HEAD_DIMS if D in args.small_head_dims]
    bad += sum(check_splits(gen, dtype, split_dims) for dtype in dtypes)
    if bad:
        print(f"FAILED: {bad} small case(s) or kernel report(s)")
    if not args.small_only:
        seed = 0x9E3779B9
        wanted = (lambda D: True) if args.head_dims is None else args.head_dims.__contains__
        for L, D, dtype in cs.OPTION_ATTENTION_SHAPES:
            if dtype not in dtypes or not wanted(D):
                continue
            cs.check_attention(D, dtype, cs.RATE, seed, gen, L)
            t = cs.time_attention_route(L, D, dtype, seed, gen)
            fma = {k: "-" if t[f"fma_{k}_ms"] is None else f"{t[f'fma_{k}_ms']:.4f}"
                   for k in ("fwd", "bwd")}
            print(f"L={L} D={D} {str(dtype)[6:]} ({cs.ROUTE_WORDS[t['route']]}): "
                  f"fwd {t['fwd_ms']:.4f} ms (FMA {fma['fwd']} plain "
                  f"{t['plain_fwd_ms']:.4f} sdpa {t['lib_fwd_ms']:.4f} bound "
                  f"{t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.4f} ms (FMA "
                  f"{fma['bwd']} plain {t['plain_bwd_ms']:.4f} sdpa "
                  f"{t['lib_bwd_ms']:.4f} bound {t['bwd_bound'][0]:.4f})", flush=True)
            torch.cuda.empty_cache()
        for D in (cs.HEAD_DIMS if torch.bfloat16 in dtypes else ()):
            if not wanted(D):
                continue
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
