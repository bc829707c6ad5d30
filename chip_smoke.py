#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``sarssl_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. card   : name and power limit (nvidia-smi), torch and CUDA versions;
              TF32 is switched off for matmuls and cuDNN throughout.
  2. build  : compiles ``sarssl_torch/csrc/*.cu`` with nvcc (one process per
              source, started together) and prints ptxas' register report.
  3. kernels: each hand-written kernel against its plain PyTorch version at
              the shapes the pretext step gives it, with the tolerance stated,
              and timed with CUDA events beside its bound and a library call.
  4. ref    : a small pretext model on the card (kernels) against the same
              model on the CPU (plain versions), dropout on, same seeds.
  5. train  : the flagship pretext pre-training step (bf16, batch 128,
              65792-sample 2-mic waves, fused attention, dropout 0.1): one
              warm-up and 5 timed steps through ``make_pretrain_step``, with
              the kernels' launch counts read around them, then one eval step.
Then the ``kernels`` JSON line and, last, the ``ok`` JSON line.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 128
NSAMPLE = 65792  # 4.112 s at 16 kHz -> 256 STFT frames
STEPS = 5
SEQ, HEADS = 256, 4
HEAD_DIMS = (128, 64)  # spec encoder d=512, spat encoder d=256, 4 heads
LAYERS = {128: 1, 64: 3}  # attention layers per step at each head dim
RATE = 0.1

# H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # CUDA-core rate, used for the dropout hash's 32-bit ops

# Tolerances, relative to the largest magnitude of the plain f32 result:
# bf16 inputs carry 8 mantissa bits; the kernel rounds p to bf16 before the
# PV product as the reference does, and sums 256 terms in another order.
TOL_BF16 = 2e-2
# f32 kernel against f32 plain: only the summation order differs.
TOL_F32 = 1e-4
# small model on the card against the CPU, f32, TF32 off
TOL_REF = 1e-3


def log(*a):
    print(*a, flush=True)


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN (torch.backends.*.allow_tf32 = False)")
    return smi.splitlines()[0]


def phase_build():
    from sarssl_torch.kernels._build import CSRC_DIR, build_all

    t0 = time.perf_counter()
    logs = build_all()
    log(f"[build] {len(logs)} CUDA source(s) from {CSRC_DIR.name}/ in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def max_abs(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def bound_ms(nbytes, ops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _attention_inputs(D, dtype, gen):
    shape = (BATCH, HEADS, SEQ, D)
    qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    bias = torch.randn((BATCH, HEADS, SEQ, SEQ), generator=gen, device="cuda").to(dtype)
    return qu, k, v, bias, g


def check_attention(D, dtype, rate, seed, gen):
    """Kernel (fwd + bwd) against the plain version in f32; returns errors."""
    from sarssl_torch.kernels import attention_plain, fused_attention, hash_keep_mask

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    errs = {"out": (rel_err(out, ref), max_abs(out, ref))}
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), grads, ref_grads):
        errs[name] = (rel_err(a, b), max_abs(a, b))
    torch.cuda.synchronize()
    for name, (rel, _) in errs.items():
        assert rel <= tol, f"attention D={D} {dtype} rate={rate}: {name} rel err {rel} > {tol}"
    if rate > 0:
        # the kernel's dropped positions: with v = identity columns, out = pd
        keep = hash_keep_mask(BATCH * HEADS * SEQ * SEQ, seed, rate,
                              "cuda").reshape(BATCH, HEADS, SEQ, SEQ)
        eye = torch.eye(SEQ, device="cuda", dtype=dtype)
        for c in range(SEQ // D):
            basis = eye[:, c * D:(c + 1) * D].expand(BATCH, HEADS, SEQ, D).contiguous()
            pd = fused_attention(qu, k, basis, bias, seed, scale, rate)
            same = torch.equal(pd != 0, keep[..., c * D:(c + 1) * D])
            assert same, f"attention D={D} {dtype}: dropped positions differ from the plain mask"
    log(f"[kernels] attention D={D} {str(dtype)[6:]} rate={rate}: " + ", ".join(
        f"{n} rel {r:.2e} abs {a:.2e}" for n, (r, a) in errs.items())
        + (" ; dropped positions identical" if rate > 0 else "") + f" (tol {tol})")
    return max(a for _, a in errs.values()), max(a for n, (_, a) in errs.items() if n == "out")


def time_attention(D, seed, gen):
    """Times of fwd and bwd at the step's shape (bf16, rate 0.1)."""
    from sarssl_torch.kernels import attention_plain
    from sarssl_torch.kernels.attention import launch_attention_bwd, launch_attention_fwd

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, torch.bfloat16, gen)
    res = {}
    res["fwd_ms"] = cuda_ms(lambda: launch_attention_fwd(qu, k, v, bias, seed, scale, RATE))
    res["bwd_ms"] = cuda_ms(lambda: launch_attention_bwd(qu, k, v, bias, g, seed, scale, RATE))
    with torch.no_grad():
        res["plain_fwd_ms"] = cuda_ms(lambda: attention_plain(qu, k, v, bias, seed, scale, RATE))
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = attention_plain(*xs, seed, scale, RATE)
    res["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, xs, g, retain_graph=True))
    del out
    # library yardstick (never called by the port): SDPA with the bias as a
    # float mask, rate 0
    mask = bias * scale
    with torch.no_grad():
        res["lib_fwd_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qu, k, v, attn_mask=mask, scale=scale))
    ys = [t.clone().requires_grad_() for t in (qu, k, v, mask)]
    out = torch.nn.functional.scaled_dot_product_attention(*ys[:3], attn_mask=ys[3], scale=scale)
    res["lib_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, ys, g, retain_graph=True))
    del out
    n_qkv, n_s, es = BATCH * HEADS * SEQ * D, BATCH * HEADS * SEQ * SEQ, 2
    res["fwd_bound"] = bound_ms((4 * n_qkv + n_s) * es, 4 * n_s * D, BF16_FLOPS)
    # reads qu k v g bias, writes dqu dk dv dbias; 5 products of 2*L*L*D each
    res["bwd_bound"] = bound_ms((8 * n_qkv + 2 * n_s) * es, 10 * n_s * D, BF16_FLOPS)
    return res


def check_dropout(seed, gen):
    from sarssl_torch.kernels import dropout_plain, hash_dropout
    from sarssl_torch.kernels.dropout import launch_dropout

    x = torch.randn((BATCH, SEQ, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    xr = x.clone().requires_grad_()
    out = hash_dropout(xr, seed, RATE)
    (grad,) = torch.autograd.grad(out, xr, g)
    ref, ref_grad = dropout_plain(x, seed, RATE), dropout_plain(g, seed, RATE)
    assert torch.equal(out, ref), "dropout: kernel output differs from the plain version"
    assert torch.equal(out != 0, ref != 0), "dropout: masks differ"
    assert torch.equal(grad, ref_grad), "dropout: gradient differs from mask * 1/(1-rate)"
    log(f"[kernels] hash_dropout {tuple(x.shape)} bf16 rate={RATE}: output, mask and "
        f"gradient identical to the plain version (tol: exact)")
    n = x.numel()
    return {
        "max_abs_err": max(max_abs(out, ref), max_abs(grad, ref_grad)),
        "ms": cuda_ms(lambda: launch_dropout(x, seed, RATE)),
        "plain_ms": cuda_ms(lambda: dropout_plain(x, seed, RATE)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.dropout(x, RATE, True)),
        "bound": bound_ms(2 * n * 2, 10 * n, F32_FLOPS),
    }


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = 0x9E3779B9  # a uint32 above 2**31 exercises the unsigned paths
    rows = {}
    for D in HEAD_DIMS:
        for rate in (0.0, RATE):
            err, out_err = check_attention(D, torch.bfloat16, rate, seed, gen)
            if rate == RATE:
                rows[D] = {"max_abs_err": err, "out_err": out_err}
    check_attention(64, torch.float32, RATE, seed, gen)
    for D in HEAD_DIMS:
        t = time_attention(D, seed, gen)
        rows[D].update(t)
        log(f"[kernels] attention D={D} bf16 rate={RATE}: fwd {t['fwd_ms']:.3f} ms "
            f"(plain {t['plain_fwd_ms']:.3f}, sdpa {t['lib_fwd_ms']:.3f}, bound "
            f"{t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.3f} ms (plain "
            f"{t['plain_bwd_ms']:.3f}, sdpa {t['lib_bwd_ms']:.3f}, bound {t['bwd_bound'][0]:.4f})")
    drop = check_dropout(seed, gen)
    log(f"[kernels] hash_dropout: {drop['ms']:.4f} ms (plain {drop['plain_ms']:.4f}, "
        f"F.dropout {drop['library_ms']:.4f}, bound {drop['bound'][0]:.4f})")
    return rows, drop


def kernels_line(rows, drop, counts):
    out = []
    for D in HEAD_DIMS:
        r = rows[D]
        for kind, line in (("fwd", 100), ("bwd", 128)):
            out.append({
                "name": f"attention_{kind}_d{D}", "route": "cuda",
                "source": "sarssl_torch/csrc/attention.cu",
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                "launches": counts.get(f"attention_{kind}_d{D}", 0),
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
                "bound_ms": r[f"{kind}_bound"][0], "bound_by": r[f"{kind}_bound"][1],
                "library_ms": r[f"lib_{kind}_ms"],
            })
    out.append({
        "name": "hash_dropout", "route": "triton",
        "source": "sarssl_torch/kernels/dropout.py",
        "replaces": "sarssl_tpu/kernels/dropout.py:40",
        "launches": counts.get("hash_dropout", 0), "max_abs_err": drop["max_abs_err"],
        "ms": drop["ms"], "plain_ms": drop["plain_ms"], "bound_ms": drop["bound"][0],
        "bound_by": drop["bound"][1], "library_ms": drop["library_ms"],
    })
    return {"kernels": out}


def phase_reference():
    """Small model: card (kernels) against CPU (plain versions), 2 train steps
    with dropout 0.1 and the same seeds, so both draw identical masks."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_pretrain_step

    feat = FeatureConfig(win_len=128, nfft=128)
    cfg = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                              spec_dembed=128, spat_dembed=64, spat_layers=2,
                              dropout=RATE, fused_attention=True)
    wave, _ = synth_batch(np.random.default_rng(1), 8, 63 * 64 + 128)
    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=3)
        state = create_train_state(model)
        step = make_pretrain_step(model, feat, device=dev)
        gen = torch.Generator().manual_seed(5)
        losses[dev] = [float(step(state, torch.from_numpy(wave), 1e-3, gen)["loss"])
                       for _ in range(2)]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[ref] small pretext model, 2 steps, dropout {RATE}: card {losses['cuda']} "
        f"cpu {losses['cpu']} max rel err {err:.2e} (tol {TOL_REF})")
    assert err <= TOL_REF, f"card and CPU losses differ by {err}"


def phase_train(card):
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import (create_train_state, make_pretrain_eval_step,
                                    make_pretrain_step)

    cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True)
    model = SARSSL(cfg, device="cuda", seed=0)
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda")
    wave, _ = synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gen = torch.Generator().manual_seed(0)

    t0 = time.perf_counter()
    warm = float(step(state, wave, 1e-3, gen)["loss"])
    log(f"[train] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms, loss {warm:.5f}")
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = step(state, wave, 1e-3, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = dict(launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), f"non-finite loss {losses}"
    for D in HEAD_DIMS:
        want = LAYERS[D] * STEPS
        for kind in ("fwd", "bwd"):
            got = counts.get(f"attention_{kind}_d{D}", 0)
            assert got == want, f"attention_{kind}_d{D}: {got} launches, want {want}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched"
    med = statistics.median(times)
    log(f"[train] launches over {STEPS} steps: {counts}")
    log(f"[train] losses {losses} ({card})")
    log(f"[train] median step {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, peak memory "
        f"{peak_gib:.2f} GiB ({card})")

    ev = make_pretrain_eval_step(model, FeatureConfig(), device="cuda")(state, wave, gen)
    ev = {k: float(v) for k, v in ev.items()}
    assert all(np.isfinite(list(ev.values()))), f"non-finite eval metrics {ev}"
    log(f"[train] eval step {ev}")
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    import sarssl_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_card()
    phase_build()
    rows, drop = phase_kernels()
    phase_reference()
    counts = phase_train(card)
    print(json.dumps(kernels_line(rows, drop, counts)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
