#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``sarssl_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. card   : name and power limit (nvidia-smi), torch and CUDA versions;
              TF32 is switched off for matmuls and cuDNN throughout.
  2. build  : compiles ``sarssl_torch/csrc/*.cu`` with nvcc (one process per
              source, started together), prints ptxas' register report, and
              fails if a tensor-core kernel (attention, conv) spills or its
              library holds no tensor-core instruction.
  3. kernels: each hand-written kernel against its plain PyTorch version at
              the shapes the pretext step gives it, with the tolerance stated,
              and timed with CUDA events beside its bound and a library call
              (attention also beside the FMA kernels it replaced at these
              shapes). Then the attention module of the conformer at both
              flagship widths in bf16, fused against unfused, on the card.
              The conv part holds the four 3x3 conv launches (conv3x3 and
              its s2d form, forward and dx) at the CNN front end's shape
              (128, 256, 256, 64) bf16 on the tensor-core kernel, timed beside
              the FMA kernel it replaced there (5x floor) and cuDNN, plus a
              ragged bf16 case, the dense 128-channel instance and a small f32
              case (FMA kernel), then drives ``conv3x3`` / ``conv3x3_s2d``
              forward and backward once with the launch counts zeroed before
              and read after: the convs are on no model path, so that is
              their path.
  4. ref    : a small pretext model on the card (kernels) against the same
              model on the CPU (plain versions), dropout on, same seeds.
  5. train  : the flagship pretext pre-training step (bf16, batch 128,
              65792-sample 2-mic waves, fused attention, dropout 0.1): one
              warm-up and 5 timed steps through ``make_pretrain_step``, with
              the kernels' launch counts read around them, then one eval step.
  6. downstream: the trunk that ``train`` just stepped, ``partial_load``ed
              into the flagship downstream model (f32, batch 8, 16640-sample
              waves, TDOA, dropout 0.1): finetune and lineareval (frozen
              encoder) steps, one warm-up and 5 timed each, with the launch
              counts read around them, and eval steps; then a small
              downstream model on the card against the CPU.
Then the ``kernels`` JSON line and, last, the ``ok`` JSON line.
"""
import json
import re
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
# conv kernels in bf16 against the f32 plain version: the f32 sums over
# K = 576 are rounded once to bf16 (half an ulp is 2e-3 of the value)
TOL_CONV_BF16 = 1e-2
# the floor under the conv redesign: each tensor-core launch against the FMA
# kernel on the same inputs in the same run
CONV_FMA_FLOOR = 5.0
# the s2d form skips the blocks that are zero by construction, so it may take
# at most this much longer than conv3x3
CONV_S2D_OVER = 1.15

CONV_SHAPE = (128, 256, 256, 64)  # the CNN front end's 3x3 convs, (B, H, W, C)
CONV_SMALL = (2, 37, 50, 64)  # f32 and bf16 cases: H and W not multiples of the tile
CONV_DENSE = (2, 37, 50, 128)  # bf16, the dense 128 -> 128 instance
CONV_LAUNCHES = ("conv3x3_fwd", "conv3x3_dx", "conv3x3_s2d_fwd", "conv3x3_s2d_dx")
CONV_REPLACES = {"conv3x3": "sarssl_tpu/kernels/conv3x3.py:51",
                 "conv3x3_s2d": "sarssl_tpu/kernels/conv_s2d.py:88"}

DS_BATCH = 8  # SIM_BS_SET's batch size (sarssl_tpu/config.py:49)
DS_NSAMPLE = 16640  # 1.04 s at 16 kHz -> 64 STFT frames
DS_FRAMES = 64
DS_LR = 1e-3


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


TENSOR_CORE_SOURCES = ("attention_mma", "conv3x3_mma")


def phase_build():
    from sarssl_torch.kernels._build import CSRC_DIR, build_all, built_library, cuda_tool

    t0 = time.perf_counter()
    logs = build_all()
    log(f"[build] {len(logs)} CUDA source(s) from {CSRC_DIR.name}/ in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                if name not in TENSOR_CORE_SOURCES:  # reported per kernel below
                    log(f"  {name}: {line.strip()}")
    for name in TENSOR_CORE_SOURCES:
        report_tensor_core_kernels(name, logs[name])
    cuobjdump = cuda_tool("cuobjdump")
    assert cuobjdump is not None, "no cuobjdump in the CUDA toolkit: SASS not inspected"
    for name in TENSOR_CORE_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(built_library(name))],
                              capture_output=True, text=True, check=True).stdout
        lines = sass.splitlines()
        n_mma = sum("HMMA." in line or "HGMMA." in line for line in lines)
        n_ldsm, n_cp = sass.count("LDSM"), sass.count("LDGSTS")
        log(f"[build] {name} SASS: {n_mma} HMMA/HGMMA (tensor-core), {n_ldsm} LDSM "
            f"(ldmatrix), {n_cp} LDGSTS (cp.async) instructions")
        assert n_mma > 0, f"no tensor-core instruction in the built {name} library"


def _tensor_core_kernel(source, line):
    """(label, threads a block, dynamic shared memory) of the kernel that a
    ptxas 'Compiling entry function' line names, or None."""
    if source == "attention_mma":
        from sarssl_torch.kernels.attention import mma_smem_bytes

        threads = {"attn_fwd_mma": 128, "attn_bwd_mma": 128, "attn_dqu_mma": 128,
                   "attn_delta": 256}
        entry = re.search(r"Compiling entry function '.*?(attn_[a-z_]+?)ILi(\d+)E", line)
        if entry:
            name, D = entry.group(1), int(entry.group(2))
            return f"{name}<{D}>", threads[name], mma_smem_bytes(name, D)
    else:
        from sarssl_torch.kernels.conv3x3 import mma_smem_bytes

        entry = re.search(r"Compiling entry function '.*?conv3x3_mma_kernel"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if entry:
            args = [int(g) for g in entry.groups()]
            return (f"conv3x3_mma_kernel<{', '.join(map(str, args))}>", 256,
                    mma_smem_bytes(*args))
    return None


def report_tensor_core_kernels(source, ptxas_log):
    """Per kernel of a tensor-core source, from ptxas' report: registers a
    thread, spills, dynamic shared memory a block and the blocks per SM these
    allow. Fails if a kernel spills."""
    kernel, stack = None, 0
    if not ptxas_log:
        log(f"  {source}: built before this run, no ptxas report")
    for line in ptxas_log.splitlines():
        kernel = _tensor_core_kernel(source, line) or kernel
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if spill and kernel:
            assert spill.groups()[1:] == ("0", "0"), f"{kernel[0]} spills: {line.strip()}"
            stack = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel:
            label, threads, smem = kernel
            regs = int(used.group(1))
            # an SM has 65536 registers and 233472 bytes of shared memory, of
            # which each resident block reserves 1024 beside its own
            blocks = min(65536 // (regs * threads), 233472 // (smem + 1024))
            log(f"  {source} {label}: {regs} registers, no spills, {stack} B stack, {smem} B "
                f"shared memory, {threads} threads -> {blocks} blocks/SM")
            kernel = None


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
    from sarssl_torch.kernels import (attention_plain, fused_attention, hash_keep_mask,
                                      launches)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    tc_names = (f"attention_fwd_tc_d{D}", f"attention_bwd_tc_d{D}")
    before = [launches[n] for n in tc_names]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    rose = [launches[n] - b for n, b in zip(tc_names, before)]
    want = [1, 1] if dtype == torch.bfloat16 else [0, 0]
    assert rose == want, f"attention D={D} {dtype}: tensor-core launches {rose}, want {want}"
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
        + (" ; dropped positions identical" if rate > 0 else "")
        + f" (tol {tol}; {'tensor-core' if want[0] else 'FMA'} kernels)")
    return max(a for _, a in errs.values()), max(a for n, (_, a) in errs.items() if n == "out")


def time_attention(D, seed, gen):
    """Times of fwd and bwd at the step's shape (bf16, rate 0.1): the
    tensor-core kernels, and the FMA kernels they replaced there."""
    from sarssl_torch.kernels import attention_plain
    from sarssl_torch.kernels.attention import (launch_attention_bwd_fma,
                                                launch_attention_bwd_mma,
                                                launch_attention_fwd_fma,
                                                launch_attention_fwd_mma)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, torch.bfloat16, gen)
    args = (seed, scale, RATE)
    out, lse = launch_attention_fwd_mma(qu, k, v, bias, *args)
    res = {}
    # new, old, old, new: both sets on the same card in the same run
    res["fwd_ms"] = cuda_ms(lambda: launch_attention_fwd_mma(qu, k, v, bias, *args))
    res["fma_fwd_ms"] = cuda_ms(lambda: launch_attention_fwd_fma(qu, k, v, bias, *args))
    res["fma_bwd_ms"] = cuda_ms(lambda: launch_attention_bwd_fma(qu, k, v, bias, g, *args))
    res["bwd_ms"] = cuda_ms(lambda: launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args))
    del out, lse
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
    # (the saved out and row statistics that the kernels also read are left
    # out: the function needs no more than the nine tensors above)
    res["bwd_bound"] = bound_ms((8 * n_qkv + 2 * n_s) * es, 10 * n_s * D, BF16_FLOPS)
    return res


def check_dropout(seed, gen):
    """The kernel, forward and gradient, against the plain version bit for
    bit at the pretext step's shape (bf16) and at the downstream step's
    largest (f32: Triton builds another kernel for f32 pointers); timed at
    the pretext shape."""
    from sarssl_torch.kernels import dropout_plain, hash_dropout
    from sarssl_torch.kernels.dropout import launch_dropout

    err = 0.0
    for shape, dtype in (((BATCH, SEQ, 2048), torch.bfloat16),
                         ((DS_BATCH, DS_FRAMES, 4 * 512), torch.float32)):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn_like(x)
        xr = x.clone().requires_grad_()
        out = hash_dropout(xr, seed, RATE)
        (grad,) = torch.autograd.grad(out, xr, g)
        ref, ref_grad = dropout_plain(x, seed, RATE), dropout_plain(g, seed, RATE)
        what = f"dropout {shape} {str(dtype)[6:]}"
        assert torch.equal(out, ref), f"{what}: kernel output differs from the plain version"
        assert torch.equal(out != 0, ref != 0), f"{what}: masks differ"
        assert torch.equal(grad, ref_grad), f"{what}: gradient differs from mask * 1/(1-rate)"
        log(f"[kernels] hash_dropout {shape} {str(dtype)[6:]} rate={RATE}: output, mask "
            f"and gradient identical to the plain version (tol: exact)")
        err = max(err, max_abs(out, ref), max_abs(grad, ref_grad))
    x = torch.randn((BATCH, SEQ, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    n = x.numel()
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: launch_dropout(x, seed, RATE)),
        "plain_ms": cuda_ms(lambda: dropout_plain(x, seed, RATE)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.dropout(x, RATE, True)),
        "bound": bound_ms(2 * n * 2, 10 * n, F32_FLOPS),
    }


def _conv_cases():
    """launch name -> (public launch function, plain version, the bare
    tensor-core launch on a packed weight, that packing, the FMA kernel as it
    ran these shapes before the redesign); all but the packing of (x, w)."""
    from sarssl_torch.kernels import conv3x3_plain, conv3x3_s2d_plain, expand_weights_s2d2
    from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, launch_conv3x3_fma,
                                              launch_conv3x3_mma, pack_weights, rot180_io)
    from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx, conv3x3_s2d_fwd

    def view(x):
        B, H, W, C = x.shape
        return x.view(B, H, W // 2, 2 * C)

    def bare(x, packed):
        return launch_conv3x3_mma(x, packed, "bare")

    def fma(x, w):
        return launch_conv3x3_fma(x, w, "fma")

    def fma_s2d(x, w):
        return launch_conv3x3_fma(view(x), expand_weights_s2d2(w), "fma")

    def flipped(f):
        return lambda dy, w: f(dy, rot180_io(w))

    return {
        "conv3x3_fwd": (conv3x3_fwd, conv3x3_plain, bare, pack_weights, fma),
        "conv3x3_dx": (conv3x3_dx, flipped(conv3x3_plain), bare,
                       lambda w: pack_weights(rot180_io(w)), flipped(fma)),
        # the s2d form's bare launch is conv3x3's: the same instance walks the
        # view's chunks (kernels/conv_s2d.py)
        "conv3x3_s2d_fwd": (conv3x3_s2d_fwd, conv3x3_s2d_plain, bare, pack_weights, fma_s2d),
        "conv3x3_s2d_dx": (conv3x3_s2d_dx, flipped(conv3x3_s2d_plain), bare,
                           lambda w: pack_weights(rot180_io(w)), flipped(fma_s2d)),
    }


def _conv_small_case(name, kernel, plain, shape, cout, dtype, gen, tensor_cores):
    """One launch at a small shape against the plain version in f32; asserts
    from the launch counts which kernel ran."""
    from sarssl_torch.kernels import launches

    tol = TOL_CONV_BF16 if dtype == torch.bfloat16 else TOL_F32
    C = shape[-1]
    x = torch.randn(shape[:3] + (cout if name.endswith("_dx") else C,), generator=gen,
                    device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, cout), generator=gen, device="cuda") / np.sqrt(9 * C)).to(dtype)
    before = launches[name], launches[name + "_tc"]
    out = kernel(x, w)
    rose = launches[name] - before[0], launches[name + "_tc"] - before[1]
    assert rose == (1, int(tensor_cores)), f"{name} {shape} {dtype}: launches {rose}"
    rel = rel_err(out, plain(x.float(), w.float()))
    assert rel <= tol, f"{name} {str(dtype)[6:]} {shape}: rel err {rel} > {tol}"
    log(f"[kernels] {name} {shape} -> {cout} {str(dtype)[6:]}: rel err {rel:.2e} (tol {tol}; "
        f"{'tensor-core' if tensor_cores else 'FMA'} kernel)")


def check_conv(gen):
    """The four conv launches against their plain versions: f32 at a small
    ragged shape (FMA kernel), bf16 at the same shape, at the dense 128 ->
    128 instance and at the front end's shape (tensor-core kernel), there
    timed beside their bound, cuDNN and the FMA kernel; then the public
    functions' forward and backward once, counted."""
    from sarssl_torch.kernels import conv3x3, conv3x3_s2d, launches, reset_launches

    cases = _conv_cases()
    C = CONV_SHAPE[-1]
    for name, (kernel, plain, *_) in cases.items():
        _conv_small_case(name, kernel, plain, CONV_SMALL, C, torch.float32, gen, False)
        _conv_small_case(name, kernel, plain, CONV_SMALL, C, torch.bfloat16, gen, True)
    for name in ("conv3x3_fwd", "conv3x3_dx"):
        kernel, plain, *_ = cases[name]
        _conv_small_case(name, kernel, plain, CONV_DENSE, CONV_DENSE[-1], torch.bfloat16, gen,
                         True)

    x, dy = (torch.randn(CONV_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    w = (torch.randn((3, 3, C, C), generator=gen, device="cuda") / np.sqrt(9 * C)
         ).to(torch.bfloat16)
    # library yardstick (never called by the port): cuDNN on the NCHW
    # (channels-last) views of the same NHWC tensors
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    lib = {
        "fwd": cuda_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1),
                       iters=5, warmup=2),
        "dx": cuda_ms(lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_nchw,
                                                         padding=1), iters=5, warmup=2),
    }
    B, H, W, _ = CONV_SHAPE
    # the work of the SAME 3x3 conv, which is also what the s2d form executes:
    # the blocks of its expanded weight that are zero by construction are skipped
    nbytes, flops = 2 * x.numel() * 2 + w.numel() * 2, 2 * B * H * W * C * C * 9
    bound = bound_ms(nbytes, flops, BF16_FLOPS)
    rows = {}
    for name, (kernel, plain, bare, pack, fma) in cases.items():
        inp = dy if name.endswith("_dx") else x
        before = launches[name + "_tc"]
        out = kernel(inp, w)
        assert launches[name + "_tc"] == before + 1, f"{name}: not the tensor-core kernel"
        ref = plain(inp.float(), w.float())
        rel, err = rel_err(out, ref), max_abs(out, ref)
        del ref
        assert rel <= TOL_CONV_BF16, f"{name} bf16: rel err {rel} > {TOL_CONV_BF16}"
        packed = pack(w)
        assert torch.equal(bare(inp, packed), out), f"{name}: the bare launch differs"
        del out
        # new, old, new: the FMA kernel between two readings of the new one
        r = rows[name] = {
            "max_abs_err": err, "ms": cuda_ms(lambda: kernel(inp, w), iters=10, warmup=2),
            "fma_ms": cuda_ms(lambda: fma(inp, w), iters=3, warmup=1),
            "launch_ms": cuda_ms(lambda: bare(inp, packed), iters=10, warmup=2),
            "plain_ms": cuda_ms(lambda: plain(inp, w), iters=2, warmup=1),
            "library_ms": lib["dx" if name.endswith("_dx") else "fwd"], "bound": bound}
        r["tflops"], r["tbytes"] = flops / r["ms"] * 1e-9, nbytes / r["ms"] * 1e-9
        met = r["ms"] <= lib["fwd"] and r["ms"] <= 2 * bound[0]
        log(f"[kernels] {name} {CONV_SHAPE} bf16: rel err {rel:.2e} abs {err:.2e} "
            f"(tol {TOL_CONV_BF16}); {r['ms']:.3f} ms, the launch alone {r['launch_ms']:.3f} "
            f"(FMA kernel {r['fma_ms']:.3f}, plain {r['plain_ms']:.3f}, cuDNN "
            f"{r['library_ms']:.3f}, bound {bound[0]:.4f} by {bound[1]}); "
            f"{r['tflops']:.1f} TFLOP/s, {r['tbytes']:.3f} TB/s; target (<= cuDNN's forward "
            f"{lib['fwd']:.3f} and <= 2x the bound) {'met' if met else 'missed'}")
        assert CONV_FMA_FLOOR * r["ms"] <= r["fma_ms"], (
            f"{name}: under {CONV_FMA_FLOOR}x the FMA kernel")
    for kind in ("fwd", "dx"):
        s2d, dense = rows[f"conv3x3_s2d_{kind}"]["ms"], rows[f"conv3x3_{kind}"]["ms"]
        assert s2d <= CONV_S2D_OVER * dense, (
            f"conv3x3_s2d_{kind} {s2d} ms over {CONV_S2D_OVER}x conv3x3_{kind} {dense} ms")

    # the convs' own path: the public functions, forward and backward
    reset_launches()
    for fn in (conv3x3, conv3x3_s2d):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.grad(fn(xr, wr), (xr, wr), dy)
    torch.cuda.synchronize()
    counts = {n: launches.get(n, 0) for n in CONV_LAUNCHES}
    counts_tc = {n: launches.get(n + "_tc", 0) for n in CONV_LAUNCHES}
    log(f"[kernels] conv path (conv3x3 and conv3x3_s2d, forward + backward): launches "
        f"{counts}, of the tensor-core kernel {counts_tc}")
    for n in CONV_LAUNCHES:
        assert counts[n] == counts_tc[n] == 1, (
            f"{n}: {counts[n]} launches, {counts_tc[n]} tensor-core, on the conv path, want 1")
        rows[n]["launches"], rows[n]["launches_tc"] = counts[n], counts_tc[n]
    return rows


def check_attention_module(gen):
    """The conformer's attention module in bf16 at both flagship widths,
    B=8, L=256, rate 0: fused (tensor-core kernels) against unfused (plain
    PyTorch) on the card with the same weights; output and the gradients of
    the input, u_bias and v_bias."""
    from sarssl_torch.kernels import launches
    from sarssl_torch.models.conformer import RelPosSelfAttention

    for d_model in (512, 256):
        D = d_model // HEADS
        mods = {}
        for fused in (True, False):
            m = RelPosSelfAttention(d_model, HEADS, dropout=0.0, fused=fused,
                                    dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(7)).cuda()
            mods[fused] = m
        mods[False].load_state_dict(mods[True].state_dict())
        x = torch.randn((8, SEQ, d_model), generator=gen, device="cuda")
        g = torch.randn((8, SEQ, d_model), generator=gen, device="cuda").to(torch.bfloat16)
        res = {}
        before = launches[f"attention_fwd_tc_d{D}"], launches[f"attention_bwd_tc_d{D}"]
        for fused, m in mods.items():
            xr = x.clone().requires_grad_()
            y = m(xr, train=True)
            res[fused] = (y, *torch.autograd.grad(y, (xr, m.u_bias, m.v_bias), g))
        torch.cuda.synchronize()
        rose = (launches[f"attention_fwd_tc_d{D}"] - before[0],
                launches[f"attention_bwd_tc_d{D}"] - before[1])
        assert rose == (1, 1), f"attention module d={d_model}: tensor-core launches {rose}"
        errs = {n: rel_err(a, b) for n, a, b in
                zip(("out", "dx", "du_bias", "dv_bias"), res[True], res[False])}
        log(f"[kernels] RelPosSelfAttention d={d_model} heads={HEADS} bf16 B=8 L={SEQ}, fused "
            f"against unfused on the card: " + ", ".join(f"{n} rel {e:.2e}" for n, e in
                                                          errs.items()) + f" (tol {TOL_BF16})")
        for n, e in errs.items():
            assert e <= TOL_BF16, f"attention module d={d_model}: {n} rel err {e} > {TOL_BF16}"


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
            f"(FMA kernel {t['fma_fwd_ms']:.3f}, plain {t['plain_fwd_ms']:.3f}, sdpa "
            f"{t['lib_fwd_ms']:.3f}, bound {t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.3f} ms "
            f"(FMA kernels {t['fma_bwd_ms']:.3f}, plain {t['plain_bwd_ms']:.3f}, sdpa "
            f"{t['lib_bwd_ms']:.3f}, bound {t['bwd_bound'][0]:.4f})")
        # the floor under the redesign: the tensor-core kernels against the
        # FMA kernels in this same run
        assert 4 * t["fwd_ms"] <= t["fma_fwd_ms"], f"attention fwd D={D}: under 4x the FMA kernel"
        assert 3 * t["bwd_ms"] <= t["fma_bwd_ms"], f"attention bwd D={D}: under 3x the FMA kernels"
    check_attention_module(gen)
    drop = check_dropout(seed, gen)
    log(f"[kernels] hash_dropout: {drop['ms']:.4f} ms (plain {drop['plain_ms']:.4f}, "
        f"F.dropout {drop['library_ms']:.4f}, bound {drop['bound'][0]:.4f})")
    conv = check_conv(gen)
    return rows, drop, conv


def kernels_line(rows, drop, conv, counts, ds_counts):
    out = []
    for D in HEAD_DIMS:
        r = rows[D]
        for kind, line in (("fwd", 100), ("bwd", 128)):
            out.append({
                "name": f"attention_{kind}_d{D}", "route": "cuda",
                "source": "sarssl_torch/csrc/attention_mma.cu", "variant": "mma",
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                "launches": counts.get(f"attention_{kind}_d{D}", 0),
                "launches_tc": counts.get(f"attention_{kind}_tc_d{D}", 0),
                "fma_ms": r[f"fma_{kind}_ms"],
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
                "bound_ms": r[f"{kind}_bound"][0], "bound_by": r[f"{kind}_bound"][1],
                "library_ms": r[f"lib_{kind}_ms"], "path": "pretext train step",
            })
    out.append({
        "name": "hash_dropout", "route": "triton",
        "source": "sarssl_torch/kernels/dropout.py",
        "replaces": "sarssl_tpu/kernels/dropout.py:40",
        "launches": counts.get("hash_dropout", 0), "max_abs_err": drop["max_abs_err"],
        "ms": drop["ms"], "plain_ms": drop["plain_ms"], "bound_ms": drop["bound"][0],
        "bound_by": drop["bound"][1], "library_ms": drop["library_ms"],
        "path": "pretext train step (launches) and downstream finetune step "
                "(launches_downstream)",
        "launches_downstream": ds_counts.get("hash_dropout", 0),
    })
    for name in CONV_LAUNCHES:
        r = conv[name]
        out.append({
            "name": name, "route": "cuda", "source": "sarssl_torch/csrc/conv3x3_mma.cu",
            "variant": "wgmma", "replaces": CONV_REPLACES[name.rsplit("_", 1)[0]],
            "launches": r["launches"], "launches_tc": r["launches_tc"],
            "fma_ms": r["fma_ms"], "launch_ms": r["launch_ms"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "path": "no model path launches it; launches counted over the conv path run "
                    "of the kernels phase",
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


def _assert_no_conv_launch(counts, step):
    """The conv kernels are on no model path: a step that launched one moved."""
    conv = {k: v for k, v in counts.items() if k.startswith("conv3x3")}
    assert not conv, f"the {step} step launched conv kernels: {conv}"


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
        for kind in ("fwd", "bwd", "fwd_tc", "bwd_tc"):
            got = counts.get(f"attention_{kind}_d{D}", 0)
            assert got == want, f"attention_{kind}_d{D}: {got} launches, want {want}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched"
    _assert_no_conv_launch(counts, "pretext")
    med = statistics.median(times)
    log(f"[train] launches over {STEPS} steps: {counts}")
    log(f"[train] losses {losses} ({card})")
    log(f"[train] median step {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, peak memory "
        f"{peak_gib:.2f} GiB ({card})")

    ev = make_pretrain_eval_step(model, FeatureConfig(), device="cuda")(state, wave, gen)
    ev = {k: float(v) for k, v in ev.items()}
    assert all(np.isfinite(list(ev.values()))), f"non-finite eval metrics {ev}"
    log(f"[train] eval step {ev}")
    return counts, model


def _timed_steps(fn, n=STEPS):
    """One warm-up call of ``fn``, then ``n`` timed ones, each ending in a
    synchronise; the launch counts and peak memory are read around the timed
    calls. Returns (seconds per call, outputs, launch counts, peak GiB)."""
    from sarssl_torch.kernels import launches, reset_launches

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, outs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    _assert_no_conv_launch(launches, "downstream")
    return times, outs, dict(launches), torch.cuda.max_memory_allocated() / 2 ** 30


def _log_steps(what, times, peak, card):
    med = statistics.median(times)
    log(f"[downstream] {what}: median step {1e3 * med:.2f} ms, {DS_BATCH / med:.1f} utt/s, "
        f"peak memory {peak:.3f} GiB ({card})")


def phase_downstream(card, pretrained):
    """The flagship downstream model (run_downstream.py's default task, TDOA)
    from the pretext trunk ``pretrained``: finetune, lineareval, eval."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import (create_train_state, make_downstream_eval_step,
                                    make_downstream_step, partial_load,
                                    trainable_mask_from_loaded)

    cfg = SARSSLConfig(sig_shape=(256, 64, 2, 2), pretrain=False, downstream_embed="spec_spat",
                       dtype="float32")
    src = pretrained.state_dict()
    wave, tdoa = synth_batch(np.random.default_rng(2), DS_BATCH, DS_NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gt = torch.from_numpy(tdoa / 16000.0).cuda()  # seconds, as the JAX synthetic path

    def fresh(seed):
        model = SARSSL(cfg, device="cuda", seed=seed)
        loaded = partial_load(model, src)
        encoders = sorted(n for n, _ in model.named_parameters()
                          if n.startswith(("spec_encoder.", "spat_encoder.")))
        assert sorted(loaded) == encoders, "partial_load did not load exactly the encoders"
        return model, loaded

    model, loaded = fresh(1)
    log(f"[downstream] partial_load: {len(loaded)} encoder parameters loaded, no head "
        f"parameter, no buffer")
    state = create_train_state(model)
    step = make_downstream_step(model, FeatureConfig(), "TDOA", device="cuda")
    gen = torch.Generator().manual_seed(1)
    times, outs, counts, peak = _timed_steps(lambda: step(state, wave, gt, DS_LR, gen))
    losses = [float(o["loss"]) for o in outs]
    assert all(np.isfinite(losses)), f"non-finite finetune loss {losses}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched on the downstream step"
    attn = {k: v for k, v in counts.items() if k.startswith("attention")}
    assert not attn, f"the downstream step launched attention kernels: {attn}"
    log(f"[downstream] finetune launches over {STEPS} steps: {counts}; losses {losses}")
    _log_steps("finetune", times, peak, card)

    ev_step = make_downstream_eval_step(model, FeatureConfig(), "TDOA", device="cuda")
    times, outs, _, peak = _timed_steps(lambda: ev_step(state, wave, gt))
    ev = outs[-1]
    assert ev["pred"].shape == (DS_BATCH, 1), ev["pred"].shape
    assert ev["embed"].shape == (DS_BATCH, cfg.spec_dembed + cfg.spat_dembed), ev["embed"].shape
    metrics = {k: float(ev[k]) for k in ("loss", "mae")}
    assert all(np.isfinite(list(metrics.values()))), f"non-finite eval metrics {metrics}"
    log(f"[downstream] eval: {metrics}, pred {tuple(ev['pred'].shape)}, embed "
        f"{tuple(ev['embed'].shape)}")
    _log_steps("eval", times, peak, card)

    model, loaded = fresh(2)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    state = create_train_state(model)
    step = make_downstream_step(model, FeatureConfig(), "TDOA",
                                trainable_mask_from_loaded(model, loaded), device="cuda")
    times, outs, _, peak = _timed_steps(lambda: step(state, wave, gt, DS_LR, gen))
    losses = [float(o["loss"]) for o in outs]
    assert all(np.isfinite(losses)), f"non-finite lineareval loss {losses}"
    params = dict(model.named_parameters())
    frozen_same = all(torch.equal(params[n].detach(), start[n]) for n in loaded)
    heads = [n for n in params if n.startswith("head_")]
    heads_moved = all(not torch.equal(params[n].detach(), start[n]) for n in heads)
    stats_moved = all(not torch.equal(b, stats0[n]) for n, b in model.named_buffers())
    assert frozen_same, "lineareval moved a frozen encoder parameter"
    assert heads_moved, "lineareval left a head parameter where it was"
    assert stats_moved, "lineareval left an encoder BatchNorm running stat where it was"
    log(f"[downstream] lineareval, {STEPS + 1} steps: {len(loaded)} frozen encoder parameters "
        f"bit-identical, {len(heads)} head parameters moved, all "
        f"{len(stats0)} BatchNorm running stats moved; losses {losses}")
    _log_steps("lineareval", times, peak, card)
    return counts


def phase_downstream_reference():
    """Small downstream model: card (kernels) against CPU (plain versions),
    2 finetune steps with dropout 0.1 and the same seeds."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    feat = FeatureConfig(win_len=128, nfft=128)
    cfg = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                              spec_dembed=128, spat_dembed=64, spat_layers=2,
                              dropout=RATE, pretrain=False)
    wave, tdoa = synth_batch(np.random.default_rng(3), 8, 63 * 64 + 128)
    gt = tdoa / 16000.0
    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=4)
        state = create_train_state(model)
        step = make_downstream_step(model, feat, "TDOA", device=dev)
        gen = torch.Generator().manual_seed(6)
        losses[dev] = [float(step(state, wave, gt, DS_LR, gen)["loss"]) for _ in range(2)]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[downstream] small model, 2 finetune steps, dropout {RATE}: card {losses['cuda']} "
        f"cpu {losses['cpu']} max rel err {err:.2e} (tol {TOL_REF})")
    assert err <= TOL_REF, f"card and CPU downstream losses differ by {err}"


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    import sarssl_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_card()
    phase_build()
    rows, drop, conv = phase_kernels()
    phase_reference()
    counts, pretrained = phase_train(card)
    ds_counts = phase_downstream(card, pretrained)
    phase_downstream_reference()
    print(json.dumps(kernels_line(rows, drop, conv, counts, ds_counts)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
