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
              shapes), and the attention at the shapes the model's options
              bring (L = 257 with the CLS token, L = 512 with one channel a
              patch), each on the route the wrapper takes. Then the attention
              module of the conformer at both
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
  6. pretrain_cli: the pre-training run through its CLI,
              ``sarssl_torch.cli.run_pretrain.main``, at the flagship width
              (bf16, batch 128, ``--synthetic --fused-attention``, 2 train +
              1 val batches an epoch): 2 epochs, then ``--resume`` to a
              third, with the launch counts zeroed before and read after,
              the files and metrics it writes checked, and the host's
              synthetic-data and checkpoint-write seconds timed. Then the
              committed trained checkpoint (epoch 27) loaded through the
              port's checkpoint reader into the flagship model at 64 frames,
              batch 2: the eval step on one replayed mask, f32 and bf16 on
              the card against f32 on the CPU.
  7. pretrain_options: the pre-training CLI's other options at the flagship
              width, each call with the launch counts zeroed before and read
              after: (a) ``--test`` on the committed trained checkpoint
              (metrics.json, PESQ in range, wav / .mat dumps, config_test.json;
              the synthetic batches, the forward, the ISTFT, PESQ and the dumps
              timed by wrapping); (b) ``--pretrain-frozen-encoder --init-ckpt``
              from it (encoders bit-identical with zero Adam moments, decoder
              and BatchNorm stats moved, no attention backward); (c)
              ``--mel-bins 30`` (the model's 30 bands, mel features card
              against CPU). Then phase ``trained`` also holds
              ``pretext_metrics`` (MSEs, ISTFT waveforms, PESQ) of the trained
              model's prediction, card f32 against CPU f32.
  8. downstream: the trunk that ``train`` just stepped, ``partial_load``ed
              into the flagship downstream model (f32, batch 8, 16640-sample
              waves, TDOA, dropout 0.1): finetune and lineareval (frozen
              encoder) steps, one warm-up and 5 timed each, with the launch
              counts read around them, and eval steps; then a small
              downstream model on the card against the CPU.
  9. downstream_cli: the downstream grid through its CLI,
              ``sarssl_torch.cli.run_downstream.main``, at the flagship width
              from the committed trained checkpoint, each call with the
              launch counts zeroed before and read after: (a) finetune, TDOA,
              batch 8, lr {1e-3, 1e-4}, 3 epochs a cell (results, ensembles,
              pruned epoch files and hash_dropout launches checked); (b) a
              lineareval cell (the ensemble's encoders bit-identical to the
              checkpoint's); (c) ``--ds-test`` on a cell of (a) (its test MAE
              again) and the no-train baseline; (d) the multi-pair model, 4
              mics, all 6 pairs (per-pair MAEs logged); (e) ``--ds-test-mode
              vis_embed`` on a cell of (a) (the t-SNE's inputs caught). The
              host's synthetic batches and checkpoint writes are timed, every
              call caught.
 10. data_path: the simulated-data path at the flagship widths, each CLI call
              with the launch counts zeroed before and asserted exactly after:
              (a) ``gen_simu`` writes a 256-item 4.112 s pre-training tree on a
              worker per host core, small val / test trees and a 2-room
              certain-room tree in process (s/item logged); ``pack_data``
              packs the 256 items (GB/s logged) and three of them are held
              against their wav and ``_info.npz``; (b) ``run_pretrain`` at the
              flagship width (bf16, batch 128, fused attention, 2 train + 1 val
              batches, 1 epoch) from the wav tree, the packed dir, and the
              packed dir staged on the card (``--resident``, f32 and int16),
              the resident runs drawing the packed run's rows; epoch utt/s and
              the host's share of the wall inside the loader's ``next``; (c)
              ``synth_batch_device`` alone at batch 128 (ms by CUDA events,
              peak GiB), its deterministic part card against CPU on the same
              draws at batch 4 (tolerance 1e-4 of the peak), a seed giving the
              same batch bit for bit, then ``run_pretrain --device-synth`` for
              2 epochs beside phase pretrain_cli's ``--synthetic`` rate; (d)
              ``run_downstream`` from the committed trained checkpoint (f32,
              batch 8, 1 epoch a cell): T60 and DRR on the 4.112 s tree each
              with ``--ds-test`` (its MAE against the cell's), ``--room-trials
              --ds-nsimroom 2`` on the certain-room tree and
              ``--fixed-train-subset`` on the packed dir (hash_dropout 56 a
              finetune step).
 11. model_options: the model's options, first each on a small model card
              against CPU (dropout on, same seeds), then at the flagship
              pretext width (bf16, batch 128, fused attention, dropout 0.1),
              each variant one warm-up and 3 timed steps through
              ``make_pretrain_step`` with its launch counts zeroed before and
              asserted exactly after, and its peak memory: (a) the mask modes
              (every drawn mask's count checked), (b) ``in_ver="same"``, (c)
              ``in_ver="single_ch_each_patch"`` (L = 512: D = 64 on the tensor
              cores, D = 32 on FMA), (d) ``use_cls`` (L = 257 on FMA) and the
              downstream model with the token, (e) ``remat_cnn`` (its first
              step against the plain one's), (f) the ``fc`` front end, (g)
              f-first (16, 16) patches with 'TF' masks, (h) transformer
              encoders, (i) the decoder's stages and CNN head, (j)
              ``MCConformer``'s forward in f32 and bf16, (k)
              ``ConformerEncoder(remat=True)`` against plain.
Then the ``kernels`` JSON line and, last, the ``ok`` JSON line.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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

# pretrain_cli: 2 train batches and 1 val batch of 128 an epoch
CLI_TRAIN_NUM, CLI_VAL_NUM = 256, 128
CLI_LR = 1e-3  # run_pretrain's default --lr
TRAINED_CKPT = "exp/pretrain_r5_ctf_s101/best_model_f16.msgpack"  # epoch 27
# the trained model in bf16 on the card against f32 on the CPU: bf16 rounding
# raises the loss (each element's error adds its square); bf16 against f32,
# both on the CPU, on these weights and waves read 1.1e-2 and 2.0e-2 on two
# masks
TOL_TRAINED_BF16 = 5e-2
# ... and its prediction, element by element, relative to max |f32|: bf16
# keeps 8 bits, and through the flagship's depth the trained model's
# prediction moves by about a tenth of its largest value (max) and 6% (mean)
# (the JAX package's bf16 against its f32 on these weights reads 0.099 and
# 0.059, the port's on the CPU 0.113 and 0.066). The card's bf16 must stay
# within this factor of the CPU's bf16 reading, taken in the same run.
TRAINED_BF16_FACTOR = 1.5

# pretrain_options: --test reads 2 val batches of 128; the frozen-encoder and
# mel runs take 1 epoch of 4 train and 1 val batches (the first step of each
# builds its new shapes' cuDNN plans: the step time is the median of the rest)
OPT_TEST_VAL_NUM = 256
OPT_TRAIN_NUM, OPT_VAL_NUM = 512, 128
MEL_BINS = 30  # the reference's n_mels (sarssl_tpu/ops/features.py:30-31)
# hash_dropout launches per pretext train step with fused attention: the
# encoders' 4 conformer blocks hold 6 dropout sites each outside the attention
# kernel, which drops its probabilities itself, each launched in the forward
# and again in the backward. With both encoders frozen no gradient flows
# through them, so only the forward launches.
PRETRAIN_DROPOUT_PER_STEP = {"train": 48, "frozen": 24}
# the trained model's pretext metrics, card f32 against CPU f32: PESQ, host
# numpy on the two reconstructions, absolute
TOL_PESQ = 1e-3

DS_BATCH = 8  # SIM_BS_SET's batch size (sarssl_tpu/config.py:49)
DS_NSAMPLE = 16640  # 1.04 s at 16 kHz -> 64 STFT frames
DS_FRAMES = 64
DS_LR = 1e-3

# downstream_cli: a cell epoch is 8 train and 4 val batches of 8, a cell's
# test and final val 4 batches each; the multi-pair run 8 train batches of 2
# examples (x 6 mic pairs = 12 pair rows) and 4 val / test batches
DSCLI_NUMS = ("--train-num", "64", "--val-num", "32", "--test-num", "32")
DSCLI_EPOCHS = 3
DSCLI_LIN_EPOCHS = 2
DSCLI_MC_NUMS = ("--train-num", "16", "--val-num", "8", "--test-num", "8")
DSCLI_MC_EPOCHS = 2
DSCLI_SEED = 100  # run_downstream's default --seed: the init weights
# hash_dropout launches per train step at the flagship depth: the two
# encoders' 4 conformer blocks hold 7 dropout sites each (2 in each feed-
# forward module, the attention probabilities, after attention, the conv
# module), each launched in the forward and again in the backward. Lineareval
# freezes both encoders, so no gradient flows through them and only the
# forward launches; the multi-pair trunk embeds with the spat encoder alone,
# so the spec encoder's block (7 sites) has no backward.
DS_DROPOUT_PER_STEP = {"finetune": 56, "lineareval": 28, "multipair": 49}

# data_path: a 256-item 4.112 s pre-training tree (2 train + 1 val batches of
# 128 an epoch, as pretrain_cli), 16-item val and test trees and a 2-room
# certain-room tree of 4 RIRs x 2 signals a room, generated on every core
DATA_T = "4.112"
DATA_NUM, DATA_EVAL_NUM = 256, 16
DATA_ROOMS, DATA_RIRS, DATA_SIGS = 2, 4, 2
DATA_SYNTH_EPOCHS = 2
SYNTH_TIMED = 5  # synth_batch_device calls timed by CUDA events at batch 128
SYNTH_CHECK_B = 4  # the synthesizer's deterministic part, card against CPU
# ... relative to the CPU wave's peak: the tolerance of the port against JAX
# on the CPU (tests/test_torch_device_synth.py); FFTs and sums in another order
TOL_SYNTH = 1e-4
# the data path's downstream cells: f32, batch 8, 1 epoch of 32 train rows
# (4 finetune steps), 16 val and 16 test rows
DS_DATA_NUMS = ("--train-num", "32", "--val-num", "16", "--test-num", "16")
# --ds-test's printed test MAE (5 decimals) against the grid's test_mae of
# the same cell: the same weights and batches on the same card
TOL_DS_TEST = 1e-4


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


def _attention_inputs(D, dtype, gen, L=SEQ):
    shape = (BATCH, HEADS, L, D)
    qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    bias = torch.randn((BATCH, HEADS, L, L), generator=gen, device="cuda").to(dtype)
    return qu, k, v, bias, g


def check_attention(D, dtype, rate, seed, gen, L=SEQ):
    """Kernel (fwd + bwd) against the plain version in f32; returns errors."""
    from sarssl_torch.kernels import (attention_plain, fused_attention, hash_keep_mask,
                                      launches)
    from sarssl_torch.kernels.attention import takes_tensor_cores

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen, L)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    names = (f"attention_fwd_d{D}", f"attention_bwd_d{D}", f"attention_fwd_tc_d{D}",
             f"attention_bwd_tc_d{D}")
    before = [launches[n] for n in names]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    rose = [launches[n] - b for n, b in zip(names, before)]
    tc = int(takes_tensor_cores(dtype, L, D))
    want = [1, 1, tc, tc]
    assert rose == want, f"attention L={L} D={D} {dtype}: launches {rose}, want {want}"
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    errs = {"out": (rel_err(out, ref), max_abs(out, ref))}
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), grads, ref_grads):
        errs[name] = (rel_err(a, b), max_abs(a, b))
    torch.cuda.synchronize()
    for name, (rel, _) in errs.items():
        assert rel <= tol, (f"attention L={L} D={D} {dtype} rate={rate}: {name} rel err "
                            f"{rel} > {tol}")
    if rate > 0:
        # the kernel's dropped positions: with v = identity columns, out = pd
        keep = hash_keep_mask(BATCH * HEADS * L * L, seed, rate,
                              "cuda").reshape(BATCH, HEADS, L, L)
        eye = torch.eye(L, device="cuda", dtype=dtype)
        for c in range(L // D):
            basis = eye[:, c * D:(c + 1) * D].expand(BATCH, HEADS, L, D).contiguous()
            pd = fused_attention(qu, k, basis, bias, seed, scale, rate)
            same = torch.equal(pd != 0, keep[..., c * D:(c + 1) * D])
            assert same, (f"attention L={L} D={D} {dtype}: dropped positions differ from "
                          f"the plain mask")
    log(f"[kernels] attention L={L} D={D} {str(dtype)[6:]} rate={rate}: " + ", ".join(
        f"{n} rel {r:.2e} abs {a:.2e}" for n, (r, a) in errs.items())
        + (" ; dropped positions identical" if rate > 0 else "")
        + f" (tol {tol}; {'tensor-core' if tc else 'FMA'} kernels)")
    return max(a for _, a in errs.values()), max(a for n, (_, a) in errs.items() if n == "out")


def time_attention(D, seed, gen):
    """Times of fwd and bwd at the step's shape (bf16, rate 0.1): the
    tensor-core kernels, and the FMA kernels they replaced there."""
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
    res.update(_attention_yardsticks(qu, k, v, bias, g, seed, scale))
    return res


def _attention_yardsticks(qu, k, v, bias, g, seed, scale):
    """Times of the plain version and of SDPA (fwd, bwd) on these inputs, and
    the bounds of the fused function at their shape and dtype."""
    from sarssl_torch.kernels import attention_plain

    res = {}
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
    B, H, L, D = qu.shape
    es = qu.element_size()
    rate = BF16_FLOPS if qu.dtype == torch.bfloat16 else F32_FLOPS
    n_qkv, n_s = B * H * L * D, B * H * L * L
    res["fwd_bound"] = bound_ms((4 * n_qkv + n_s) * es, 4 * n_s * D, rate)
    # reads qu k v g bias, writes dqu dk dv dbias; 5 products of 2*L*L*D each
    # (the saved out and row statistics that the kernels also read are left
    # out: the function needs no more than the nine tensors above)
    res["bwd_bound"] = bound_ms((8 * n_qkv + 2 * n_s) * es, 10 * n_s * D, rate)
    return res


# attention shapes the model's options bring (phase model_options), at the
# flagship batch and heads: (L, D, dtype). L = 257: the CLS token, FMA route
# at both widths; L = 512: in_ver="single_ch_each_patch" (the spec encoder at
# d = 256 on the tensor cores, the spat encoder at d = 128, D = 32, on FMA),
# and one f32 case there.
OPTION_ATTENTION_SHAPES = ((257, 128, torch.bfloat16), (257, 64, torch.bfloat16),
                           (512, 64, torch.bfloat16), (512, 32, torch.bfloat16),
                           (512, 64, torch.float32))


def time_attention_route(L, D, dtype, seed, gen):
    """Times of fwd and bwd on the route ``fused_attention`` takes at this
    shape (rate 0.1), beside the plain version, SDPA and the bound."""
    from sarssl_torch.kernels.attention import (fma_row_block, launch_attention_bwd_fma,
                                                launch_attention_bwd_mma,
                                                launch_attention_fwd_fma,
                                                launch_attention_fwd_mma, takes_tensor_cores)

    scale = 1.0 / np.sqrt(HEADS * D)
    qu, k, v, bias, g = _attention_inputs(D, dtype, gen, L)
    args = (seed, scale, RATE)
    res = {"tc": takes_tensor_cores(dtype, L, D)}
    if res["tc"]:
        out, lse = launch_attention_fwd_mma(qu, k, v, bias, *args)
        res["fwd_ms"] = cuda_ms(lambda: launch_attention_fwd_mma(qu, k, v, bias, *args))
        res["bwd_ms"] = cuda_ms(
            lambda: launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args))
        del out, lse
    else:
        res["row_block"] = (fma_row_block("fwd", L, D), fma_row_block("bwd", L, D))
        res["fwd_ms"] = cuda_ms(lambda: launch_attention_fwd_fma(qu, k, v, bias, *args))
        res["bwd_ms"] = cuda_ms(lambda: launch_attention_bwd_fma(qu, k, v, bias, g, *args))
    res.update(_attention_yardsticks(qu, k, v, bias, g, seed, scale))
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
    opt_rows = {}
    for L, D, dtype in OPTION_ATTENTION_SHAPES:
        err, out_err = check_attention(D, dtype, RATE, seed, gen, L)
        t = time_attention_route(L, D, dtype, seed, gen)
        t.update(max_abs_err=err, out_err=out_err)
        opt_rows[(L, D, dtype)] = t
        route = "tensor-core" if t["tc"] else f"FMA, row blocks (fwd, bwd) {t['row_block']}"
        log(f"[kernels] attention L={L} D={D} {str(dtype)[6:]} rate={RATE} ({route}): fwd "
            f"{t['fwd_ms']:.4f} ms (plain {t['plain_fwd_ms']:.3f}, sdpa {t['lib_fwd_ms']:.4f}, "
            f"bound {t['fwd_bound'][0]:.4f}), bwd {t['bwd_ms']:.4f} ms (plain "
            f"{t['plain_bwd_ms']:.3f}, sdpa {t['lib_bwd_ms']:.4f}, bound "
            f"{t['bwd_bound'][0]:.4f})")
        torch.cuda.empty_cache()
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
    return rows, opt_rows, drop, conv


def kernels_line(rows, opt_rows, drop, conv, counts, ds_counts, cli_counts, opt_counts,
                 dscli_counts, data_counts, mo_counts, mo_shapes):
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
                "library_ms": r[f"lib_{kind}_ms"],
                "path": "pretext train step (launches), the pre-training CLI run "
                        "(launches_pretrain_cli) and its --test, frozen-encoder and mel runs "
                        "(launches_pretrain_options), the pre-training runs from files, "
                        "resident splits and --device-synth (launches_data_path); not on the "
                        "downstream CLI's path",
                "launches_pretrain_cli": cli_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_pretrain_options": opt_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_data_path": data_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_downstream_cli": dscli_counts.get(f"attention_{kind}_d{D}", 0),
                "launches_model_options": mo_counts.get(f"attention_{kind}_tc_d{D}", 0),
            })
    for (L, D, dtype), r in opt_rows.items():
        for kind, line in (("fwd", 100), ("bwd", 128)):
            n = mo_shapes.get((L, D, str(dtype)[6:], kind), 0)
            out.append({
                "name": f"attention_{kind}_d{D}_L{L}_{str(dtype)[6:]}", "route": "cuda",
                "source": "sarssl_torch/csrc/" + ("attention_mma.cu" if r["tc"]
                                                  else "attention.cu"),
                "variant": "mma" if r["tc"] else "fma",
                "replaces": f"sarssl_tpu/kernels/attention.py:{line}",
                # the model_options phase's launches at this shape: those of
                # variant (d) (L=257) and (c) (L=512); the f32 case is no
                # variant's (those run bf16)
                "launches": n,
                "max_abs_err": r["out_err"] if kind == "fwd" else r["max_abs_err"],
                "ms": r[f"{kind}_ms"], "plain_ms": r[f"plain_{kind}_ms"],
                "bound_ms": r[f"{kind}_bound"][0], "bound_by": r[f"{kind}_bound"][1],
                "library_ms": r[f"lib_{kind}_ms"],
                "path": "phase model_options (launches_model_options): use_cls (L=257) and "
                        "in_ver=single_ch_each_patch (L=512)",
                "launches_model_options": n,
            })
    out.append({
        "name": "hash_dropout", "route": "triton",
        "source": "sarssl_torch/kernels/dropout.py",
        "replaces": "sarssl_tpu/kernels/dropout.py:40",
        "launches": counts.get("hash_dropout", 0), "max_abs_err": drop["max_abs_err"],
        "ms": drop["ms"], "plain_ms": drop["plain_ms"], "bound_ms": drop["bound"][0],
        "bound_by": drop["bound"][1], "library_ms": drop["library_ms"],
        "path": "pretext train step (launches), the pre-training CLI run "
                "(launches_pretrain_cli), its frozen-encoder and mel runs "
                "(launches_pretrain_options), the downstream finetune step "
                "(launches_downstream), the downstream CLI's runs a, b and d "
                "(launches_downstream_cli) and the data path's pre-training and downstream "
                "runs (launches_data_path)",
        "launches_pretrain_cli": cli_counts.get("hash_dropout", 0),
        "launches_pretrain_options": opt_counts.get("hash_dropout", 0),
        "launches_downstream": ds_counts.get("hash_dropout", 0),
        "launches_downstream_cli": dscli_counts.get("hash_dropout", 0),
        "launches_data_path": data_counts.get("hash_dropout", 0),
        "launches_model_options": mo_counts.get("hash_dropout", 0),
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
            "launches_pretrain_options": opt_counts.get(name, 0),
            "launches_downstream_cli": dscli_counts.get(name, 0),
            "launches_data_path": data_counts.get(name, 0),
            "launches_model_options": mo_counts.get(name, 0),
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
    return counts, model, BATCH / med


class _Tee:
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _cli(argv, cli="run_pretrain"):
    """``sarssl_torch.cli.<cli>.main(argv)``; returns its printed output."""
    import contextlib
    import importlib

    main = importlib.import_module(f"sarssl_torch.cli.{cli}").main
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    assert rc == 0, f"{cli} {argv}: exit {rc}"
    return "".join(tee.text)


class _Timed:
    """Wraps functions that a run looks up by module (or class) attribute, so
    each call is timed, with the card synchronised before and after when
    ``sync``; ``undo`` puts the originals back."""

    def __init__(self):
        self.spent, self.saved = {}, []

    def _timed(self, fn, key, sync):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            self.spent[key].append(time.perf_counter() - t0)
            return out
        return run

    def wrap(self, owner, name, key=None, sync=False):
        fn, key = getattr(owner, name), key or name
        self.spent.setdefault(key, [])
        self.saved.append((owner, name, fn))
        setattr(owner, name, self._timed(fn, key, sync))

    def wrap_made(self, owner, name, key):
        """Wraps a factory: each call of the function it returns is timed,
        synchronised (the steps that ``make_pretrain_step`` makes)."""
        make = getattr(owner, name)
        self.spent.setdefault(key, [])
        self.saved.append((owner, name, make))
        setattr(owner, name, lambda *a, **k: self._timed(make(*a, **k), key, True))

    def undo(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def phase_pretrain_cli(card, step_utt_s):
    """The flagship pre-training run through its CLI: 2 epochs, then resumed
    to a third. The host's synthetic batches and checkpoint writes are timed
    by wrapping the two functions the run calls."""
    import tempfile

    from sarssl_torch.data import synthetic
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train.schedules import cosine_schedule

    timer = _Timed()
    timer.wrap(synthetic, "synth_batch", "synth")
    timer.wrap(ckpt, "save_checkpoint", "ckpt")
    spent = timer.spent
    try:
        with tempfile.TemporaryDirectory(prefix="pretrain_cli_") as exp:
            common = ["--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH),
                      "--train-num", str(CLI_TRAIN_NUM), "--val-num", str(CLI_VAL_NUM),
                      "--exp-dir", exp]
            reset_launches()
            t0 = time.perf_counter()
            first = _cli(common + ["--epochs", "2"])
            t1 = time.perf_counter()
            second = _cli(common + ["--epochs", "3", "--resume"])
            wall = (t1 - t0, time.perf_counter() - t1)
            torch.cuda.synchronize()
            counts = dict(launches)
            files = {f: os.path.getsize(os.path.join(exp, "checkpoints", f))
                     for f in sorted(os.listdir(os.path.join(exp, "checkpoints")))}
            with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
    finally:
        timer.undo()

    # the shares below are only as good as the wrappers: both must have
    # caught every call the run made (train and val batches, one file each epoch)
    n_batches = 3 * (CLI_TRAIN_NUM + CLI_VAL_NUM) // BATCH
    assert len(spent["synth"]) == n_batches, f"{len(spent['synth'])} synthetic batches timed"
    assert len(spent["ckpt"]) == 3, f"{len(spent['ckpt'])} checkpoint writes timed"
    assert "device cuda" in first and "TF32 off" in first, "the CLI did not report its device"
    assert "epoch 0:" in first and "epoch 1:" in first and "epoch 2:" not in first
    assert "resumed from epoch 1 (latest_model.msgpack)" in second, second
    assert "epoch 2:" in second and "epoch 1:" not in second, "the resumed run ran another epoch"
    want = {f"model{e}.msgpack" for e in range(3)} | {"latest_model.msgpack",
                                                       "best_model.msgpack"}
    assert want <= set(files), f"checkpoint files {sorted(files)}"
    train = [r for r in recs if r["split"] == "train"]
    val = [r for r in recs if r["split"] == "val"]
    lrs = [cosine_schedule(2, CLI_LR)(0), cosine_schedule(2, CLI_LR)(1),
           cosine_schedule(3, CLI_LR)(2)]
    assert [r["step"] for r in train] == [0, 1, 2], train
    assert [r["lr"] for r in train] == lrs, (train, lrs)
    assert [r["step"] for r in val] == [0, 1, 2], val
    assert all(np.isfinite([r["loss"] for r in recs])), recs

    batches = CLI_TRAIN_NUM // BATCH
    train_steps, val_steps = 3 * batches, 3 * (CLI_VAL_NUM // BATCH)
    for D in HEAD_DIMS:
        for kind, n in (("fwd", train_steps + val_steps), ("bwd", train_steps)):
            for name in (f"attention_{kind}_d{D}", f"attention_{kind}_tc_d{D}"):
                got = counts.get(name, 0)
                assert got == LAYERS[D] * n, f"{name}: {got} launches, want {LAYERS[D] * n}"
    assert counts.get("hash_dropout", 0) > 0, "hash_dropout never launched on the CLI run"
    _assert_no_conv_launch(counts, "pre-training CLI")
    log(f"[pretrain_cli] launches over {train_steps} train and {val_steps} val steps: {counts}")
    log(f"[pretrain_cli] losses: train {[round(r['loss'], 5) for r in train]}, val "
        f"{[round(r['loss'], 5) for r in val]}, val diff {[round(r['diff'], 5) for r in val]}, "
        f"lr {lrs}")
    log(f"[pretrain_cli] epoch utt/s {[r['utt_per_sec'] for r in train]} beside the "
        f"train phase's step {step_utt_s:.1f} utt/s ({card})")
    log(f"[pretrain_cli] wall {wall[0]:.2f} s (2 epochs) + {wall[1]:.2f} s (resumed epoch); "
        f"synthetic batches on the host: {len(spent['synth'])} in {sum(spent['synth']):.2f} s "
        f"({sum(spent['synth']) / sum(wall):.1%} of the wall time); checkpoint writes: "
        f"{len(spent['ckpt'])} in {sum(spent['ckpt']):.2f} s "
        f"({sum(spent['ckpt']) / sum(wall):.1%}), {spent['ckpt']} ({card})")
    log(f"[pretrain_cli] checkpoint files (bytes): {files}")
    return counts, [r["utt_per_sec"] for r in train]


def _opt_run(what, argv, card, tag="pretrain_options"):
    """One ``run_pretrain`` call with the launch counts zeroed before and
    read after; returns (printed output, counts, wall seconds)."""
    from sarssl_torch.kernels import launches, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = _cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    assert "device cuda" in out and "TF32 off" in out, f"{what}: the CLI did not report its device"
    log(f"[{tag}] {what}: wall {wall:.2f} s, launches {counts} ({card})")
    return out, counts, wall


def _check_opt_attention(what, counts, fwd_steps, bwd_steps):
    for D in HEAD_DIMS:
        for kind, n in (("fwd", fwd_steps), ("bwd", bwd_steps)):
            for name in (f"attention_{kind}_d{D}", f"attention_{kind}_tc_d{D}"):
                got = counts.get(name, 0)
                assert got == LAYERS[D] * n, f"{what}: {name} {got} launches, want {LAYERS[D] * n}"
    _assert_no_conv_launch(counts, what)


def _flat(tree, path=()):
    """{'a/b/c': leaf} of a nested checkpoint dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def _pretext_test_run(tmp, card):
    """(a) ``--test`` on the committed trained checkpoint: 2 val batches."""
    import shutil

    from sarssl_torch import models
    from sarssl_torch.cli import run_pretrain
    from sarssl_torch.data import read_wav, synthetic
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import pretext_eval
    from sarssl_torch.utils import pesq, vis

    exp = os.path.join(tmp, "a")
    os.makedirs(os.path.join(exp, "checkpoints"))
    shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT,
                    ckpt.best_path(os.path.join(exp, "checkpoints")))
    timer = _Timed()
    timer.wrap(synthetic, "synth_batch", "synth")
    timer.wrap(models.SARSSL, "pretext", "forward", sync=True)
    timer.wrap(pretext_eval, "reconstruct_waveforms", "istft", sync=True)
    timer.wrap(pesq, "pesq_wb", "pesq")
    timer.wrap(run_pretrain, "_write_dumps", "dumps")
    try:
        out, counts, wall = _opt_run("(a) --test", [
            "--test", "--synthetic", "--fused-attention", "--bs", str(BATCH),
            "--val-num", str(OPT_TEST_VAL_NUM), "--exp-dir", exp], card)
    finally:
        timer.undo()
    spent = timer.spent
    nbatch = OPT_TEST_VAL_NUM // BATCH
    # the shares below are only as good as the wrappers: each caught every call
    want = {"synth": nbatch, "forward": nbatch, "istft": 2 * nbatch,
            "pesq": nbatch * BATCH * 2, "dumps": 1}
    got = {k: len(v) for k, v in spent.items()}
    assert got == want, (got, want)
    assert "loaded best checkpoint (epoch 27)" in out, out
    dumps = os.path.join(exp, "test_dumps")
    with open(os.path.join(dumps, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == {"mse", "mse_mask", "pesq", "pesq_mask_ch"}, metrics
    assert np.isfinite(list(metrics.values())).all(), metrics
    for k in ("pesq", "pesq_mask_ch"):  # the P.862.2 mapping's open range
        assert 0.999 < metrics[k] < 4.999, metrics
    files = set(os.listdir(dumps))
    assert {f for f in files if f.startswith("ins_")} == {f"ins_{i}.mat" for i in range(32)}
    for f in ("pred0.wav", "tar0.wav"):
        wav, fs = read_wav(os.path.join(dumps, f))
        assert fs == 16000 and wav.shape == (NSAMPLE, 2) and np.isfinite(wav).all(), f
        assert np.abs(wav).max() <= 1.0, f  # peak-normalised over the batch
    assert os.path.exists(os.path.join(exp, "config_test.json"))
    assert not os.path.exists(os.path.join(exp, "config.json")), "--test wrote config.json"
    if vis._plt() is None:
        assert "recon_tf.png" not in files
        assert "recon_tf.png not written: matplotlib is not installed" in out, out
        plot = "not written (no matplotlib)"
    else:
        assert "recon_tf.png" in files
        plot = "written"
    _check_opt_attention("(a) --test", counts, nbatch, 0)
    assert not counts.get("hash_dropout", 0), f"(a) --test launched dropout: {counts}"
    shares = ", ".join(f"{k} {len(v)} calls {sum(v):.2f} s ({sum(v) / wall:.1%})"
                       for k, v in spent.items())
    log(f"[pretrain_options] (a) --test, epoch-27 checkpoint, {nbatch} batches of {BATCH}: "
        f"{metrics}; 32 ins_*.mat, pred0.wav, tar0.wav, config_test.json; recon_tf.png {plot}")
    log(f"[pretrain_options] (a) wall {wall:.2f} s: {shares}; forward "
        f"{[round(1e3 * t, 1) for t in spent['forward']]} ms ({card})")
    return counts


def _frozen_encoder_run(tmp, card, train_ms):
    """(b) the decoder retrained over the trained checkpoint's frozen
    encoders: 1 epoch of 4 train and 1 val batches."""
    import shutil

    import sarssl_torch.train as train_pkg
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.utils import from_jax_params

    init = os.path.join(tmp, "init")
    os.makedirs(init)
    shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(init))
    exp = os.path.join(tmp, "b")
    timer = _Timed()
    timer.wrap_made(train_pkg, "make_pretrain_step", "step")
    try:
        out, counts, wall = _opt_run("(b) --pretrain-frozen-encoder", [
            "--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH), "--epochs", "1",
            "--train-num", str(OPT_TRAIN_NUM), "--val-num", str(OPT_VAL_NUM),
            "--pretrain-frozen-encoder", "--init-ckpt", init, "--exp-dir", exp], card)
    finally:
        timer.undo()
    steps = timer.spent["step"]
    nsteps = OPT_TRAIN_NUM // BATCH
    assert len(steps) == nsteps, steps
    src = ckpt.load_checkpoint(ckpt.best_path(init))
    n = len(from_jax_params({"params": src["params"]})[0])
    assert f"partial_load: {n}/{n} keys loaded" in out, out
    saved = ckpt.load_checkpoint(ckpt.latest_path(os.path.join(exp, "checkpoints")))
    got, want = _flat(saved["params"]), _flat(src["params"])
    adam = saved["opt_state"]["inner_state"]["0"]["0"]
    mu, nu = _flat(adam["mu"]), _flat(adam["nu"])
    assert set(got) == set(want) == set(mu) and len(got) == n
    enc = [k for k in got if not k.startswith("decoder")]
    dec = [k for k in got if k.startswith("decoder")]
    assert enc and dec
    for k in enc:  # f16 in the file, read as f32
        assert np.array_equal(got[k], want[k].astype(np.float32)), f"(b): encoder {k} moved"
        assert not mu[k].any() and not nu[k].any(), f"(b): frozen {k} has Adam moments"
    for k in dec:
        assert not np.array_equal(got[k], want[k].astype(np.float32)), f"(b): {k} did not move"
    stats = _flat(saved["batch_stats"])
    for k, v in stats.items():  # from the init (mean 0, var 1): partial_load copies no stats
        assert not np.array_equal(v, np.zeros_like(v) if k.endswith("mean") else np.ones_like(v)), (
            f"(b): BatchNorm stat {k} did not move")
    _check_opt_attention("(b) frozen encoder", counts, nsteps + OPT_VAL_NUM // BATCH, 0)
    want_drop = PRETRAIN_DROPOUT_PER_STEP["frozen"] * nsteps
    assert counts.get("hash_dropout", 0) == want_drop, (
        f"(b): hash_dropout {counts.get('hash_dropout', 0)} launches, want {want_drop}")
    log(f"[pretrain_options] (b) frozen encoders: partial_load {n}/{n}; {len(enc)} encoder "
        f"parameters bit-identical to the checkpoint's (f16 read as f32) with zero Adam moments, "
        f"{len(dec)} decoder parameters moved, all {len(stats)} BatchNorm stats moved; attention "
        f"backward 0 launches (no encoder backward), hash_dropout {want_drop} = "
        f"{PRETRAIN_DROPOUT_PER_STEP['frozen']} x {nsteps} train steps")
    log(f"[pretrain_options] (b) train steps {[round(1e3 * t, 1) for t in steps]} ms, median "
        f"after the first {1e3 * statistics.median(steps[1:]):.1f} beside phase train's "
        f"{train_ms:.1f} ms ({card})")
    return counts


def _mel_run(tmp, card, train_ms):
    """(c) pre-training on 30 mel bands: 1 epoch of 4 train and 1 val batches."""
    import sarssl_torch.train as train_pkg
    from sarssl_torch import models
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.ops import FeatureConfig, stft_features

    exp = os.path.join(tmp, "c")
    timer = _Timed()
    timer.wrap_made(train_pkg, "make_pretrain_step", "step")
    shapes, pretext = set(), models.SARSSL.pretext

    def seen(self, *a, **k):
        shapes.add(self.cfg.sig_shape)
        return pretext(self, *a, **k)
    models.SARSSL.pretext = seen
    try:
        _, counts, wall = _opt_run(f"(c) --mel-bins {MEL_BINS}", [
            "--pretrain", "--synthetic", "--fused-attention", "--bs", str(BATCH), "--epochs", "1",
            "--train-num", str(OPT_TRAIN_NUM), "--val-num", str(OPT_VAL_NUM),
            "--mel-bins", str(MEL_BINS), "--exp-dir", exp], card)
    finally:
        models.SARSSL.pretext = pretext
        timer.undo()
    steps = timer.spent["step"]
    nsteps = OPT_TRAIN_NUM // BATCH
    assert len(steps) == nsteps, steps
    assert shapes == {(MEL_BINS, SEQ, 2, 2)}, shapes
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["split"] for r in recs] == ["train", "val"], recs
    assert np.isfinite([r[k] for r in recs for k in ("loss", "diff")]).all(), recs
    _check_opt_attention("(c) mel", counts, nsteps + OPT_VAL_NUM // BATCH, nsteps)
    want_drop = PRETRAIN_DROPOUT_PER_STEP["train"] * nsteps
    assert counts.get("hash_dropout", 0) == want_drop, (
        f"(c): hash_dropout {counts.get('hash_dropout', 0)} launches, want {want_drop}")
    wave, _ = synth_batch(np.random.default_rng(13), BATCH, NSAMPLE)
    cfg = FeatureConfig(mel_bins=MEL_BINS)
    feats = {dev: stft_features(torch.from_numpy(wave).to(dev), cfg).cpu() for dev in ("cuda", "cpu")}
    err = rel_err(feats["cuda"], feats["cpu"])
    assert feats["cpu"].shape == (BATCH, 2, MEL_BINS, SEQ, 2), feats["cpu"].shape
    assert err <= TOL_REF, f"(c): mel features on the card against the CPU: rel err {err}"
    log(f"[pretrain_options] (c) mel {MEL_BINS}: model sig_shape {shapes.pop()}; losses train "
        f"{recs[0]['loss']:.5f} val {recs[1]['loss']:.5f} diff {recs[1]['diff']:.5f}; one batch's "
        f"mel features card against CPU rel err {err:.2e} (tol {TOL_REF}); hash_dropout "
        f"{want_drop} = {PRETRAIN_DROPOUT_PER_STEP['train']} x {nsteps}")
    log(f"[pretrain_options] (c) train steps {[round(1e3 * t, 1) for t in steps]} ms, median "
        f"after the first {1e3 * statistics.median(steps[1:]):.1f} beside phase train's "
        f"{train_ms:.1f} ms ({card})")
    return counts


def phase_pretrain_options(card, train_ms):
    """The pre-training CLI's remaining options at the flagship width, three
    calls each with the launch counts zeroed before and read after: (a)
    ``--test`` on the committed trained checkpoint (ISTFT, PESQ, dumps);
    (b) ``--pretrain-frozen-encoder`` from it; (c) ``--mel-bins 30``."""
    import tempfile

    total = {}
    with tempfile.TemporaryDirectory(prefix="pretrain_options_") as tmp:
        for counts in (_pretext_test_run(tmp, card), _frozen_encoder_run(tmp, card, train_ms),
                       _mel_run(tmp, card, train_ms)):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


def _ds_cli_run(what, argv, spent, card):
    """One ``run_downstream`` call with the launch counts zeroed before and
    read after, and the learners it built caught; returns (printed output,
    counts, learners, wall seconds)."""
    from sarssl_torch.kernels import launches, reset_launches
    from sarssl_torch.train import learner as learner_mod

    cls = learner_mod.DownstreamLearner
    learners, started = [], {}
    train_epoch, end_epoch = cls.train_epoch, cls.end_epoch

    def timed_train(self, *a, **k):
        if self not in learners:
            learners.append(self)
        started[id(self)] = time.perf_counter()
        return train_epoch(self, *a, **k)

    def timed_end(self, *a, **k):
        out = end_epoch(self, *a, **k)
        spent["cell_epoch"].append(time.perf_counter() - started.pop(id(self)))
        return out

    cls.train_epoch, cls.end_epoch = timed_train, timed_end
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = _cli(argv, "run_downstream")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        cls.train_epoch, cls.end_epoch = train_epoch, end_epoch
    assert "device cuda" in out and "TF32 off" in out, f"{what}: the CLI did not report its device"
    log(f"[downstream_cli] {what}: wall {wall:.2f} s, launches {counts} ({card})")
    return out, counts, learners, wall


def _ds_train_steps(learners, nbatch):
    return sum(lr.epoch for lr in learners) * nbatch


def _check_ds_launches(what, counts, steps, kind):
    want = DS_DROPOUT_PER_STEP[kind] * steps
    assert counts.get("hash_dropout", 0) == want, (
        f"{what}: hash_dropout {counts.get('hash_dropout', 0)} launches, want {want} "
        f"({DS_DROPOUT_PER_STEP[kind]} x {steps} train steps)")
    other = {k: v for k, v in counts.items() if k.startswith(("attention", "conv3x3"))}
    assert not other, f"{what}: attention or conv kernels launched: {other}"


def _read_results(exp):
    from sarssl_torch.utils.results import read_results
    res = read_results(exp)
    assert set(res) == {"task", "mode", "cells", "summary", "best", "best_test_mae"}, set(res)
    for cell, r in res["cells"].items():
        assert set(r) == {"val_mae", "test_mae", "lr", "bs", "trial", "epochs_run"}, r
        assert np.isfinite([r["val_mae"], r["test_mae"]]).all(), (cell, r)
    return res


def _records(exp, cell):
    with open(os.path.join(exp, cell, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_downstream_cli(card):
    """The downstream grid through its CLI, ``run_downstream.main``, at the
    flagship width (f32, TDOA, 1.04 s clips, batch 8) from the committed
    trained checkpoint: (a) finetune over lr {1e-3, 1e-4}, 3 epochs a cell;
    (b) one lineareval cell; (c) ``--ds-test`` on a cell of (a), and the
    no-train baseline; (d) the multi-pair model, 4 mics, all 6 pairs; (e)
    ``--ds-test-mode vis_embed`` on that cell. The host's synthetic batches
    and checkpoint writes are timed by wrapping the functions the runs
    call."""
    import importlib.util
    import shutil
    import tempfile

    from sarssl_torch import models
    from sarssl_torch.data import synthetic
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import create_train_state
    from sarssl_torch.utils import vis
    from sarssl_torch.utils.weights import from_jax_params, to_jax_params

    timer = _Timed()
    timer.spent["cell_epoch"] = []
    timer.wrap(synthetic, "synth_batch")
    timer.wrap(synthetic, "synth_batch_multich")
    timer.wrap(ckpt, "save_checkpoint")
    timer.wrap(ckpt, "save_named")
    spent = timer.spent
    total = {}
    try:
        with tempfile.TemporaryDirectory(prefix="downstream_cli_") as tmp:
            pre = os.path.join(tmp, "pretrained")
            os.makedirs(pre)
            shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT,
                            ckpt.best_path(pre))
            common = ["--ds-train", "--synthetic", "--ds-task", "TDOA", "--bs-set", str(DS_BATCH),
                      "--ntrial", "1", "--pretrain-ckpt", pre, *DSCLI_NUMS]
            nbatch = int(DSCLI_NUMS[1]) // DS_BATCH
            marks = {}

            def mark(run):  # the calls caught so far, to split them by run
                marks[run] = {k: len(v) for k, v in spent.items()}

            # (a) finetune, 2 lr cells
            exp_a = os.path.join(tmp, "a")
            out, counts, learners, wall_a = _ds_cli_run(
                "(a) finetune", common + ["--lr-set", "1e-3", "1e-4", "--epochs",
                                          str(DSCLI_EPOCHS), "--exp-dir", exp_a], spent, card)
            mark("a")
            res = _read_results(exp_a)
            cells = ["trial0_bs8_lr0.001", "trial0_bs8_lr0.0001"]  # the grid's order
            assert sorted(res["cells"]) == sorted(cells) and len(learners) == 2, res["cells"]
            n_enc = len([n for n in from_jax_params(ckpt.load_checkpoint(
                ckpt.best_path(pre)))[0] if n.startswith(("spec_encoder.", "spat_encoder."))])
            assert out.count(f"partial_load: {n_enc}/{n_enc + 4} parameters loaded") == 2, out
            sizes = {}
            for cell, lrn in zip(cells, learners):
                assert res["cells"][cell]["epochs_run"] == lrn.epoch == DSCLI_EPOCHS
                files = set(os.listdir(os.path.join(exp_a, cell, "ckpt")))
                kept = {f for f in files if re.fullmatch(r"model\d+\.msgpack", f)}
                assert "ensemble_model.msgpack" in files, (cell, files)
                assert kept == {f"model{e}.msgpack" for e in lrn.best_epochs[-5:]}, (
                    cell, kept, lrn.best_epochs)
                sizes.update({f: os.path.getsize(os.path.join(exp_a, cell, "ckpt", f))
                              for f in files})
            steps_a = _ds_train_steps(learners, nbatch)
            _check_ds_launches("(a)", counts, steps_a, "finetune")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log("[downstream_cli] (a) results: " + ", ".join(
                f"{c}: val MAE {res['cells'][c]['val_mae']:.5f} test MAE "
                f"{res['cells'][c]['test_mae']:.5f} best epochs {lrn.best_epochs}"
                for c, lrn in zip(cells, learners))
                + f"; best {res['best']}; hash_dropout {counts.get('hash_dropout', 0)} = "
                f"{DS_DROPOUT_PER_STEP['finetune']} x {steps_a} train steps; files (bytes) {sizes}")

            # (b) lineareval, 1 cell
            exp_b = os.path.join(tmp, "b")
            _, counts, learners, wall_b = _ds_cli_run(
                "(b) lineareval", common + ["--ds-trainmode", "lineareval", "--lr-set", "1e-3",
                                            "--epochs", str(DSCLI_LIN_EPOCHS), "--exp-dir",
                                            exp_b], spent, card)
            mark("b")
            _read_results(exp_b)
            ens = ckpt.load_checkpoint(ckpt.ensemble_path(os.path.join(
                exp_b, "trial0_bs8_lr0.001", "ckpt")))
            ens_p, ens_b = from_jax_params(ens)
            src = from_jax_params(ckpt.load_checkpoint(ckpt.best_path(pre)))[0]  # f16 -> f32
            cfg = models.SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), pretrain=False,
                                      dtype="float32")
            init = models.SARSSL(cfg, device="cpu", seed=DSCLI_SEED)
            enc = [n for n in ens_p if n.startswith(("spec_encoder.", "spat_encoder."))]
            assert len(enc) == n_enc
            assert all(torch.equal(ens_p[n], src[n].float()) for n in enc), (
                "lineareval: an encoder parameter of the ensemble differs from the checkpoint's")
            heads = [n for n in ens_p if n.startswith("head_")]
            init_sd = init.state_dict()
            assert heads and all(not torch.equal(ens_p[n], init_sd[n]) for n in heads), (
                "lineareval: a head parameter did not move")
            assert all(not torch.equal(v, init_sd[n]) for n, v in ens_b.items()), (
                "lineareval: a BatchNorm running stat did not move")
            steps_b = _ds_train_steps(learners, nbatch)
            _check_ds_launches("(b)", counts, steps_b, "lineareval")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log(f"[downstream_cli] (b) lineareval: {len(enc)} encoder parameters of the "
                f"ensemble bit-identical to the checkpoint's (f16 read as f32), {len(heads)} head "
                f"parameters and all {len(ens_b)} BatchNorm stats moved; hash_dropout "
                f"{counts.get('hash_dropout', 0)} = {DS_DROPOUT_PER_STEP['lineareval']} x "
                f"{steps_b} train steps")

            # (c) --ds-test on run (a)'s first cell, then the no-train baseline
            cell = cells[0]
            cell_ckpt = os.path.join(exp_a, cell, "ckpt")
            test_args = ["--ds-test", "--synthetic", "--bs-set", str(DS_BATCH), *DSCLI_NUMS,
                         "--exp-dir", os.path.join(tmp, "c")]
            t0 = time.perf_counter()
            out = _cli(test_args + ["--ckpt", cell_ckpt], "run_downstream")
            assert f"loaded {ckpt.ensemble_path(cell_ckpt)}" in out, out
            got = float(re.search(r"test \[TDOA\]: loss \S+ MAE (\S+)", out).group(1))
            want = res["cells"][cell]["test_mae"]
            assert abs(got - want) <= TOL_DS_TEST * max(1.0, abs(want)), (got, want)
            file = ckpt.load_checkpoint(ckpt.ensemble_path(cell_ckpt))
            state = ckpt.restore_state(create_train_state(models.SARSSL(cfg, device="cuda")),
                                       file, restore_opt=False)
            back = to_jax_params(state.model)
            same = all(np.array_equal(a, b) for part in ("params", "batch_stats")
                       for a, b in zip(_leaves(back[part]), _leaves(file[part])))
            assert same, "the ensemble file does not round-trip through the model"
            out = _cli(test_args + ["--ds-test-mode", "cal_metric_wo_info"], "run_downstream")
            wall_c = time.perf_counter() - t0
            mark("c")
            base = re.search(r"no-train baseline \[TDOA\]: train MAE (\S+) test MAE (\S+)", out)
            assert base and np.isfinite([float(base.group(1)), float(base.group(2))]).all(), out
            log(f"[downstream_cli] (c) --ds-test: test MAE {got:.5f} against the grid's "
                f"{want:.5f} (tol {TOL_DS_TEST} relative), the ensemble file round-trips; "
                f"no-train baseline train / test MAE {base.group(1)} / {base.group(2)} against "
                f"the finetuned cell's {want:.5f}; wall of both calls {wall_c:.2f} s ({card})")

            # (d) multi-pair: 4 mics, all 6 pairs
            exp_d = os.path.join(tmp, "d")
            mc = ["--ds-train", "--synthetic", "--nmic", "4", "--ch-mode", "MM", "--bs-set", "2",
                  "--lr-set", "1e-3", "--ntrial", "1", "--epochs", str(DSCLI_MC_EPOCHS),
                  "--pretrain-ckpt", pre, "--exp-dir", exp_d, *DSCLI_MC_NUMS]
            out, counts, learners, wall_d = _ds_cli_run("(d) multi-pair", mc, spent, card)
            mark("d")
            res_d = _read_results(exp_d)
            assert out.count(f"partial_load: {n_enc}/{n_enc + 6} parameters loaded") == 1, out
            recs = _records(exp_d, "trial0_bs2_lr0.001")
            pairs = {f"mae_pair{k}" for k in range(6)}
            evals = [r for r in recs if r["split"] != "train"]
            assert evals and all(pairs <= set(r) and "mae_pair6" not in r for r in evals), evals
            steps_d = _ds_train_steps(learners, int(DSCLI_MC_NUMS[1]) // 2)
            _check_ds_launches("(d)", counts, steps_d, "multipair")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            log(f"[downstream_cli] (d) multi-pair MM, 6 pairs: test MAE "
                f"{res_d['best_test_mae']:.5f}, per pair "
                f"{[round(evals[-2][k], 4) for k in sorted(pairs)]}; hash_dropout "
                f"{counts.get('hash_dropout', 0)} = {DS_DROPOUT_PER_STEP['multipair']} x "
                f"{steps_d} train steps ({card})")

            # (e) --ds-test-mode vis_embed on run (a)'s first cell
            seen, plot = [], vis.plot_tsne_embeddings

            def caught(embeds, labels, save_path, perplexity=30.0):
                seen.append((np.asarray(embeds), np.asarray(labels)))
                return plot(embeds, labels, save_path, perplexity)
            vis.plot_tsne_embeddings = caught
            try:
                out, counts, _, wall_e = _ds_cli_run(
                    "(e) vis_embed", test_args[:-1] + [os.path.join(tmp, "e"), "--ds-test-mode",
                                                       "vis_embed", "--ckpt", cell_ckpt],
                    spent, card)
            finally:
                vis.plot_tsne_embeddings = plot
            mark("e")
            n_test = int(DSCLI_NUMS[5])
            assert len(seen) == 1, len(seen)
            embeds, labels = seen[0]
            assert embeds.shape == (n_test, cfg.spec_dembed + cfg.spat_dembed), embeds.shape
            assert labels.shape == (n_test,) and np.isfinite(embeds).all() and \
                np.isfinite(labels).all()
            plots = vis._plt() is not None and importlib.util.find_spec("sklearn") is not None
            want_path = os.path.join(tmp, "e", "tsne.png") if plots else None
            assert f"t-SNE saved to {want_path}" in out, out
            assert not counts, f"(e) vis_embed launched kernels: {counts}"
            log(f"[downstream_cli] (e) vis_embed: plot_tsne_embeddings got {embeds.shape} finite "
                f"embeddings and {labels.shape[0]} labels; t-SNE saved to {want_path}; wall "
                f"{wall_e:.2f} s ({card})")
    finally:
        timer.undo()

    # the shares below are only as good as the wrappers: they must have caught
    # every call the runs made
    # a cell epoch draws nbatch train and 4 val batches; a cell's end 4 test
    # and 4 final val batches
    cell_batches = lambda epochs: epochs * (nbatch + 4) + 4 + 4  # noqa: E731
    want = {"a": 2 * cell_batches(DSCLI_EPOCHS), "b": cell_batches(DSCLI_LIN_EPOCHS),
            "c": 4 + nbatch + 4, "d": 0, "e": 4}  # (c): the test batches, then the baseline's
    mc_batches = DSCLI_MC_EPOCHS * (8 + 4) + 4 + 4
    runs, before = ("a", "b", "c", "d", "e"), {k: 0 for k in spent}
    split = {}
    for run in runs:
        split[run] = {k: spent[k][before[k]:marks[run][k]] for k in spent}
        before = marks[run]
    got = {run: len(split[run]["synth_batch"]) for run in runs}
    assert got == want, (got, want)
    assert len(split["d"]["synth_batch_multich"]) == len(spent["synth_batch_multich"]) == \
        mc_batches, len(spent["synth_batch_multich"])
    assert len(spent["save_checkpoint"]) == len(spent["cell_epoch"]) == (
        2 * DSCLI_EPOCHS + DSCLI_LIN_EPOCHS + DSCLI_MC_EPOCHS), spent
    assert [len(split[run]["save_named"]) for run in runs] == [2, 1, 0, 1, 0], spent
    walls = {"a": wall_a, "b": wall_b, "c": wall_c, "d": wall_d, "e": wall_e}
    for run in runs:
        part = split[run]
        synth = sum(part["synth_batch"]) + sum(part["synth_batch_multich"])
        saves = sum(part["save_checkpoint"]) + sum(part["save_named"])
        log(f"[downstream_cli] ({run}) wall {walls[run]:.2f} s; cell epochs (s) "
            f"{[round(t, 3) for t in part['cell_epoch']]}; synthetic batches on the host: "
            f"{len(part['synth_batch']) + len(part['synth_batch_multich'])} in {synth:.2f} s "
            f"({synth / walls[run]:.1%}); checkpoint writes: {len(part['save_checkpoint'])} "
            f"epoch saves {[round(t, 3) for t in part['save_checkpoint']]} s + "
            f"{len(part['save_named'])} ensemble {[round(t, 3) for t in part['save_named']]} s "
            f"({saves / walls[run]:.1%}) ({card})")
        if part["cell_epoch"]:  # the epoch saves run inside the cell epochs
            epochs = sum(part["cell_epoch"])
            log(f"[downstream_cli] ({run}) cell epochs {epochs:.2f} s in all, "
                f"{epochs / len(part['cell_epoch']):.3f} s each; the epoch saves "
                f"{sum(part['save_checkpoint']) / epochs:.1%} of it ({card})")
    return total


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield np.asarray(v)


def phase_trained(card):
    """The committed trained checkpoint, read by the port, in the flagship
    model at 64 frames: the eval step on one replayed mask, and the
    prediction element by element, f32 and bf16 on the card against f32 on
    the CPU (bf16 held to the CPU's own bf16 reading)."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, PatchMask, gen_patch_mask, stft_features
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import create_train_state, make_pretrain_eval_step
    from sarssl_torch.train.pretext_eval import pretext_metrics

    payload = ckpt.load_checkpoint(str(Path(__file__).resolve().parent / TRAINED_CKPT))
    assert payload["meta"]["epoch"] == 27, payload["meta"]
    wave, _ = synth_batch(np.random.default_rng(11), 2, DS_NSAMPLE)
    res, preds, metrics = {}, {}, {}
    runs = (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "float32"), ("cuda", "bfloat16"))
    for dev, dtype in runs:
        cfg = SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), dtype=dtype, fused_attention=True)
        model = SARSSL(cfg, device=dev, seed=0)
        state = ckpt.restore_state(create_train_state(model), payload, restore_opt=False)
        mask = gen_patch_mask(torch.Generator().manual_seed(7), 2, cfg.npatch,
                              cfg.effective_nmasked(), nmic=2, device="cpu")
        mask = PatchMask(*(t.to(dev) for t in mask))
        out = make_pretrain_eval_step(model, FeatureConfig(), device=dev)(
            state, wave, torch.Generator(), mask=mask)
        res[dev, dtype] = {k: float(v) for k, v in out.items()}
        with torch.no_grad():  # the eval step's forward, for its prediction
            feats = stft_features(torch.from_numpy(wave).to(dev, torch.float32), FeatureConfig())
            _, _, aux = model.pretext(feats, mask, False)
        preds[dev, dtype] = aux["pred"].float().cpu()
        if (dev, dtype) != ("cpu", "bfloat16"):
            t0 = time.perf_counter()
            metrics[dev, dtype] = pretext_metrics(aux, cfg.sig_shape, cfg.patch_shape,
                                                  compute_pesq=True)
            metrics[dev, dtype]["seconds"] = time.perf_counter() - t0
    ref, pref = res["cpu", "float32"], preds["cpu", "float32"]

    def pred_err(key):
        err = (preds[key] - pref).abs()
        return float(err.max() / pref.abs().max()), float(err.mean() / pref.abs().mean())

    reading = pred_err(("cpu", "bfloat16"))
    log(f"[trained] epoch-27 checkpoint, cpu bfloat16 prediction against cpu float32: max rel "
        f"{reading[0]:.3e}, mean rel {reading[1]:.3e} (the bf16 reading)")
    for dev, dtype in runs[2:]:
        r = res[dev, dtype]
        errs = {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in ("loss", "diff")}
        perr = pred_err((dev, dtype))
        if dtype == "bfloat16":
            tol = {"loss": TOL_TRAINED_BF16,
                   "pred": tuple(TRAINED_BF16_FACTOR * e for e in reading)}
        else:
            tol = {"loss": TOL_REF, "pred": (TOL_REF, TOL_REF)}
        log(f"[trained] epoch-27 checkpoint, {dev} {dtype}: loss {r['loss']:.6f} diff "
            f"{r['diff']:.6f}; against f32 on the CPU: prediction {tuple(preds[dev, dtype].shape)} "
            f"max rel {perr[0]:.3e} (tol {tol['pred'][0]:.3e}), mean rel {perr[1]:.3e} (tol "
            f"{tol['pred'][1]:.3e}); loss rel {errs['loss']:.2e} (tol {tol['loss']}); features "
            f"(diff reads only them) rel {errs['diff']:.2e} (tol {TOL_REF}) ({card})")
        assert np.isfinite(preds[dev, dtype].numpy()).all(), f"{dev} {dtype}: non-finite prediction"
        for e, t, what in zip(perr, tol["pred"], ("max", "mean")):
            assert e <= t, f"trained weights {dev} {dtype}: prediction {what} rel err {e} > {t}"
        assert errs["loss"] <= tol["loss"], f"trained weights {dev} {dtype}: loss rel err"
        assert errs["diff"] <= TOL_REF, f"trained weights {dev} {dtype}: features differ"
    assert ref["loss"] < ref["diff"], "the trained model predicts no better than a channel copy"
    check_trained_metrics(metrics, card)


def check_trained_metrics(metrics, card):
    """``pretext_metrics`` (MSEs, ISTFT, PESQ) of the trained model's
    prediction: card f32 against CPU f32, the MSEs and the waveforms within
    TOL_REF of the largest value, PESQ within TOL_PESQ; the bf16 readings
    logged."""
    ref = metrics["cpu", "float32"]
    for key in (("cuda", "float32"), ("cuda", "bfloat16")):
        m = metrics[key]
        errs = {k: abs(m[k] - ref[k]) / abs(ref[k]) for k in ("mse", "mse_mask", "mse_mask_ch")}
        errs.update({k: rel_err(torch.from_numpy(m[k]), torch.from_numpy(ref[k]))
                     for k in ("sig_pred", "sig_tar")})
        pesq_err = float(np.abs(m["pesq"] - ref["pesq"]).max())
        assert np.isfinite(m["pesq"]).all() and m["sig_pred"].shape == (2, DS_NSAMPLE, 2), key
        log(f"[trained] pretext_metrics {key[0]} {key[1]}: mse {m['mse']:.6f} mse_mask "
            f"{m['mse_mask']:.6f} mse_mask_ch {m['mse_mask_ch']:.6f} pesq "
            f"{np.round(m['pesq'], 4).tolist()} pesq_mask_ch {np.round(m['pesq_mask_ch'], 4).tolist()}"
            f"; against cpu float32: " + ", ".join(f"{k} rel {e:.2e}" for k, e in errs.items())
            + f", pesq abs {pesq_err:.2e}; {m['seconds']:.2f} s ({card})")
        if key[1] == "float32":
            for k, e in errs.items():
                assert e <= TOL_REF, f"trained pretext_metrics {key}: {k} rel err {e} > {TOL_REF}"
            assert pesq_err <= TOL_PESQ, f"trained pretext_metrics {key}: pesq err {pesq_err}"


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


# model_options: each variant of the flagship pretext model takes one warm-up
# and this many timed steps, the launch counts zeroed before the warm-up
OPTION_STEPS = 3
# hash_dropout launches per step (forward, and backward where a gradient
# flows): a conformer block holds 6 sites outside the attention kernel (7 with
# the unfused attention, whose probabilities go through the module); a
# transformer layer 3 sites and its attention-weight mask (forward only: the
# mask of ones takes no gradient), the transformer encoder 1 more site at its
# input. So the flagship's 4 encoder blocks give 48; transformer encoders
# instead (1 + 3 layers) 2 * 1 + 7 * 1 + 2 * 1 + 7 * 3 = 32; a decoder
# conformer stage adds 14, a decoder transformer stage 9; MCConformer's
# unfused forward without autograd 7 * 4 = 28.
OPTION_DROPOUT = {"encoders": 48, "transformer_encoders": 32, "dec_conformer": 14,
                  "dec_transformer": 9, "mc_forward": 28}
# remat against the plain path on the card: the forward is the same
# computation, so the loss, the running stats and the generator's state must
# be equal bit for bit; the gradients too unless a library kernel of the
# backward (cuDNN's convolution gradients) sums in an order that changes from
# call to call, so they are held to a bf16 rounding of their largest value
TOL_REMAT_GRAD = 2 ** -8


def _attention_want(spec, spat):
    """Attention launches of one pretext train step: ``spec`` / ``spat`` are
    (head dim, layers, on the tensor cores) of each encoder's conformer."""
    want = {}
    for D, layers, tc in (spec, spat):
        for kind in ("fwd", "bwd"):
            for name in (f"attention_{kind}_d{D}",) + ((f"attention_{kind}_tc_d{D}",) if tc
                                                       else ()):
                want[name] = want.get(name, 0) + layers
    return want


FLAGSHIP_ATTENTION = _attention_want((128, 1, True), (64, 3, True))


def _kernel_counts():
    from sarssl_torch.kernels import launches

    return {k: v for k, v in launches.items() if v}


class _CapturedMasks:
    """Catches the masks the pretrain step draws (``train.steps.gen_patch_mask``)."""

    def __init__(self):
        from sarssl_torch.train import steps

        self.steps, self.orig, self.masks = steps, steps.gen_patch_mask, []

        def capture(*a, **k):
            self.masks.append(self.orig(*a, **k))
            return self.masks[-1]

        steps.gen_patch_mask = capture

    def undo(self):
        self.steps.gen_patch_mask = self.orig


def _check_mask(what, m, count):
    assert bool((m.patch.sum(1) == count).all()), f"{what}: a row does not mask {count}"
    assert m.idx.shape[1] == count and bool((m.idx[:, 1:] > m.idx[:, :-1]).all()), what
    assert bool(torch.gather(m.patch, 1, m.idx).all()), f"{what}: idx and patch disagree"


def _pretext_variant(what, card, wave, want_per_step, mask_mode="T", masks=None, **kw):
    """One warm-up and OPTION_STEPS timed pretrain steps of the flagship model
    with the options ``kw``; launches asserted exactly (``want_per_step`` per
    step). Returns the variant's numbers."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_pretrain_step

    cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True, dropout=RATE, **kw)
    model = SARSSL(cfg, device="cuda", seed=0)
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda", mask_mode=mask_mode)
    gen = torch.Generator().manual_seed(0)
    nsteps = 1 + OPTION_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for i in range(nsteps):
        t0 = time.perf_counter()
        metrics = step(state, wave, 1e-3, gen, mask=None if masks is None else masks[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), f"{what}: non-finite loss {losses}"
    assert len(set(losses)) == nsteps, f"{what}: the loss did not move {losses}"
    want = {k: v * nsteps for k, v in want_per_step.items() if v}
    assert counts == want, f"{what}: launches {counts}, want {want}"
    med = statistics.median(times[1:])
    log(f"[model_options] {what}: median step {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, "
        f"peak {peak:.2f} GiB, losses {[round(x, 5) for x in losses]}, launches over "
        f"{nsteps} steps {counts} (exact) ({card})")
    del state, step, model
    torch.cuda.empty_cache()
    return {"ms": 1e3 * med, "utt_s": BATCH / med, "peak_gib": peak, "counts": counts}


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _remat_cnn_matches_plain(wave, card):
    """(e): the first step's loss, gradients, running stats and generator
    state with ``remat_cnn`` against the plain model's, same weights, mask and
    seed, on the card."""
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, gen_patch_mask, stft_features

    feats = stft_features(wave, FeatureConfig())
    runs = {}
    for remat in (False, True):
        cfg = SARSSLConfig(dtype="bfloat16", fused_attention=True, dropout=RATE,
                           remat_cnn=remat)
        model = SARSSL(cfg, device="cuda", seed=0)
        model.train()
        mask = gen_patch_mask(torch.Generator().manual_seed(1), feats.shape[0], cfg.npatch,
                              cfg.effective_nmasked(), device="cuda")
        gen = torch.Generator().manual_seed(2)
        loss, _, _ = model.pretext(feats, mask, True, gen)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                       {n: b.clone() for n, b in model.named_buffers()}, gen.get_state())
        del model, loss
    (pl, pg, pb, ps), (rl, rg, rb, rs) = runs[False], runs[True]
    assert torch.equal(pl, rl), f"remat_cnn: loss {float(rl)} against {float(pl)}"
    assert torch.equal(ps, rs), "remat_cnn: the generator moved another way"
    assert all(torch.equal(pb[n], rb[n]) for n in pb), "remat_cnn: running stats differ"
    same = sum(torch.equal(pg[n], rg[n]) for n in pg)
    worst = max(rel_err(rg[n], pg[n]) for n in pg)
    assert worst <= TOL_REMAT_GRAD, f"remat_cnn: gradient rel err {worst}"
    log(f"[model_options] (e) remat_cnn first step against plain: loss {float(pl):.6f} "
        f"identical, all {len(pb)} running stats identical, generator state identical, "
        f"{same} of {len(pg)} gradients bit-identical, worst rel err {worst:.2e} (tol "
        f"{TOL_REMAT_GRAD:.2e}) ({card})")
    del runs, feats
    torch.cuda.empty_cache()


def _downstream_cls(card, total):
    """(d), downstream: the flagship downstream model (f32, batch 8) with the
    CLS token, one finetune step for each ``downstream_token``."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    wave, tdoa = synth_batch(np.random.default_rng(2), DS_BATCH, DS_NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    gt = torch.from_numpy(tdoa / 16000.0).cuda()
    for token in ("cls", "all"):
        cfg = SARSSLConfig(sig_shape=(256, DS_FRAMES, 2, 2), pretrain=False,
                           downstream_embed="spec_spat", dtype="float32", use_cls=True,
                           downstream_token=token)
        model = SARSSL(cfg, device="cuda", seed=1)
        state = create_train_state(model)
        step = make_downstream_step(model, FeatureConfig(), "TDOA", device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        metrics = step(state, wave, gt, DS_LR, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = _kernel_counts()
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"downstream use_cls {token}: loss {loss}"
        want = {"hash_dropout": DS_DROPOUT_PER_STEP["finetune"]}
        assert counts == want, f"downstream use_cls {token}: launches {counts}, want {want}"
        _add_counts(total, counts)
        log(f"[model_options] (d) downstream use_cls, downstream_token={token!r}: one finetune "
            f"step (the first, cuDNN plans included) {ms:.1f} ms, loss {loss:.5f}, launches "
            f"{counts} (exact) ({card})")
        del state, step, model


def _mc_conformer(card, wave, total):
    """(j): MCConformer's forward at the flagship width, f32 and bf16, train
    mode with dropout, without autograd."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import MCConformer, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, stft_features

    feats = stft_features(wave, FeatureConfig())
    for dtype in ("float32", "bfloat16"):
        model = MCConformer(SARSSLConfig(dtype=dtype, dropout=RATE), device="cuda", seed=0)
        gen = torch.Generator().manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        with torch.no_grad():
            for _ in range(1 + OPTION_STEPS):
                t0 = time.perf_counter()
                out = model(feats, True, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        counts = _kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert out.shape == (BATCH, 256, 256, 2, 2), out.shape
        assert bool(torch.isfinite(out).all()), f"MCConformer {dtype}: non-finite output"
        want = {"hash_dropout": OPTION_DROPOUT["mc_forward"] * (1 + OPTION_STEPS)}
        assert counts == want, f"MCConformer {dtype}: launches {counts}, want {want}"
        _add_counts(total, counts)
        med = statistics.median(times[1:])
        log(f"[model_options] (j) MCConformer {dtype} forward (train mode, no autograd): "
            f"median {1e3 * med:.1f} ms, {BATCH / med:.1f} utt/s, peak {peak:.2f} GiB, output "
            f"{tuple(out.shape)} finite, launches {counts} (exact) ({card})")
        del model, out
        torch.cuda.empty_cache()


def _conformer_remat(card, total):
    """(k): ConformerEncoder(remat=True) at the spat width (d = 256, 3 layers,
    bf16, fused attention, dropout 0.1, batch 128, L = 256) against
    remat=False from the same weights and generator state: output, input and
    parameter gradients, running stats, generator state."""
    from sarssl_torch.kernels import reset_launches
    from sarssl_torch.models import ConformerEncoder

    x = torch.randn((BATCH, SEQ, 256), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(torch.bfloat16)
    g = torch.randn_like(x)
    runs = {}
    for remat in (False, True):
        enc = ConformerEncoder(256, 3, num_heads=HEADS, dropout=RATE, fused_attention=True,
                               dtype=torch.bfloat16, generator=torch.Generator().manual_seed(4),
                               remat=remat).cuda()
        gen = torch.Generator().manual_seed(5)
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        y = enc(xr, True, gen)
        y.backward(g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = _kernel_counts()
        _add_counts(total, counts)
        runs[remat] = (y.detach(), xr.grad, {n: p.grad for n, p in enc.named_parameters()},
                       {n: b.clone() for n, b in enc.named_buffers()}, gen.get_state(), counts,
                       ms, torch.cuda.max_memory_allocated() / 2 ** 30)
        del enc, y, xr
    plain, rem = runs[False], runs[True]
    fwd = {"attention_fwd_d64": 3, "attention_fwd_tc_d64": 3, "attention_bwd_d64": 3,
           "attention_bwd_tc_d64": 3, "hash_dropout": 36}
    # the recomputation runs each block's forward again: 3 more attention
    # forwards and 18 more dropout launches
    fwd_remat = {**fwd, "attention_fwd_d64": 6, "attention_fwd_tc_d64": 6, "hash_dropout": 54}
    assert plain[5] == fwd, f"conformer plain: launches {plain[5]}, want {fwd}"
    assert rem[5] == fwd_remat, f"conformer remat: launches {rem[5]}, want {fwd_remat}"
    assert torch.equal(plain[0], rem[0]), "conformer remat: the output differs"
    assert torch.equal(plain[4], rem[4]), "conformer remat: the generator moved another way"
    assert all(torch.equal(plain[3][n], rem[3][n]) for n in plain[3]), "running stats differ"
    grads = [(plain[1], rem[1])] + [(plain[2][n], rem[2][n]) for n in plain[2]]
    same = sum(torch.equal(a, b) for a, b in grads)
    worst = max(rel_err(b, a) for a, b in grads)
    assert worst <= TOL_REMAT_GRAD, f"conformer remat: gradient rel err {worst}"
    log(f"[model_options] (k) ConformerEncoder d=256 x 3 remat against plain, bf16 B={BATCH} "
        f"L={SEQ}: output, running stats and generator state identical; {same} of "
        f"{len(grads)} gradients (input and parameters) bit-identical, worst rel err "
        f"{worst:.2e} (tol {TOL_REMAT_GRAD:.2e}); fwd+bwd {plain[6]:.1f} ms / peak "
        f"{plain[7]:.2f} GiB plain, {rem[6]:.1f} ms / {rem[7]:.2f} GiB remat (first calls); "
        f"launches plain {plain[5]}, remat {rem[5]} (exact) ({card})")


def phase_model_options(card):
    """The model's options at the flagship pretext width, variants (a)-(k);
    each with its launch counts zeroed before and read after. Returns the
    phase's summed counts and, for the kernels line, the launches at each of
    the new attention shapes."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.ops import gen_patch_mask

    wave, _ = synth_batch(np.random.default_rng(0), BATCH, NSAMPLE)
    wave = torch.from_numpy(wave).cuda()
    total, shapes, res = {}, {}, {}
    base = {**FLAGSHIP_ATTENTION, "hash_dropout": OPTION_DROPOUT["encoders"]}

    def run(what, want, **kw):
        r = _pretext_variant(what, card, wave, want, **kw)
        _add_counts(total, r["counts"])
        res[what] = r
        return r

    run("plain", base)
    cap = _CapturedMasks()
    try:
        for mode in ("T_1s", "T_cluster", "T_cluster_inverse", "T_cluster2"):
            cap.masks.clear()
            run(f"(a) mask_mode={mode}", base, mask_mode=mode)
            count = 256 // 4 if mode == "T_1s" else 128
            assert len(cap.masks) == 1 + OPTION_STEPS, f"{mode}: {len(cap.masks)} masks drawn"
            for m in cap.masks:
                _check_mask(mode, m, count)
            log(f"[model_options] (a) {mode}: every row of the {len(cap.masks)} drawn masks "
                f"masks exactly {count} of 256 patches, idx ascending")
    finally:
        cap.undo()
    run("(b) in_ver=same", base, in_ver="same")
    r = run("(c) in_ver=single_ch_each_patch",
            {**_attention_want((64, 1, True), (32, 3, False)),
             "hash_dropout": OPTION_DROPOUT["encoders"]}, in_ver="single_ch_each_patch")
    for kind in ("fwd", "bwd"):
        shapes[(512, 64, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_tc_d64", 0)
        shapes[(512, 32, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_d32", 0)
    r = run("(d) use_cls", {**_attention_want((128, 1, False), (64, 3, False)),
                            "hash_dropout": OPTION_DROPOUT["encoders"]}, use_cls=True)
    for kind in ("fwd", "bwd"):
        shapes[(257, 128, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_d128", 0)
        shapes[(257, 64, "bfloat16", kind)] = r["counts"].get(f"attention_{kind}_d64", 0)
    _downstream_cls(card, total)
    _remat_cnn_matches_plain(wave, card)
    r = run("(e) remat_cnn", base, remat_cnn=True)
    log(f"[model_options] (e) remat_cnn peak {r['peak_gib']:.2f} GiB against the plain step's "
        f"{res['plain']['peak_gib']:.2f} GiB; step {r['ms']:.1f} against {res['plain']['ms']:.1f}"
        f" ms ({card})")
    run("(f) local_model=fc", base, local_model="fc")
    masks = [gen_patch_mask(torch.Generator().manual_seed(10 + i), BATCH, 256, 128, mode="TF",
                            grid_shape=(16, 16), device="cuda") for i in range(1 + OPTION_STEPS)]
    for m in masks:
        _check_mask("TF", m, 128)
    run("(g) f-first patch_shape=(16, 16), TF masks on the (16, 16) grid", base,
        patch_shape=(16, 16), masks=masks)
    run("(h) global_model=transformer", {"hash_dropout": OPTION_DROPOUT["transformer_encoders"]},
        global_model="transformer")
    run("(i) dec_model=(conformer, fc)",
        {**base, "hash_dropout": OPTION_DROPOUT["encoders"] + OPTION_DROPOUT["dec_conformer"]},
        dec_model=("conformer", "fc"))
    run("(i) dec_model=(transformer, fc)",
        {**base, "hash_dropout": OPTION_DROPOUT["encoders"] + OPTION_DROPOUT["dec_transformer"]},
        dec_model=("transformer", "fc"))
    run("(i) dec_model=('', cnn)", base, dec_model=("", "cnn"))
    _mc_conformer(card, wave, total)
    _conformer_remat(card, total)
    log(f"[model_options] launches over the phase: {total}")
    return total, shapes


def phase_model_options_reference():
    """Each variant of phase model_options on a small model: card (kernels)
    against CPU (plain versions), f32, dropout 0.1, the same seeds (so both
    draw the same masks and dropout seeds)."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import MCConformer, SARSSL, ConformerEncoder, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig, gen_patch_mask
    from sarssl_torch.train import (create_train_state, make_downstream_step,
                                    make_pretrain_step)

    feat = FeatureConfig(win_len=128, nfft=128)
    # spec and spat at d = 128: head dim 32, 16 with one channel a patch
    base = SARSSLConfig().tiny(sig_shape=(64, 64, 2, 2), patch_shape=(64, 1),
                               spec_dembed=128, spat_dembed=128, dropout=RATE,
                               fused_attention=True)
    wave, tdoa = synth_batch(np.random.default_rng(1), 2, 63 * 64 + 128)
    tf_masks = [gen_patch_mask(torch.Generator().manual_seed(20 + i), 2, 64, 32, mode="TF",
                               grid_shape=(8, 8)) for i in range(2)]
    cases = [("mask modes", {}, ("T_1s", "T_cluster", "T_cluster_inverse", "T_cluster2"), None),
             ("in_ver=same", dict(in_ver="same"), ("T", "T"), None),
             ("in_ver=single_ch_each_patch", dict(in_ver="single_ch_each_patch"), ("T", "T"),
              None),
             ("use_cls", dict(use_cls=True), ("T", "T"), None),
             ("remat_cnn", dict(remat_cnn=True), ("T", "T"), None),
             ("local_model=fc", dict(local_model="fc"), ("T", "T"), None),
             ("f-first (8, 8), TF", dict(patch_shape=(8, 8)), ("T", "T"), tf_masks),
             ("global_model=transformer", dict(global_model="transformer"), ("T", "T"), None),
             ("dec (conformer, fc)", dict(dec_model=("conformer", "fc")), ("T", "T"), None),
             ("dec (transformer, fc)", dict(dec_model=("transformer", "fc")), ("T", "T"), None),
             ("dec ('', cnn)", dict(dec_model=("", "cnn")), ("T", "T"), None)]
    worst = 0.0
    for what, kw, modes, masks in cases:
        cfg = SARSSLConfig(**{**base.__dict__, **kw})
        losses = {}
        for dev in ("cuda", "cpu"):
            model = SARSSL(cfg, device=dev, seed=3)
            state = create_train_state(model)
            gen = torch.Generator().manual_seed(5)
            losses[dev] = []
            for i, mode in enumerate(modes):
                step = make_pretrain_step(model, feat, device=dev, mask_mode=mode)
                mask = None if masks is None else masks[i].to(dev)
                losses[dev].append(float(step(state, wave, 1e-3, gen, mask=mask)["loss"]))
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        worst = max(worst, err)
        assert err <= TOL_REF, f"model_options ref {what}: card and CPU differ by {err}"
        log(f"[model_options] ref {what}: card {losses['cuda']} cpu {losses['cpu']} "
            f"max rel err {err:.2e}")
    gt = tdoa / 16000.0
    for token in ("cls", "all"):
        cfg = SARSSLConfig(**{**base.__dict__, "pretrain": False, "fused_attention": False,
                              "use_cls": True, "downstream_token": token})
        losses = {}
        for dev in ("cuda", "cpu"):
            model = SARSSL(cfg, device=dev, seed=4)
            state = create_train_state(model)
            step = make_downstream_step(model, feat, "TDOA", device=dev)
            gen = torch.Generator().manual_seed(6)
            losses[dev] = [float(step(state, wave, gt, DS_LR, gen)["loss"]) for _ in range(2)]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        worst = max(worst, err)
        assert err <= TOL_REF, f"model_options ref downstream {token}: differ by {err}"
        log(f"[model_options] ref downstream use_cls {token}: card {losses['cuda']} cpu "
            f"{losses['cpu']} max rel err {err:.2e}")
    outs = {}
    x = torch.randn((2, 2, 64, 64, 2), generator=torch.Generator().manual_seed(7))
    for dev in ("cuda", "cpu"):
        mc = MCConformer(base, device=dev, seed=5)
        with torch.no_grad():
            outs[dev] = mc(x.to(dev), True, torch.Generator().manual_seed(8)).cpu()
    err = rel_err(outs["cuda"], outs["cpu"])
    worst = max(worst, err)
    assert err <= TOL_REF, f"model_options ref MCConformer: differ by {err}"
    log(f"[model_options] ref MCConformer train-mode forward: max rel err {err:.2e}")
    res = {}
    xc, gc = torch.randn((2, 2, 64, 64), generator=torch.Generator().manual_seed(9))
    for dev in ("cuda", "cpu"):
        enc = ConformerEncoder(64, 2, num_heads=HEADS, dropout=RATE, fused_attention=True,
                               generator=torch.Generator().manual_seed(10), remat=True).to(dev)
        xr = xc.to(dev).detach().clone().requires_grad_()
        y = enc(xr, True, torch.Generator().manual_seed(11))
        # a random cotangent: the closing LayerNorm's outputs sum to a
        # constant, so a cotangent of ones has a zero exact gradient
        y.backward(gc.to(dev))
        res[dev] = (y.detach().cpu(), xr.grad.cpu())
    err = max(rel_err(a, b) for a, b in zip(res["cuda"], res["cpu"]))
    worst = max(worst, err)
    assert err <= TOL_REF, f"model_options ref ConformerEncoder remat: differ by {err}"
    log(f"[model_options] ref ConformerEncoder(remat=True) output and input gradient: max rel "
        f"err {err:.2e}; every case within {worst:.2e} (tol {TOL_REF})")


class _DataWait:
    """Wraps the pre-training learner's epoch loops: the host seconds each
    loop spends inside ``next`` on its batch iterable (waiting on data) are
    summed, and the first rows of every train batch kept (a device copy, no
    synchronisation) to compare what two runs drew."""

    def __init__(self, keep=4096):
        from sarssl_torch.train import learner as learner_mod
        self.cls, self.keep = learner_mod.PretrainLearner, keep
        self.wait, self.batches = 0.0, []
        self.saved = (self.cls.train_epoch, self.cls.eval_epoch)
        train_epoch, eval_epoch = self.saved
        me = self

        def train(learner, batches, generator):
            return train_epoch(learner, me._timed(batches, True), generator)

        def evaluate(learner, batches, generator, split="val"):
            return eval_epoch(learner, me._timed(batches, False), generator, split)
        self.cls.train_epoch, self.cls.eval_epoch = train, evaluate

    def _timed(self, batches, keep):
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            self.wait += time.perf_counter() - t0
            if b is None:
                return
            if keep:
                self.batches.append(b[:, :self.keep].clone())
            yield b

    def undo(self):
        self.cls.train_epoch, self.cls.eval_epoch = self.saved


def _data_pretrain_run(what, argv, card, train_steps, val_steps):
    """One ``run_pretrain`` call on the data path, launch counts exact, its
    epoch utt/s and the share of its wall spent waiting on data; returns
    (counts, kept train rows, epoch utt/s, wait share)."""
    waiter = _DataWait()
    try:
        _, counts, wall = _opt_run(what, argv, card, tag="data_path")
    finally:
        waiter.undo()
    _check_opt_attention(what, counts, train_steps + val_steps, train_steps)
    want = PRETRAIN_DROPOUT_PER_STEP["train"] * train_steps
    assert counts.get("hash_dropout", 0) == want, (
        f"{what}: hash_dropout {counts.get('hash_dropout', 0)} launches, want {want}")
    exp = argv[argv.index("--exp-dir") + 1]
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite([r["loss"] for r in recs])), recs
    utt = [r["utt_per_sec"] for r in recs if r["split"] == "train"]
    log(f"[data_path] {what}: epoch utt/s {utt}, waiting on data {waiter.wait:.2f} s "
        f"({waiter.wait / wall:.1%} of the wall {wall:.2f} s); launches exact ({card})")
    return counts, waiter.batches, utt, waiter.wait / wall


def _gen_tree(what, cli, argv, n, card):
    t0 = time.perf_counter()
    _cli(argv, cli)
    wall = time.perf_counter() - t0
    log(f"[data_path] (a) {what}: {n} items in {wall:.2f} s, {wall / n:.4f} s/item on a host "
        f"of {os.cpu_count()} cores ({card})")


def phase_data_path(card, synthetic_utt_s):
    """The simulated-data path at the flagship widths: (a) generation and
    packing; (b) pre-training from the wav tree, the packed dir and the packed
    dir staged on the card in f32 and in int16; (c) the on-card synthesizer
    alone, card against CPU, and through ``run_pretrain --device-synth``; (d)
    downstream cells from the annotated trees. Each CLI call with the launch
    counts zeroed before and asserted exactly after."""
    import shutil
    import tempfile

    from sarssl_torch import data as data_mod
    from sarssl_torch.data import FixMicSigDataset, PackedDataset
    from sarssl_torch.data import device_synth as ds
    from sarssl_torch.data.wavio import read_wav
    from sarssl_torch.train import checkpoint as ckpt

    total = {}
    cores = str(os.cpu_count())
    with tempfile.TemporaryDirectory(prefix="data_path_") as tmp:
        tree, packed = os.path.join(tmp, "pretrain"), os.path.join(tmp, "pretrain_packed")
        val, test, rooms = (os.path.join(tmp, d) for d in ("val", "test", "rooms"))
        # (a) generation and packing: the pre-training tree on a worker per
        # core; the small trees in this process (spawning workers would cost
        # more than their 16 items)
        _gen_tree(f"gen_simu --stage pretrain, {cores} workers", "gen_simu", [
            "--stage", "pretrain", "--data-num", str(DATA_NUM), "--save-dir", tree, "--T",
            DATA_T, "--workers", cores], DATA_NUM, card)
        small = ["--T", DATA_T, "--workers", "1"]
        for stage, d in (("val", val), ("test", test)):
            _gen_tree(f"gen_simu --stage {stage}, in process", "gen_simu", [
                "--stage", stage, "--data-num", str(DATA_EVAL_NUM), "--save-dir", d, *small],
                DATA_EVAL_NUM, card)
        _gen_tree(f"gen_simu_certain_room {DATA_ROOMS} rooms, in process",
                  "gen_simu_certain_room", [
                      "--room-num", str(DATA_ROOMS), "--rir-per-room", str(DATA_RIRS),
                      "--sig-per-rir", str(DATA_SIGS), "--save-dir", rooms, *small],
                  DATA_ROOMS * DATA_RIRS * DATA_SIGS, card)
        t0 = time.perf_counter()
        _cli(["--data-dir", tree, "--out", packed], "pack_data")
        pack_s = time.perf_counter() - t0
        pds = PackedDataset(packed)
        gb = pds.n * pds.meta["nsample"] * pds.meta["nch"] * 4 / 1e9
        assert pds.n == DATA_NUM and pds.meta["nsample"] == NSAMPLE, pds.meta
        paths = FixMicSigDataset(tree).data_paths
        for i in (0, DATA_NUM // 2 + 9, DATA_NUM - 1):
            wave, annos = pds[i]
            sig, fs = read_wav(str(paths[i]))
            info = np.load(str(paths[i]).replace(".wav", "_info.npz"))
            assert fs == 16000 and np.array_equal(wave, sig), i
            for key, col in (("T60", "T60_edc"), ("DRR", "DRR"), ("TDOA", "TDOA"),
                             ("SNR", "SNR")):
                assert annos[key] == np.float32(info[col]), (i, key)
        log(f"[data_path] (a) pack_data: {pds.n} items, {gb:.3f} GB in {pack_s:.2f} s, "
            f"{gb / pack_s:.3f} GB/s; items 0, {DATA_NUM // 2 + 9}, {DATA_NUM - 1} of the tree "
            f"(wav and _info.npz) equal PackedDataset's rows ({card})")

        # (b) pre-training from files at the flagship width, 1 epoch a run
        base = ["--pretrain", "--fused-attention", "--bs", str(BATCH), "--train-num",
                str(CLI_TRAIN_NUM), "--val-num", str(CLI_VAL_NUM), "--epochs", "1"]
        nb_train, nb_val = CLI_TRAIN_NUM // BATCH, CLI_VAL_NUM // BATCH
        runs = {}
        for what, src in (("wav tree", ["--data-dir", tree]),
                          ("packed", ["--data-dir", packed]),
                          ("resident f32", ["--data-dir", packed, "--resident"]),
                          ("resident int16", ["--data-dir", packed, "--resident",
                                              "--resident-dtype", "int16"])):
            exp = os.path.join(tmp, "exp_" + what.replace(" ", "_"))
            counts, rows, utt, share = _data_pretrain_run(
                f"(b) {what}", base + src + ["--exp-dir", exp], card, nb_train, nb_val)
            _add_counts(total, counts)
            runs[what] = rows
            shutil.rmtree(exp)
        _, scale = pds.all_waves_i16(NSAMPLE)
        for a, b, q in zip(runs["packed"], runs["resident f32"], runs["resident int16"]):
            assert torch.equal(a, b), "--resident drew other rows than the packed stream"
            assert float((q - a).abs().max()) <= scale / 2 + 1e-6, "int16 staging off its step"
        log(f"[data_path] (b) the resident runs drew the packed run's rows: f32 equal, int16 "
            f"within half its step ({scale / 2:.3e})")

        # (c) the on-card synthesizer: alone at the flagship batch, then card
        # against CPU on the same draws, then through the CLI
        cfg = ds.DeviceSynthConfig(nsample=NSAMPLE)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ds.synth_batch_device(gen, BATCH, cfg)  # warm-up
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: ds.synth_batch_device(gen, BATCH, cfg), iters=SYNTH_TIMED, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        log(f"[data_path] (c) synth_batch_device B={BATCH}, nsample={NSAMPLE}: {ms:.2f} ms a "
            f"batch (CUDA events, {SYNTH_TIMED} calls), peak {peak:.2f} GiB over the "
            f"{base_mem / 2 ** 30:.2f} GiB held before ({card})")
        draws = ds.draw_inputs(torch.Generator().manual_seed(1), SYNTH_CHECK_B, cfg)
        want, wl = ds.synth_pair(draws, cfg)
        got, gl = ds.synth_pair({k: v.cuda() for k, v in draws.items()}, cfg)
        err = rel_err(got.cpu(), want)
        assert err <= TOL_SYNTH, f"synth_pair card against CPU: {err}"
        assert all(rel_err(gl[k].cpu(), wl[k]) <= 1e-6 for k in wl), (gl, wl)
        again = [ds.synth_batch_device(torch.Generator(device="cuda").manual_seed(5), 16, cfg)[0]
                 for _ in range(2)]
        assert torch.equal(*again), "synth_batch_device is not deterministic on the card"
        log(f"[data_path] (c) synth_pair's deterministic part at B={SYNTH_CHECK_B} f32, card "
            f"against CPU on the same draws: max err {err:.2e} of the peak (tol {TOL_SYNTH}); "
            "labels within 1e-6; a seed gives the same batch bit for bit")
        timer = _Timed()
        timer.wrap(data_mod, "synth_batch_device", "synth", sync=True)
        exp = os.path.join(tmp, "exp_device_synth")
        try:
            counts, _, utt, _ = _data_pretrain_run(
                "(c) --device-synth", ["--pretrain", "--device-synth", "--fused-attention",
                                       "--bs", str(BATCH), "--train-num", str(CLI_TRAIN_NUM),
                                       "--val-num", str(CLI_VAL_NUM), "--epochs",
                                       str(DATA_SYNTH_EPOCHS), "--exp-dir", exp],
                card, DATA_SYNTH_EPOCHS * nb_train, DATA_SYNTH_EPOCHS * nb_val)
        finally:
            timer.undo()
        _add_counts(total, counts)
        synth = timer.spent["synth"]
        assert len(synth) == DATA_SYNTH_EPOCHS * (nb_train + nb_val), len(synth)
        with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
            nrec = sum(1 for _ in f)  # one train and one val record an epoch
        assert nrec == 2 * DATA_SYNTH_EPOCHS, nrec
        log(f"[data_path] (c) --device-synth epoch utt/s {utt} beside phase pretrain_cli's "
            f"--synthetic {synthetic_utt_s} in this run; synthesis {len(synth)} batches in "
            f"{sum(synth):.2f} s ({1e3 * statistics.median(synth):.1f} ms median, synchronised) "
            f"({card})")
        shutil.rmtree(exp)

        # (d) downstream from the annotated trees, flagship width, f32
        pre = os.path.join(tmp, "pretrained")
        os.makedirs(pre)
        shutil.copyfile(Path(__file__).resolve().parent / TRAINED_CKPT, ckpt.best_path(pre))
        spent = {"cell_epoch": []}
        dbase = ["--ds-train", "--bs-set", str(DS_BATCH), "--lr-set", str(DS_LR), "--ntrial",
                 "1", "--epochs", "1", "--pretrain-ckpt", pre, *DS_DATA_NUMS]
        held = ["--val-data-dir", val, "--test-data-dir", test]
        nbatch = int(DS_DATA_NUMS[1]) // DS_BATCH
        for task in ("T60", "DRR"):
            exp = os.path.join(tmp, "ds_" + task)
            out, counts, learners, wall = _ds_cli_run(
                f"(d) --ds-task {task}", dbase + ["--ds-task", task, "--data-dir", tree, *held,
                                                  "--exp-dir", exp], spent, card)
            _check_ds_launches(f"(d) {task}", counts, _ds_train_steps(learners, nbatch),
                               "finetune")
            _add_counts(total, counts)
            res = _read_results(exp)
            cell = next(iter(res["cells"]))
            out_t, counts_t, _, wall_t = _ds_cli_run(
                f"(d) --ds-test {task}", ["--ds-test", "--ds-task", task, "--bs-set",
                                          str(DS_BATCH), "--data-dir", tree, *held,
                                          *DS_DATA_NUMS, "--ckpt",
                                          os.path.join(exp, cell, "ckpt"), "--exp-dir",
                                          os.path.join(tmp, "ds_test_" + task)], spent, card)
            _check_ds_launches(f"(d) --ds-test {task}", counts_t, 0, "finetune")
            m = re.search(rf"test \[{task}\]: loss \S+ MAE (\S+)", out_t)
            want = res["cells"][cell]["test_mae"]
            assert m and abs(float(m.group(1)) - want) <= TOL_DS_TEST * max(1.0, abs(want)), (
                out_t, res)
            log(f"[data_path] (d) {task}: cell {cell} val MAE {res['cells'][cell]['val_mae']:.5f} "
                f"test MAE {res['cells'][cell]['test_mae']:.5f}; the cell {wall:.2f} s, its "
                f"--ds-test {wall_t:.2f} s ({card})")
        for what, argv, rows in (
                ("--room-trials", ["--data-dir", rooms, "--room-trials", "--ds-nsimroom",
                                   str(DATA_ROOMS)], DATA_ROOMS * DATA_RIRS * DATA_SIGS),
                ("--fixed-train-subset", ["--data-dir", packed, "--fixed-train-subset"],
                 int(DS_DATA_NUMS[1]))):
            exp = os.path.join(tmp, "ds_" + what.strip("-"))
            out, counts, learners, wall = _ds_cli_run(
                f"(d) {what}", dbase + argv + held + ["--exp-dir", exp], spent, card)
            _check_ds_launches(f"(d) {what}", counts,
                               _ds_train_steps(learners, min(rows, int(DS_DATA_NUMS[1]))
                                               // DS_BATCH), "finetune")
            _add_counts(total, counts)
            res = _read_results(exp)
            log(f"[data_path] (d) {what} (TDOA): {res['cells']}, {wall:.2f} s ({card})")
    return total


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    import sarssl_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_card()
    phase_build()
    rows, opt_rows, drop, conv = phase_kernels()
    phase_reference()
    counts, pretrained, step_utt_s = phase_train(card)
    cli_counts, synthetic_utt_s = phase_pretrain_cli(card, step_utt_s)
    opt_counts = phase_pretrain_options(card, 1e3 * BATCH / step_utt_s)
    phase_trained(card)
    ds_counts = phase_downstream(card, pretrained)
    phase_downstream_reference()
    dscli_counts = phase_downstream_cli(card)
    data_counts = phase_data_path(card, synthetic_utt_s)
    phase_model_options_reference()
    mo_counts, mo_shapes = phase_model_options(card)
    print(json.dumps(kernels_line(rows, opt_rows, drop, conv, counts, ds_counts, cli_counts,
                                  opt_counts, dscli_counts, data_counts, mo_counts, mo_shapes)),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
