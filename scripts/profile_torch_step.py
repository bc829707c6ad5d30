#!/usr/bin/env python3
"""Where the device time of the port's flagship steps goes.

    python3 scripts/profile_torch_step.py [--steps 3]
    python3 scripts/profile_torch_step.py --downstream finetune|lineareval|eval

By default builds the flagship pretext config (bf16, batch 128, 65792-sample
2-mic waves, fused attention, dropout 0.1) as ``chip_smoke.py`` does. With
``--downstream`` it builds the flagship downstream config instead (f32, batch
8, 16640-sample waves, TDOA, dropout 0.1; lineareval freezes both encoders)
from random weights. Runs two warm-up steps, then times ``--steps`` steps
without the profiler (each ending in a synchronise, as ``chip_smoke.py``
times them), then profiles ``--steps`` more with ``torch.profiler`` (CPU +
CUDA). Prints the card's name and power limit, the median unprofiled step
time, the wall time per step under the profiler, the device kernel time per
step, the busy share (that kernel time over the unprofiled median, both from
this run), the kernel launches per step and the device time per step by
kernel group and by kernel. Needs a GPU.
"""
import sys
from pathlib import Path

# Run as a file, Python puts scripts/ first on the path, and its profile.py
# would shadow the standard library's; the repo root takes its place.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

GROUPS = [  # (group, substrings of the kernel name), first match wins
    ("attention (attn_*, CUDA)", ("attn_",)),
    ("hash_dropout (Triton)", ("hash_dropout",)),
    ("optimizer (Adam)", ("adam", "multi_tensor")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "xmma_fprop", "dgrad", "wgrad")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("layer norm / softmax", ("layer_norm", "softmax")),
    ("reductions", ("reduce",)),
    ("elementwise / copies", ("elementwise", "vectorized", "copy", "cat", "fill",
                              "index", "where", "pad")),
]
HAND_WRITTEN = tuple(g for g, _ in GROUPS[:2])


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def build_step(downstream):
    """One flagship step as a closure of no arguments."""
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import (create_train_state, make_downstream_eval_step,
                                    make_downstream_step, make_pretrain_step)

    gen = torch.Generator().manual_seed(0)
    if downstream is None:
        model = SARSSL(SARSSLConfig(dtype="bfloat16", fused_attention=True), device="cuda")
        state = create_train_state(model)
        step = make_pretrain_step(model, FeatureConfig(), device="cuda")
        wave, _ = synth_batch(np.random.default_rng(0), 128, 65792)
        wave = torch.from_numpy(wave).cuda()
        return lambda: step(state, wave, 1e-3, gen)
    model = SARSSL(SARSSLConfig(sig_shape=(256, 64, 2, 2), pretrain=False), device="cuda")
    state = create_train_state(model)
    wave, tdoa = synth_batch(np.random.default_rng(0), 8, 16640)
    wave, gt = torch.from_numpy(wave).cuda(), torch.from_numpy(tdoa / 16000.0).cuda()
    if downstream == "eval":
        ev = make_downstream_eval_step(model, FeatureConfig(), "TDOA", device="cuda")
        return lambda: ev(state, wave, gt)
    mask = None
    if downstream == "lineareval":
        mask = {n: n.startswith("head_") for n, _ in model.named_parameters()}
    step = make_downstream_step(model, FeatureConfig(), "TDOA", mask, device="cuda")
    return lambda: step(state, wave, gt, 1e-3, gen)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--downstream", choices=("finetune", "lineareval", "eval"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a GPU")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = build_step(args.downstream)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    plain_us = statistics.median(times) * 1e6

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / args.steps

    per_kernel = defaultdict(float)
    counts = defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.device_time_total / args.steps
            counts[evt.name] += 1
    dev_us = sum(per_kernel.values())
    print(f"{args.downstream or 'pretext'} step: median {plain_us / 1e3:.2f} ms/step "
          f"unprofiled, wall {wall_us / 1e3:.2f} ms/step profiled; device kernel time "
          f"{dev_us / 1e3:.2f} ms/step; busy share {dev_us / plain_us:.3f} (unprofiled), "
          f"{dev_us / wall_us:.3f} (profiled); {sum(counts.values()) / args.steps:.0f} "
          f"kernel launches/step ({card})")
    if dev_us == 0:
        sys.exit("profiler recorded no device time")
    groups = defaultdict(float)
    for name, us in per_kernel.items():
        groups[group_of(name)] += us
    print("device time per step by group:")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.3f} ms  {100 * us / dev_us:5.1f}%  {group}")
    print("top kernels (device ms per step, launches per step):")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    # the 25 longest, and every hand-written kernel wherever it ranks
    shown = ranked[:25] + [kv for kv in ranked[25:] if group_of(kv[0]) in HAND_WRITTEN]
    for name, us in shown:
        print(f"  {us / 1e3:9.3f} ms  {counts[name] / args.steps:6.1f}  "
              f"{group_of(name)[:12]:12s}  {name[:110]}")


if __name__ == "__main__":
    main()
