#!/usr/bin/env python3
"""Where the device time of the port's flagship pretext step goes.

    python3 scripts/profile_torch_step.py [--steps 3]

Builds the flagship config (bf16, batch 128, 65792-sample 2-mic waves, fused
attention, dropout 0.1) as ``chip_smoke.py`` does, runs two warm-up steps,
then profiles ``--steps`` steps with ``torch.profiler`` (CPU + CUDA). Prints
the card's name and power limit, the wall time per step, the device busy
share (kernel time over wall time) and the device time per step by kernel
group and by kernel. Needs a GPU.
"""
import sys
from pathlib import Path

# Run as a file, Python puts scripts/ first on the path, and its profile.py
# would shadow the standard library's; the repo root takes its place.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

GROUPS = [  # (group, substrings of the kernel name), first match wins
    ("attention (attn_*, CUDA)", ("attn_fwd", "attn_bwd")),
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


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a GPU")
    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_pretrain_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = SARSSL(SARSSLConfig(dtype="bfloat16", fused_attention=True), device="cuda")
    state = create_train_state(model)
    step = make_pretrain_step(model, FeatureConfig(), device="cuda")
    wave, _ = synth_batch(np.random.default_rng(0), 128, 65792)
    wave = torch.from_numpy(wave).cuda()
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, wave, 1e-3, gen)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, wave, 1e-3, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / args.steps

    per_kernel = defaultdict(float)
    counts = defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.device_time_total / args.steps
            counts[evt.name] += 1
    dev_us = sum(per_kernel.values())
    print(f"wall {wall_us / 1e3:.2f} ms/step; device kernel time {dev_us / 1e3:.2f} ms/step; "
          f"busy share {dev_us / wall_us:.3f} ({card})")
    if dev_us == 0:
        sys.exit("profiler recorded no device time")
    groups = defaultdict(float)
    for name, us in per_kernel.items():
        groups[group_of(name)] += us
    print("device time per step by group:")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.3f} ms  {100 * us / dev_us:5.1f}%  {group}")
    print("top kernels (device ms per step, launches per step):")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3:9.3f} ms  {counts[name] / args.steps:6.1f}  "
              f"{group_of(name)[:12]:12s}  {name[:110]}")


if __name__ == "__main__":
    main()
