#!/usr/bin/env python3
"""The wide attention at head dims no multiple of 64, unpadded (the wide
instance's column tail) against the route through the padding, at a batch
of ``chip_smoke.WIDE_B``, L = 256, rate 0.1, queued behind a sleeping kernel:

  * D = 300 and 1000 (``chip_smoke.WIDE_SMALL_HEAD_DIMS``), both dtypes: each
    pass as ``fused_attention`` runs it (``chip_smoke.time_attention_route``:
    unpadded, beside the same pass through the padding, SDPA and the bound),
    and the forward's kernels alone launched at the padded head dim on
    inputs padded beforehand (``chip_smoke.time_wide_splits``);
  * the bf16 forward at D = 200 and 254 (255, odd, has no unpadded form),
    at batch 8 and 128: the wide instance unpadded against the D = 256
    instance on inputs padded to 256, the measurement that routes the bf16
    forward at 129-255 (``attention_pass_head_dim``) to the first.

    python3 scripts/time_wide_unpadded.py [--out FILE]

Prints a line per reading and one JSON line of them all.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_wide_unpadded: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from sarssl_torch.kernels.attention import (_launch_fwd, attention_fwd_padded,
                                                launch_attention_fwd_mma)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = 0x9E3779B9
    res = {"card": torch.cuda.get_device_name(0), "route": {}, "bf16_fwd_up_to_256": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for D in cs.WIDE_SMALL_HEAD_DIMS:
            t = cs.time_attention_route(cs.SEQ, D, dtype, seed, gen, cs.WIDE_B)
            t.update(cs.time_wide_splits(D, dtype, seed, gen))
            keep = {k: t[k] for k in ("fwd_ms", "bwd_ms", "padded_fwd_ms", "padded_bwd_ms",
                                      "launch_ms", "lib_fwd_ms", "lib_bwd_ms", "splits")}
            res["route"][f"{D}_{str(dtype)[6:]}"] = keep
            print(f"D={D} {str(dtype)[6:]}: " + ", ".join(f"{k} {v}" for k, v in keep.items()),
                  flush=True)
            torch.cuda.empty_cache()
    for B, D in ((cs.WIDE_B, 200), (cs.WIDE_B, 254), (cs.BATCH, 200), (cs.BATCH, 254)):
        qu, k, v, bias, _ = cs._attention_inputs(D, torch.bfloat16, gen, cs.SEQ, B)
        drop = (seed, 1.0 / np.sqrt(cs.HEADS * D), cs.RATE)
        unpadded = cs.cuda_ms_queued(lambda: _launch_fwd("tc", qu, k, v, bias, *drop, wide=True))
        padded = cs.cuda_ms_queued(
            lambda: attention_fwd_padded(launch_attention_fwd_mma, qu, k, v, bias, *drop))
        ref = attention_fwd_padded(launch_attention_fwd_mma, qu, k, v, bias, *drop)[0]
        err = cs.rel_err(_launch_fwd("tc", qu, k, v, bias, *drop, wide=True)[0], ref)
        res["bf16_fwd_up_to_256"][f"B{B}_D{D}"] = {"wide_unpadded_ms": unpadded,
                                                   "instance_256_padded_ms": padded,
                                                   "rel_err": err}
        print(f"bf16 fwd D={D} B={B}: wide unpadded {unpadded:.4f} ms, the D = 256 "
              f"instance through the padding {padded:.4f} ms (outputs within {err:.2e})",
              flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
