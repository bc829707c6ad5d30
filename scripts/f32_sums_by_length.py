#!/usr/bin/env python3
"""How far the 3xTF32 attention forward's sums over L keys lie from float64,
on one CUDA card, for this tree and optionally another one, on the same
inputs: out (the first query rows, relative to max |out64|) and lse = m +
log(l) (the running max and row sum, absolute), beside the plain f32
version's out (TF32 off).

    python3 scripts/f32_sums_by_length.py [--parent DIR] [--lengths 4096 16384 65600]
                                          [--head-dims 16] [--rows 2048] [--out FILE]

The inputs are ``chip_smoke.py::_f32_sums_by_length``'s: qu, k, v standard
normal (1, 1, L, D), the bias standard normal (1, 1, L, L), scale 0.25,
rate 0, drawn on the card from one seed for both trees. An error in out with
lse exact is the drift of o, the unnormalised sum of p v. ``DIR`` holds the
other tree (e.g. a parent commit unpacked with ``git archive``), loaded as
``scripts/time_kernel_pairs.py`` loads it. Prints one JSON line a (L, D).
"""
import argparse
import json
import sys
from importlib import import_module
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE / "scripts")]
from time_kernel_pairs import load_kernels  # noqa: E402


def errors(attn, qu, k, v, bias, rows, scale=0.25):
    """(out rel err, lse abs err) of ``attn``'s 3xTF32 forward against
    float64 over the first ``rows`` query rows; also the float64 peak."""
    out, lse = attn.launch_attention_fwd_tf32(qu, k, v, bias, 0, scale, 0.0)
    q, kk, vv, b = qu[0, 0, :rows], k[0, 0], v[0, 0], bias[0, 0, :rows]
    s = (q.double() @ kk.double().T + b.double()) * scale
    lse64 = torch.logsumexp(s, -1)
    ref = torch.softmax(s, -1) @ vv.double()
    peak = float(ref.abs().max())
    return (float((out[0, 0, :rows].double() - ref).abs().max()) / peak,
            float((lse[0, 0, :rows].double() - lse64).abs().max()), peak, ref)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--lengths", type=int, nargs="+", default=[4096, 16384, 65600])
    ap.add_argument("--head-dims", type=int, nargs="+", default=[16])
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32_sums_by_length: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"change": import_module("sarssl_torch.kernels.attention")}
    if a.parent:
        trees["parent"] = import_module(load_kernels(a.parent, "parent_kernels").__name__
                                        + ".attention")
    gen = torch.Generator(device="cuda").manual_seed(22)
    lines = []
    for D in a.head_dims:
        for L in a.lengths:
            qu, k, v = (torch.randn((1, 1, L, D), generator=gen, device="cuda") for _ in range(3))
            bias = torch.randn((1, 1, L, L), generator=gen, device="cuda")
            res = {"L": L, "D": D, "rows": a.rows,
                   "device": torch.cuda.get_device_name(0)}
            for name, attn in trees.items():
                out_err, lse_err, res["peak"], ref = errors(attn, qu, k, v, bias, a.rows)
                res[name] = {"out_rel": out_err, "lse_abs": lse_err}
            q, kk, vv, b = qu[0, 0, :a.rows], k[0, 0], v[0, 0], bias[0, 0, :a.rows]
            plain = torch.softmax((q @ kk.T + b) * 0.25, -1) @ vv
            res["plain_f32_out_rel"] = float((plain.double() - ref).abs().max()) / res["peak"]
            del qu, k, v, bias, ref, plain
            torch.cuda.empty_cache()
            line = json.dumps(res)
            print(line, flush=True)
            lines.append(line)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
