#!/usr/bin/env python3
"""Emulate, in numpy on the host, the 3xTF32 attention forward's sum over L
keys for a few query rows, in the kernel's order, under models of how the
tensor core adds its products into the f32 accumulator, and print each
model's error against float64.

    python3 scripts/emulate_tf32_sums.py [--lengths 4096 16384 65600] [--rows 64]
                                         [--peak-rows 2048] [--seed 0] [--out FILE]

The inputs are drawn as ``chip_smoke.py::_f32_sums_by_length`` draws them on
the card (same distributions, numpy's generator): qu, k, v standard normal
(1, 1, L, 16), the bias standard normal (1, 1, L, L), scale 0.25, rate 0.
The error is max |out - out64| over the first ``--rows`` query rows, divided
by the largest |out64| of the first ``--peak-rows`` rows, as the card's
check divides it.

``csrc/attention_f32_mma.cu::attn_fwd_tf32`` at head dim 16 walks the keys in
tiles of 64 with a running max m and row sum l (online softmax); each tile
rescales o by exp2(m_old - m_new) and adds p v in eight 8-key k-steps, each
three ``mma.m16n8k8`` TF32 products of operands split x = hi + lo (``cvt.rna``)
in ``mma1688_3x``'s order: lo(p) hi(v), hi(p) lo(v), hi(p) hi(v). The
emulation keeps that order and the f32 steps around it (s exact then
rounded to f32, p = exp2(s - m) in f32, l summed in f32 by four lanes of
sixteen keys a tile, o / l at the end), and models the accumulator:

  rn     each mma's result is c + sum of its 8 products rounded to the
         nearest f32 (an adder that rounds as an f32 FMA chain would);
  trunc  the tensor core's adder: the 8 exact products and c are aligned to
         the largest exponent among them, the bits below 24 significant bits
         of it dropped (toward zero), summed, and the sum truncated to f32;
  rz     the exact sum of c and the 8 products, cut toward zero to f32;
  floor  ``trunc`` with every cut toward -inf (two's complement shifts);
  tile-M the model M inside the mma, but every key tile's products go into a
         zeroed fragment that is added to o with an f32 add (rounded to
         nearest);
  kstep-M the same for every 8-key k-step's three products: the repair in
         ``mma_acc_rows``.
"""
import argparse
import json
import sys

import numpy as np

D, BK, SCALE = 16, 64, 0.25
LOG2E = 1.4426950408889634


def tf32_rna(x):
    """f32 -> TF32 as cvt.rna: round to nearest, ties away from zero, the 13
    low mantissa bits cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna((x - hi).astype(np.float32))


def trunc_to(x, ebits, floor=False):
    """x (f64) cut to multiples of 2**ebits (elementwise): toward zero, or
    with ``floor`` toward -inf (a two's complement shift)."""
    q = np.ldexp(1.0, ebits)
    return (np.floor(x / q) if floor else np.trunc(x / q)) * q


def f32_cut(x, floor=False):
    """f64 -> f32 at x's own 24 significant bits, toward zero or -inf."""
    _, e = np.frexp(x)
    return trunc_to(x, e - 24, floor).astype(np.float32)


def mma(c, prods, mode):
    """c (R, D) f32 + prods (R, 8, D) exact f64 products, one mma's sum."""
    c64 = c.astype(np.float64)
    if mode == "rn":
        return (c64 + prods.sum(axis=1)).astype(np.float32)
    if mode == "rz":
        s = c64 + prods.sum(axis=1)
        return np.where(s == 0, 0.0, f32_cut(np.where(s == 0, 1.0, s))).astype(np.float32)
    floor = mode == "floor"
    terms = np.concatenate([c64[:, None, :], prods], axis=1)
    _, e = np.frexp(terms)
    e = np.where(terms == 0, -10 ** 4, e)
    emax = np.maximum(e.max(axis=1, keepdims=True), -900)
    s = trunc_to(terms, emax - 24, floor).sum(axis=1)
    return np.where(s == 0, 0.0, f32_cut(np.where(s == 0, 1.0, s), floor)).astype(np.float32)


def mma_3x(c, ph, pl, vh, vl, mode):
    """c += p v over 8 keys as mma1688_3x: lo hi, hi lo, hi hi."""
    def prods(a, b):
        return a.astype(np.float64)[:, :, None] * b.astype(np.float64)[None, :, :]

    c = mma(c, prods(pl, vh), mode)
    c = mma(c, prods(ph, vl), mode)
    return mma(c, prods(ph, vh), mode)


def forward(q, k, v, b, mode):
    """The kernel's forward for q's rows (R, D) over all keys; f32 out."""
    R, L = q.shape[0], k.shape[0]
    sl2 = np.float32(SCALE * LOG2E)
    o = np.zeros((R, D), np.float32)
    m = np.full((R, 1), -np.inf, np.float32)
    lane_l = np.zeros((R, 4), np.float32)  # the four lanes t of a row's quad
    tile, kstep = mode.startswith("tile-"), mode.startswith("kstep-")
    acc_mode = mode.split("-", 1)[1] if tile or kstep else mode
    cols = np.arange(BK)
    for j0 in range(0, L, BK):
        j1 = min(L, j0 + BK)
        s = np.full((R, BK), -np.inf, np.float32)
        s64 = q.astype(np.float64) @ k[j0:j1].astype(np.float64).T + b[:, j0:j1]
        s[:, :j1 - j0] = (s64.astype(np.float32) * sl2).astype(np.float32)
        mn = np.maximum(m, s.max(axis=1, keepdims=True))
        corr = np.exp2(m - mn).astype(np.float32)
        m = mn
        p = np.exp2(s - m).astype(np.float32)
        # lane t sums columns 8n + 2t, 8n + 2t + 1, n = 0..7, in that order
        tsum = np.zeros((R, 4), np.float32)
        for n in range(8):
            for e in range(2):
                tsum += p[:, 8 * n + 2 * np.arange(4) + e]
        lane_l = (lane_l * corr + tsum).astype(np.float32)
        o = (o * corr).astype(np.float32)
        vt = np.zeros((BK, D), np.float32)
        vt[:j1 - j0] = v[j0:j1]
        part = np.zeros_like(o) if tile else o
        for kc in range(BK // 8):
            keys = cols[8 * kc:8 * kc + 8]
            ph, pl = split(p[:, keys])
            vh, vl = split(vt[keys])
            if kstep:
                o = (o + mma_3x(np.zeros_like(o), ph, pl, vh, vl, acc_mode)).astype(np.float32)
            else:
                part = mma_3x(part, ph, pl, vh, vl, acc_mode)
        if not kstep:
            o = (o + part).astype(np.float32) if tile else part
    l01 = lane_l[:, 0] + lane_l[:, 1]
    l23 = lane_l[:, 2] + lane_l[:, 3]
    l = (l01 + l23).astype(np.float32)[:, None]
    return (o * (np.float32(1) / l)).astype(np.float32)


def reference(q, k, v, b):
    s = (q.astype(np.float64) @ k.astype(np.float64).T + b) * SCALE
    s -= s.max(axis=1, keepdims=True)
    p = np.exp(s)
    return (p / p.sum(axis=1, keepdims=True)) @ v.astype(np.float64)


def run(L, rows, peak_rows, rng, modes):
    qu, k, v = (rng.standard_normal((L, D)).astype(np.float32) for _ in range(3))
    peak, refs, bs = 0.0, [], []
    for r0 in range(0, peak_rows, 256):
        r1 = min(peak_rows, r0 + 256)
        b = rng.standard_normal((r1 - r0, L)).astype(np.float32)
        ref = reference(qu[r0:r1], k, v, b.astype(np.float64))
        peak = max(peak, float(np.abs(ref).max()))
        if r0 < rows:
            refs.append(ref[:rows - r0])
            bs.append(b[:rows - r0])
    ref_rows, b_rows = np.concatenate(refs), np.concatenate(bs)
    res = {"L": L, "rows": rows, "peak_rows": peak_rows, "peak": peak}
    for mode in modes:
        out = forward(qu[:rows], k, v, b_rows, mode)
        res[mode] = float(np.abs(out.astype(np.float64) - ref_rows).max()) / peak
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", type=int, nargs="+", default=[4096, 16384, 65600])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--peak-rows", type=int, default=2048)
    ap.add_argument("--modes", nargs="+",
                    default=["rn", "trunc", "rz", "floor", "tile-rz", "kstep-rz"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rng = np.random.default_rng(a.seed)
    lines = []
    for L in a.lengths:
        res = run(L, a.rows, a.peak_rows, rng, a.modes)
        line = json.dumps(res)
        print(line, flush=True)
        lines.append(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
