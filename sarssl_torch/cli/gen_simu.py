"""Simulated data-generation CLI (port of ``sarssl_tpu/cli/gen_simu.py``,
with its flags, defaults, seeds and output tree: the same seed writes the
same files).

Equivalent of the reference's ``data_generation/gen_simu.py``: samples
``data_num`` random acoustic scenes (per-stage seeds: pretrain=1, preval=2e6,
pretest=3e6, train=4e6, val=5e6, test=6e6, following gen_simu.py:69-81),
synthesizes RIRs + mic signals + annotations, and writes the same tree the
reference datasets read: ``{idx}.wav``, ``{idx}_dp.wav`` (optional),
``{idx}_info.npz``.

The reference pins one gpuRIR process per GPU (gen_simu.py:137-163); here the
ISM engine is a host C++/OpenMP kernel (``data/csrc/ism.cpp``, built before
the workers start; a failed build raises), so a plain process pool of spawned
workers runs the items. The workers run host numpy only and touch no CUDA.

Usage:
  python -m sarssl_torch.cli.gen_simu --mode sig --stage pretrain \
      --data-num 512000 --save-dir data/simu --workers 16
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing as mp
import os
import sys

import numpy as np

STAGE_SEEDS = {"pretrain": 1, "preval": 2_000_000, "pretest": 3_000_000,
               "train": 4_000_000, "val": 5_000_000, "test": 6_000_000}


def build_parser():
    p = argparse.ArgumentParser("sarssl_torch gen_simu")
    p.add_argument("--mode", type=str, default="sig", choices=["sig", "rir"])
    p.add_argument("--stage", type=str, default="pretrain",
                   choices=list(STAGE_SEEDS))
    p.add_argument("--data-num", type=int, required=True)
    p.add_argument("--idx0", type=int, default=0,
                   help="first item index: generate items [idx0, "
                        "idx0+data_num) so a later run can extend an "
                        "existing tree with disjoint per-item seeds")
    p.add_argument("--save-dir", type=str, required=True)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    p.add_argument("--T", type=float, default=4.112)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--save-dp", action="store_true")
    p.add_argument("--noise", type=str, default="diffuse_white",
                   choices=["diffuse_white", "spatial_white", "diffuse_babble",
                            "diffuse_xsrc", "real_world", ""])
    p.add_argument("--noise-dir", type=str, default=None,
                   help="wav tree for diffuse_xsrc / real_world noise")
    p.add_argument("--mic-vad", type=str, default=None,
                   choices=["dp_ratio", "src_energy"],
                   help="save a frame-level VAD annotation "
                        "(utils_simu_rir_sig.py:1026-1041)")
    p.add_argument("--t60-range", type=float, nargs=2, default=[0.2, 1.3])
    p.add_argument("--room-x", type=float, nargs=2, default=[3.0, 15.0])
    p.add_argument("--room-y", type=float, nargs=2, default=[3.0, 10.0])
    p.add_argument("--room-z", type=float, nargs=2, default=[2.5, 6.0])
    return p


def _gen_one(idx: int, *, seed: int, save_dir: str, T: float, fs: int,
             save_dp: bool, noise: str, t60_range, room_ranges,
             noise_paths=(), mic_vad=None, mode: str = "sig"):
    from ..data.rooms import AcousticSamplerConfig
    from ..data.scene import SceneSynthesizer
    from ..data.wavio import write_wav

    cfg = AcousticSamplerConfig(room_sz_range=room_ranges,
                                T60_range=tuple(t60_range), fs=fs)
    synth = SceneSynthesizer(cfg=cfg, T=T, noise_type=noise,
                             noise_paths=tuple(noise_paths), mic_vad=mic_vad)
    if mode == "rir":
        # RIR-only tree (reference gen_simu 'rir' mode, gen_simu.py:137-163):
        # {idx}_rir.npy (npt, nmic, nsamp, nsrc) + {idx}_rir_info.npz with
        # the dp RIR, geometry and source-independent annotations — consumed
        # by data.real_rir.SimRIRDataset for on-the-fly micsig synthesis
        rir, info = synth.generate_rir(seed=seed + idx)
        np.save(os.path.join(save_dir, f"{idx}_rir.npy"), rir)
        np.savez(os.path.join(save_dir, f"{idx}_rir_info.npz"), **info)
        return idx
    sig, info = synth.generate(seed=seed + idx)
    write_wav(os.path.join(save_dir, f"{idx}.wav"), sig, fs)
    if save_dp:
        write_wav(os.path.join(save_dir, f"{idx}_dp.wav"),
                  info.pop("mic_sig_dp"), fs)
    else:
        info.pop("mic_sig_dp", None)
    np.savez(os.path.join(save_dir, f"{idx}_info.npz"), **info)
    return idx


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data import native
    native.load()  # build (or raise) once, before any worker starts
    os.makedirs(args.save_dir, exist_ok=True)
    seed = STAGE_SEEDS[args.stage]
    room_ranges = (tuple(args.room_x), tuple(args.room_y), tuple(args.room_z))
    noise_paths = ()
    if args.noise_dir:
        from pathlib import Path
        noise_paths = tuple(str(p) for p in
                            sorted(Path(args.noise_dir).rglob("*.wav")))
    work = functools.partial(
        _gen_one, seed=seed, save_dir=args.save_dir, T=args.T, fs=args.fs,
        save_dp=args.save_dp, noise=args.noise, t60_range=args.t60_range,
        room_ranges=room_ranges, noise_paths=noise_paths,
        mic_vad=args.mic_vad, mode=args.mode)

    if args.workers <= 1:
        for i in range(args.idx0, args.idx0 + args.data_num):
            work(i)
            if (i + 1 - args.idx0) % 100 == 0:
                print(f"{i + 1 - args.idx0}/{args.data_num}")
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(args.workers) as pool:
            done = 0
            for _ in pool.imap_unordered(work,
                                         range(args.idx0,
                                               args.idx0 + args.data_num),
                                         chunksize=8):
                done += 1
                if done % 1000 == 0:
                    print(f"{done}/{args.data_num}")
    print(f"wrote {args.data_num} items to {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
