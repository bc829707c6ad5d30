"""Certain-room data generation for downstream tasks (port of
``sarssl_tpu/cli/gen_simu_certain_room.py``: the same flags, seeds and tree).

Equivalent of the reference's ``data_generation/gen_simu_certain_room.py``:
two-level sampling — ``room_num`` random rooms, ``rir_num_each_room`` RIRs
(array/source placements) per room, ``sig_num_each_rir`` signals per RIR —
written under ``R{room_idx}/`` subdirectories so downstream trials can select
``nsimroom`` rooms (reference run_downstream.py:123, opt.py:205-206).

Usage:
  python -m sarssl_torch.cli.gen_simu_certain_room --stage train \
      --room-num 8 --rir-per-room 50 --sig-per-rir 2 --save-dir data/ds_train
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing as mp
import os
import sys

import numpy as np

from .gen_simu import STAGE_SEEDS


def build_parser():
    p = argparse.ArgumentParser("sarssl_torch gen_simu_certain_room")
    p.add_argument("--stage", type=str, default="train",
                   choices=list(STAGE_SEEDS))
    p.add_argument("--room-num", type=int, required=True)
    p.add_argument("--rir-per-room", type=int, default=50)
    p.add_argument("--sig-per-rir", type=int, default=2)
    p.add_argument("--save-dir", type=str, required=True)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    p.add_argument("--T", type=float, default=4.112)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--save-dp", action="store_true")
    p.add_argument("--noise", type=str, default="diffuse_white",
                   choices=["diffuse_white", "spatial_white", ""])
    return p


def _gen_item(job, *, seed, save_dir, T, fs, save_dp, noise):
    room_idx, rir_idx, sig_idx = job
    from ..data.rooms import AcousticSamplerConfig, sample_room
    from ..data.scene import SceneSynthesizer
    from ..data.wavio import write_wav

    cfg = AcousticSamplerConfig(fs=fs)
    # room geometry/absorption fixed per room index
    room_rng = np.random.default_rng(seed + 977 * room_idx)
    room = sample_room(room_rng, cfg)
    synth = SceneSynthesizer(cfg=cfg, T=T, noise_type=noise)
    item_seed = seed + 1_000_003 * room_idx + 101 * rir_idx + sig_idx
    # array/source placement varies per RIR; source signal per sig
    from ..data.rooms import sample_array, sample_trajectory
    rng = np.random.default_rng(item_seed)
    array = sample_array(rng, cfg, room["room_sz"])
    traj = sample_trajectory(rng, cfg, room["room_sz"], array)
    scene_cfg = {**room, **array, "src_traj_pts": traj}
    sig, info = synth.generate(seed=item_seed, scene_cfg=dict(scene_cfg))

    room_dir = os.path.join(save_dir, f"R{room_idx}")
    os.makedirs(room_dir, exist_ok=True)
    name = f"{rir_idx}_{sig_idx}"
    write_wav(os.path.join(room_dir, name + ".wav"), sig, fs)
    if save_dp:
        write_wav(os.path.join(room_dir, name + "_dp.wav"),
                  info.pop("mic_sig_dp"), fs)
    else:
        info.pop("mic_sig_dp", None)
    np.savez(os.path.join(room_dir, name + "_info.npz"), **info)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data import native
    native.load()  # build (or raise) once, before any worker starts
    os.makedirs(args.save_dir, exist_ok=True)
    seed = STAGE_SEEDS[args.stage]
    jobs = [(r, i, s) for r in range(args.room_num)
            for i in range(args.rir_per_room)
            for s in range(args.sig_per_rir)]
    work = functools.partial(_gen_item, seed=seed, save_dir=args.save_dir,
                             T=args.T, fs=args.fs, save_dp=args.save_dp,
                             noise=args.noise)
    if args.workers <= 1:
        for j in jobs:
            work(j)
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(args.workers) as pool:
            for n, _ in enumerate(pool.imap_unordered(work, jobs, chunksize=4)):
                if (n + 1) % 200 == 0:
                    print(f"{n + 1}/{len(jobs)}")
    print(f"wrote {len(jobs)} items ({args.room_num} rooms) to {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
