"""Downstream fine-tuning / linear-eval CLI (port of
``sarssl_tpu/cli/run_downstream.py``).

Per-task regression over an lr x bs x trial grid, one cell after another:
each cell starts from the same initial weights with the pretrained encoders
loaded (finetune / lineareval, the encoders frozen in lineareval) or from
them alone (scratchlow), trains with smoothed-val early stopping and the
two-stage lr/10 drop, ensembles the last best epochs and reports its test
and val MAE; the grid's summary goes to ``results.json`` and ``results.mat``.
``--nmic > 2`` trains the multi-pair model (``SARSSLMultiCH``) on per-pair
TDOA targets. ``--ds-test`` evaluates a trained cell's checkpoint, or the
predict-the-train-mean baseline, or plots a t-SNE of its test embeddings.

Data: annotated wav trees or packed directories (``--data-dir``,
``--val-data-dir``, ``--test-data-dir``; ``cli/gen_simu.py``,
``cli/gen_simu_certain_room.py``, ``cli/pack_data.py``) carry every task's
label; ``--room-trials`` trains trial t on the t-th block of rooms of a
certain-room tree, ``--fixed-train-subset`` on a fixed per-trial draw of a
packed split. ``--synthetic`` carries TDOA labels only. Real data: speech of
a speaker tree (``--src-dir``) convolved on the fly with extracted real RIRs
(``--rir-dir``, ``cli/gen_real_rir.py``) and / or simulated ones
(``--sim-rir-dir``, ``gen_simu --mode rir``), mixed by ``--real-sim-ratio``,
with ``--rir-cv`` for leave-one-room-out trials and ``--mp-loader`` for a
process pool; or a presaved real tree with ``train`` / ``val`` / ``test``
subdirs (``--real-sig-dir``, ``cli/gen_locata.py``) mixed with a simulated
one (``--sim-sig-dir``).

Usage:
  python -m sarssl_torch.cli.run_downstream --ds-train --ds-task T60 --data-dir DATA \
      --pretrain-ckpt DIR
  python -m sarssl_torch.cli.run_downstream --ds-train --synthetic --pretrain-ckpt DIR
  python -m sarssl_torch.cli.run_downstream --ds-test --synthetic --ckpt CELL/ckpt
  python -m sarssl_torch.cli.run_downstream --smoke            # tiny run on the card
  python -m sarssl_torch.cli.run_downstream --smoke --cpu      # tiny run on the CPU
  python -m sarssl_torch.cli.run_downstream --smoke --cpu --grid-vmap --ntrial 2 \
      --lr-set 1e-3 1e-4                                         # a vmapped tiny grid

``--grid-vmap`` runs every (trial, lr) cell as one lane of one vmapped
program (``train/grid.py``), ``--grid-chunk`` lanes at a time, each step of a
lane equal to that cell's sequential step; ``--scan-block`` steps go to the
card in one block, ``--time-budget`` ends each chunk's epochs at its prorated
share of the seconds (its cells marked ``truncated``), ``--trial-set`` runs
only the trials named. A packed ``--data-dir`` (no RIR, real-signal or
synthetic source) is staged whole on the card once for all chunks, within
``SARSSL_RESIDENT_BUDGET_GB`` (default 6; over it the split streams). Each
cell writes only its ``ensemble_model``. It refuses (``ValueError``) more than
one ``--bs-set`` value, ``--nmic`` > 2, ``--rir-cv`` and ``--mesh``. The
sequential grid ignores ``--grid-chunk``, ``--scan-block``, ``--time-budget``
and ``--trial-set``, as the JAX CLI's does.

``--mesh DxM`` trains each cell over D data x M model ranks (``parallel/``),
one process a card, launched by ``torchrun`` (``torchrun --nproc-per-node 8 -m
sarssl_torch.cli.run_downstream --mesh 8x1 ...``; ``--cpu``: gloo ranks); a
``--mesh 1x1`` run without ``torchrun`` joins a group of one rank in process.
A data rank reads ``bs / D`` rows of each batch: its block of a packed batch
(the unmeshed run's rows), its strided share of a wav tree, or the random
sources (synthetic, RIR, real-signal) with its own seed and ``num / D``
items, as the JAX CLI's hosts do; rank 0 writes the logs, checkpoints and
results. ``--ds-test`` and ``--grid-vmap`` refuse it.

It runs on the card unless ``--cpu`` is given (``--smoke`` included). The
parser holds every flag of the JAX CLI, with its default and ``dest``, so
``config.json`` has the same keys. ``--smoke`` keeps
an ``--lr-set``, ``--bs-set`` or ``--ntrial`` given with it (the JAX CLI
overrides them), so a smoke grid can hold several cells. ``--workers`` sets
the loader's threads (its processes under ``--mp-loader``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import sys
import time

import numpy as np
import torch

_RESIDENT_BUDGET_GB = "6"  # SARSSL_RESIDENT_BUDGET_GB's default


def fixed_train_subset(args, n, num, trial):
    """Per-trial fixed training rows for --fixed-train-subset: a
    deterministic, epoch-independent draw of num rows of the packed split,
    seeded per trial (trials differ by their data subset). None = the whole
    split."""
    if not getattr(args, "fixed_train_subset", False) or num >= n:
        return None
    rng = np.random.default_rng(args.seed + 555_000 + trial)
    return np.sort(rng.permutation(n)[:num])


def room_block_rows(rooms_col, nsimroom, trial):
    """Row indices of trial's room block for --room-trials: the trial-th
    consecutive block of nsimroom rooms in sorted room-id order, so the
    trials' room sets are disjoint (the reference's per-trial data dirs,
    ``opt.py:283-290``, blocked by the ids present)."""
    rooms_col = np.asarray(rooms_col, np.int64)
    ids = np.unique(rooms_col)
    blk = ids[trial * nsimroom:(trial + 1) * nsimroom]
    if len(blk) != nsimroom:
        raise ValueError(
            f"trial {trial} needs rooms [{trial * nsimroom}:{(trial + 1) * nsimroom}) of "
            f"{len(ids)} present: generate more rooms (gen_simu_certain_room --room-num >= "
            "ntrial*nsimroom) or lower --ntrial/--ds-nsimroom")
    return np.flatnonzero(np.isin(rooms_col, blk))


def trial_subset_draw(rows, num, seed, trial):
    """A fixed, epoch-independent draw of num of the given rows (sorted),
    seeded per trial; all of them when num covers them."""
    rows = np.asarray(rows)
    if num >= len(rows):
        return rows
    rng = np.random.default_rng(seed + 555_000 + trial)
    return np.sort(rows[rng.permutation(len(rows))[:num]])


def packed_train_subset(args, pds, num, trial):
    """The train-row universe of one trial of a packed split: the room
    block's rows under --room-trials (--train-num is then a label budget: a
    fixed per-trial draw from the block), the fixed draw under
    --fixed-train-subset, else None (the whole split)."""
    if getattr(args, "room_trials", False):
        rc = pds.annos().get("room")
        if rc is None:
            raise ValueError(f"--room-trials: packed dir {pds.dir} has no 'room' column: "
                             "re-pack the R{idx}/ tree with cli.pack_data")
        rows = room_block_rows(rc, args.ds_nsimroom, trial)
        return trial_subset_draw(rows, num, args.seed, trial)
    return fixed_train_subset(args, pds.n, num, trial)


def build_parser():
    p = argparse.ArgumentParser("sarssl_torch downstream")
    p.add_argument("--ds-train", action="store_true")
    p.add_argument("--ds-test", action="store_true")
    p.add_argument("--ds-test-mode", type=str, default="cal_metric",
                   choices=["cal_metric", "cal_metric_wo_info", "vis_embed"])
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir for --ds-test (ensemble/best model)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny synthetic end-to-end run (CI)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the file-free synthetic pair generator (host)")
    p.add_argument("--ds-task", type=str, default="TDOA",
                   choices=["TDOA", "DRR", "T60", "C50", "C80", "ABS", "SNR",
                            "DOA", "SUR", "VOL"])
    p.add_argument("--ds-trainmode", type=str, default="finetune",
                   choices=["finetune", "lineareval", "scratchlow"])
    p.add_argument("--ds-embed", type=str, default="spec_spat",
                   choices=["spec_spat", "spec", "spat", "noinfo"])
    p.add_argument("--pretrain-ckpt", type=str, default=None,
                   help="pretrain checkpoint dir (best_model used)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="annotated wav tree (gen_simu) or packed directory (pack_data)")
    p.add_argument("--val-data-dir", type=str, default=None,
                   help="validation data (default: --data-dir)")
    p.add_argument("--test-data-dir", type=str, default=None,
                   help="test data (default: --data-dir)")
    p.add_argument("--rir-dir", type=str, default=None,
                   help="extracted real-RIR tree (gen_real_rir): train on speech x RIR "
                        "convolved on the fly")
    p.add_argument("--sim-rir-dir", type=str, default=None,
                   help="simulated-RIR tree (gen_simu --mode rir): the sim arm of the "
                        "on-the-fly real / sim mixture")
    p.add_argument("--src-dir", type=str, default=None,
                   help="speaker-tree source corpus for --rir-dir / --sim-rir-dir")
    p.add_argument("--rir-cv", action="store_true",
                   help="leave-one-room-out cross-validation over the immediate "
                        "subdirectories of --rir-dir: ntrial becomes the room count and "
                        "each trial holds out one room for test and one for val")
    p.add_argument("--real-sig-dir", type=str, default=None,
                   help="presaved real wav tree with train/val/test subdirs (gen_locata); "
                        "mixes with --sim-sig-dir per --real-sim-ratio")
    p.add_argument("--sim-sig-dir", type=str, default=None,
                   help="presaved simulated wav tree, the sim arm for --real-sig-dir")
    p.add_argument("--real-sim-ratio", type=int, nargs=2, default=(1, 1),
                   metavar=("REAL", "SIM"),
                   help="training-arm mix: 1 0 real only, 0 1 sim only, 1 1 50/50; val/test "
                        "always use the real arm when one exists")
    p.add_argument("--real-exp", action="store_true",
                   help="use the reference real-world grids: bs 16, "
                        "lr {1e-3,1e-4}, per-task training counts")
    p.add_argument("--exp-dir", type=str, default="exp/downstream")
    p.add_argument("--ds-nsimroom", type=int, default=8)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr-set", type=float, nargs="+", default=None)
    p.add_argument("--bs-set", type=int, nargs="+", default=None)
    p.add_argument("--ntrial", type=int, default=None)
    p.add_argument("--train-num", type=int, default=None)
    p.add_argument("--T", type=float, default=None,
                   help="clip seconds (default: task standard — 1.04 for "
                        "TDOA, 4.112 otherwise)")
    p.add_argument("--val-num", type=int, default=1000)
    p.add_argument("--test-num", type=int, default=4000)
    p.add_argument("--room-trials", action="store_true",
                   help="the train data is a certain-room corpus (gen_simu_certain_room "
                        "R{idx}/ tree, raw or packed): trial t trains on the t-th disjoint "
                        "block of ds-nsimroom rooms; --train-num below the block size is a "
                        "fixed per-trial draw from it")
    p.add_argument("--fixed-train-subset", action="store_true",
                   help="packed dirs: train each trial on a fixed train-num-row subset of "
                        "the split instead of resampling the whole split every epoch")
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads, processes under --mp-loader (the synthetic generator "
                        "takes none)")
    p.add_argument("--grid-vmap", action="store_true",
                   help="run every (trial, lr) cell as one lane of a vmapped program "
                        "(train/grid.py) instead of one after another: the same per-cell "
                        "life cycle, N lanes a dispatch (one --bs-set value, 2 mics)")
    p.add_argument("--grid-chunk", type=int, default=8,
                   help="lanes a vmapped program: the stacked states and the ensemble ring "
                        "of a chunk must fit the card")
    p.add_argument("--trial-set", type=int, nargs="+", default=None,
                   help="run only these trials of a --grid-vmap grid (data streams and "
                        "generators stay keyed by the trial, so the cells equal a full grid's)")
    p.add_argument("--scan-block", type=int, default=25,
                   help="steps a --grid-vmap block: the block's waves reach the card in one "
                        "copy and its loss sums stay there")
    p.add_argument("--time-budget", type=float, default=0,
                   help="--grid-vmap wall-clock budget in seconds (0: off): a chunk's epochs "
                        "end at its prorated share, its cells marked truncated; ensembles, "
                        "the test and results.json still come")
    p.add_argument("--mp-loader", action="store_true",
                   help="process-pool loader (--workers processes) for the on-the-fly RIR "
                        "paths: the convolutions scale past the GIL")
    p.add_argument("--nmic", type=int, default=2,
                   help="microphone count; > 2 builds the multi-pair "
                        "SARSSLMultiCH head")
    p.add_argument("--ch-mode", type=str, default="M", choices=["M", "MM"],
                   help="mic pairing: ref-mic pairs or all pairs")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--mesh", type=str, default=None,
                   help="'DxM' data x model mesh, e.g. 8x1 (under torchrun, one process a card)")
    return p


def _check_grid_vmap(args) -> None:
    """The grids --grid-vmap refuses, as the JAX CLI does."""
    if args.bs_set is not None and len(args.bs_set) > 1:
        raise ValueError("--grid-vmap runs one batch size: pass one --bs-set value")
    if args.nmic > 2:
        raise ValueError("--grid-vmap runs the 2-mic model: drop --nmic or run the "
                         "sequential grid")
    if args.mesh:
        raise ValueError("--grid-vmap runs on one card: drop --mesh")
    if args.rir_cv:
        raise ValueError("--grid-vmap shares one val / test set across lanes, --rir-cv gives "
                         "each trial its own rooms: run the sequential grid")


def _check_args(args) -> None:
    if args.grid_vmap:
        _check_grid_vmap(args)
    if args.mesh:
        from ..parallel import parse_mesh

        parse_mesh(args.mesh)
        if args.ds_test:
            raise ValueError("--ds-test evaluates in one process: drop --mesh")
    rirs = args.rir_dir or args.sim_rir_dir
    # the JAX CLI's order of sources: a presaved real tree, then the RIR
    # arms, then the synthetic pairs (--smoke runs on them), then --data-dir
    synthetic = (args.synthetic or args.smoke) and not (args.real_sig_dir or rirs)
    if not (synthetic or args.data_dir or args.real_sig_dir or rirs):
        raise ValueError("no data source: pass --data-dir, --real-sig-dir, --rir-dir / "
                         "--sim-rir-dir with --src-dir, or --synthetic")
    if synthetic and args.ds_task != "TDOA":
        raise ValueError(f"--ds-task {args.ds_task}: the synthetic data carries TDOA labels only")
    ratio = tuple(int(r) for r in args.real_sim_ratio)
    if args.real_sig_dir:
        if ratio[1] and not args.sim_sig_dir:
            raise ValueError("--real-sim-ratio includes a sim arm: pass --sim-sig-dir")
        if not any(ratio):
            raise ValueError("--real-sim-ratio 0 0 selects no training arm")
    elif rirs:
        if not args.src_dir:
            raise ValueError("--rir-dir / --sim-rir-dir convolve the speech of --src-dir: "
                             "pass it")
        if not ((ratio[0] and args.rir_dir) or (ratio[1] and args.sim_rir_dir)):
            raise ValueError(f"--real-sim-ratio excludes every provided RIR arm (ratio {ratio}, "
                             f"rir_dir={bool(args.rir_dir)}, "
                             f"sim_rir_dir={bool(args.sim_rir_dir)})")
    if args.rir_cv and not args.rir_dir:
        raise ValueError("--rir-cv needs --rir-dir")
    if args.room_trials:
        if (synthetic or not args.data_dir or rirs or args.real_sig_dir
                or args.rir_cv):
            raise ValueError("--room-trials reads a certain-room corpus from --data-dir and "
                             "composes with no other data source")
        if not (args.val_data_dir and args.test_data_dir):
            raise ValueError("--room-trials: pass --val-data-dir and --test-data-dir (held-out "
                             "corpora): evaluating on the training rooms would leak")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_args(args)
    from ..utils import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if not args.mesh:
        with _loader_pool(args) as pool:
            return _main(args, pool, dev, None)
    import torch.distributed as dist

    from ..parallel import init_distributed, make_mesh, parse_mesh

    own_group = init_distributed(dev.type)
    try:
        mesh = make_mesh(*parse_mesh(args.mesh), device_type=dev.type)
        with _loader_pool(args) as pool:
            return _main(args, pool, mesh.device, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _loader_pool(args):
    """--mp-loader on the on-the-fly RIR paths: one pool of --workers spawned
    processes for the whole run (every cell, epoch and split), terminated
    when the run ends."""
    import contextlib
    import multiprocessing as mp

    if args.mp_loader and args.workers > 0 and (args.rir_dir or args.sim_rir_dir):
        return mp.get_context("spawn").Pool(args.workers)
    return contextlib.nullcontext()


def _main(args, pool, dev, mesh):

    from ..config import DownstreamConfig, real_ds_setting
    from ..data import (FixMicSigDataset, PackedDataset, SyntheticPairs, device_prefetch,
                        is_packed, synthetic)
    from ..models import SARSSL, SARSSLConfig, SARSSLMultiCH
    from ..ops import FeatureConfig, num_pairs, pairwise_tdoa
    from ..train import (DownstreamLearner, create_train_state, make_downstream_eval_step,
                         make_downstream_step, partial_load, trainable_mask_from_loaded)
    from ..train import checkpoint as ckpt
    from ..utils import MetricLogger, epoch_generator, save_config, set_seed

    # every matmul and convolution in full f32 where the model computes in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {dev}; TF32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    if args.smoke:
        args.ds_train = True
        args.synthetic = True
        args.epochs = 3
        args.lr_set = args.lr_set or [1e-3]
        args.bs_set = args.bs_set or [4]
        args.ntrial = args.ntrial or 1
        args.train_num = 16
        args.val_num = 8
        args.test_num = 8

    cfg = DownstreamConfig(task=args.ds_task, train_mode=args.ds_trainmode,
                           nsimroom=args.ds_nsimroom)
    if args.real_exp:
        rs = real_ds_setting(args.ds_task, args.ds_trainmode, args.real_sim_ratio)
        lr_set = args.lr_set or rs["lr_set"]
        bs_set = args.bs_set or rs["bs_set"]
        ntrial = args.ntrial or rs["ntrial"]
        train_num = args.train_num or rs["num"]
    else:
        lr_set = args.lr_set or list(cfg.lr_set)
        bs_set = args.bs_set or list(cfg.bs_set)
        ntrial = args.ntrial or cfg.ntrial
        train_num = args.train_num or cfg.train_num
    if args.room_trials:
        ntrial = _room_trials(args, ntrial)
    cv_splits = None
    if args.rir_cv:
        cv_splits = _rir_cv_splits(args)
        ntrial = len(cv_splits)

    fs = 16000
    T = args.T or cfg.T
    nsample = round(T * fs) if not args.smoke else 2304
    feat_cfg = FeatureConfig()
    nt = feat_cfg.num_frames(nsample)
    if args.data_dir and not args.smoke:
        probe = (PackedDataset(args.data_dir, load_anno=False)[0] if is_packed(args.data_dir)
                 else FixMicSigDataset(args.data_dir, data_num=1)[0])
        if probe.shape[0] < nsample:
            raise ValueError(
                f"data under {args.data_dir} has {probe.shape[0]} samples but task "
                f"'{args.ds_task}' expects >= {nsample} ({T} s @ {fs} Hz); pass --T to "
                "match the data")

    if args.smoke:
        mcfg = SARSSLConfig(dtype="float32", pretrain=False,
                            downstream_embed=args.ds_embed).tiny(
            sig_shape=(256, nt, 2, 2), patch_shape=(256, 1),
            spec_dembed=32, spat_dembed=16, pretrain=False)
    else:
        mcfg = SARSSLConfig(sig_shape=(256, nt, 2, 2), dtype=args.dtype,
                            pretrain=False, downstream_embed=args.ds_embed)
    npair = num_pairs(args.nmic, args.ch_mode)
    multipair = args.nmic > 2
    dlabel = npair if (multipair and args.ds_task == "TDOA") else 1
    if multipair:
        feat_cfg = FeatureConfig(ch_mode=args.ch_mode)
        model = SARSSLMultiCH(mcfg, nmic_pair=npair, task=args.ds_task, device=dev,
                              seed=args.seed)
    else:
        model = SARSSL(mcfg, device=dev, seed=args.seed)
    set_seed(args.seed)
    # the initial weights, built once from --seed; every cell starts from them
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    # a data rank's share of each batch (the JAX CLI's host share)
    pc, pi = (mesh.data_size, mesh.data_index) if mesh else (1, 0)
    writer = mesh is None or mesh.is_writer

    # pretrained encoder weights (finetune / lineareval)
    pre_sd = None
    if args.ds_trainmode in ("finetune", "lineareval"):
        # these modes are defined by transferring a pretrained encoder; a
        # missing checkpoint must not label scratch results as transfer ones
        if not args.pretrain_ckpt and args.ds_trainmode == "lineareval":
            raise ValueError("--ds-trainmode lineareval requires --pretrain-ckpt (without "
                             "one there is nothing to freeze and every param would train)")
        if not args.pretrain_ckpt:
            print("WARNING: --ds-trainmode finetune without --pretrain-ckpt "
                  "trains from random init (scratch)")
        else:
            pre_sd = pretrained_params(ckpt.best_path(args.pretrain_ckpt), multipair)

    def fresh_state():
        """The initial weights with the pretrained ones loaded, and a fresh
        optimizer; returns the state and the names loaded."""
        ckpt.load_full_state_dict(model, init_sd)
        keys = []
        if pre_sd is not None:
            keys = partial_load(model, pre_sd)
            if not keys:
                raise ValueError("--pretrain-ckpt matched zero parameter keys: wrong "
                                 "checkpoint for this model config")
        return create_train_state(model), keys

    def make_batches(split, bs, seed, trial=0, host=False):
        """The split's batches as device tensors (``host``: numpy arrays):
        waves, and the task's targets (per pair for the multi-pair model)."""
        num = {"train": train_num, "val": args.val_num, "test": args.test_num}[split]
        if bs % pc:
            raise ValueError(f"batch size {bs} does not split over {pc} data ranks")
        # a data rank draws its own rows of the random sources
        lbs, lnum, lseed = bs // pc, num // pc, seed + pi * 7919
        nbatch = max(1, lnum // lbs)
        if args.real_sig_dir:
            it = _real_sig_batches(args, split, lbs, lseed, lnum, nsample)
        elif args.rir_dir or args.sim_rir_dir:
            it = _rir_batches(args, split, lbs, lseed, lnum, T, fs,
                              cv_splits[trial][split] if cv_splits is not None else None, pool)
        elif not args.synthetic:
            data_dir = {"train": args.data_dir, "val": args.val_data_dir or args.data_dir,
                        "test": args.test_data_dir or args.data_dir}[split]
            it = _file_batches(args, data_dir, split, bs, seed, trial, num, nsample, pi, pc)
        elif multipair:
            def gen():
                rng = np.random.default_rng(lseed)
                for _ in range(nbatch):
                    wave, tdoa = synthetic.synth_batch_multich(rng, lbs, nsample, nch=args.nmic)
                    yield wave, {"TDOA": tdoa / fs}
            it = gen()
        else:
            it = SyntheticPairs(nsample=nsample, seed=lseed).batches(lbs, nbatch,
                                                                     with_labels=True)

        def adapt():
            for wave, gt in it:
                g = np.asarray(gt[args.ds_task], np.float32)
                if multipair and args.ds_task == "TDOA":
                    # per-mic (against mic 0) annotations -> per-pair targets
                    g = pairwise_tdoa(torch.from_numpy(g.reshape(g.shape[0], -1)), args.nmic,
                                      args.ch_mode).numpy()
                yield wave, g
        if host:
            return ((np.asarray(w, np.float32), g) for w, g in adapt())
        return device_prefetch(adapt(), size=2, device=dev)

    os.makedirs(args.exp_dir, exist_ok=True)
    if writer:
        save_config(vars(args), os.path.join(args.exp_dir, "config.json"))

    if args.ds_test:
        return _ds_test(args, model, feat_cfg, make_batches, bs_set[0], dlabel, dev)

    results = {}
    if args.grid_vmap:
        results = _grid_vmapped(args, model, feat_cfg, fresh_state, make_batches, lr_set,
                                bs_set[0], ntrial, dlabel, dev, nsample, train_num)
    for trial, bs, lr in (() if args.grid_vmap else
                          itertools.product(range(ntrial), bs_set, lr_set)):
        cell = f"trial{trial}_bs{bs}_lr{lr:g}"
        cell_dir = os.path.join(args.exp_dir, cell)
        state, keys = fresh_state()
        if pre_sd is not None:
            print(f"{cell}: partial_load: {len(keys)}/{len(state.optimizer.names)} "
                  f"parameters loaded")
        tmask = None
        if args.ds_trainmode == "lineareval" and keys:
            tmask = trainable_mask_from_loaded(model, keys)
        if mesh is None:
            train_step = make_downstream_step(model, feat_cfg, task=args.ds_task,
                                              trainable_mask=tmask, dlabel=dlabel, device=dev)
            eval_step = make_downstream_eval_step(model, feat_cfg, task=args.ds_task,
                                                  dlabel=dlabel, device=dev)
        else:
            from ..parallel import make_sharded_downstream_eval_step, make_sharded_downstream_step

            train_step, _, _ = make_sharded_downstream_step(
                model, feat_cfg, mesh, state, task=args.ds_task, trainable_mask=tmask,
                dlabel=dlabel)
            eval_step, _, _ = make_sharded_downstream_eval_step(
                model, feat_cfg, mesh, state, task=args.ds_task, dlabel=dlabel)
        logger = (MetricLogger(os.path.join(cell_dir, "logs"), use_tensorboard=False)
                  if writer else None)
        learner = DownstreamLearner(
            state=state, train_step=train_step, eval_step=eval_step, lr_init=lr,
            ckpt_dir=os.path.join(cell_dir, "ckpt"),
            patience=10 if not args.smoke else 2, logger=logger)
        try:
            for epoch in range(args.epochs):
                # one generator chain per (trial, epoch): the lr cells of a
                # trial share it, as they share the data stream
                gen = epoch_generator(args.seed, "train", 7000 + epoch + trial * 100_000)
                learner.train_epoch(make_batches("train", bs, args.seed + trial * 1000 + epoch,
                                                 trial), gen)
                vm = learner.eval_epoch(make_batches("val", bs, 1, trial), split="val")
                if learner.end_epoch(vm["mae"]):
                    break
            # ensemble the last <= 5 best epochs, then the final test
            learner.ensemble(k=5)
            test_m = learner.eval_epoch(make_batches("test", bs, 2, trial), split="test")
            val_m = learner.eval_epoch(make_batches("val", bs, 1, trial), split="val_final")
        finally:
            if logger is not None:
                logger.close()
        results[cell] = {"val_mae": val_m["mae"], "test_mae": test_m["mae"],
                         "lr": lr, "bs": bs, "trial": trial, "epochs_run": learner.epoch}
        print(f"{cell}: val MAE {val_m['mae']:.5f} test MAE {test_m['mae']:.5f}", flush=True)
        kept = set(learner.best_epochs[-5:])
        if writer:
            ckpt.remove_checkpoint_epochs(os.path.join(cell_dir, "ckpt"),
                                          [e for e in range(learner.epoch) if e not in kept])

    out = grid_summary(args.ds_task, args.ds_trainmode, results)
    if writer:
        with open(os.path.join(args.exp_dir, "results.json"), "w") as f:
            json.dump(out, f, indent=2, default=float)
        from scipy.io import savemat
        savemat(os.path.join(args.exp_dir, "results.mat"),
                {"results": json.loads(json.dumps(out, default=float))})
    print(f"BEST {out['best']}: test MAE {out['best_test_mae']:.5f}")

    if args.smoke:
        ok = np.isfinite(out["best_test_mae"])
        print("SMOKE", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


def _grid_vmapped(args, model, feat_cfg, fresh_state, make_batches, lr_set, bs, ntrial, dlabel,
                  dev, nsample, train_num):
    """Every (trial, lr) cell as a lane of vmapped programs (``train/grid.py``),
    --grid-chunk lanes a program; each lane runs its cell's sequential life
    cycle (the JAX CLI's ``_grid_vmapped``). Returns the cells' results."""
    from ..data import PackedDataset, is_packed
    from ..train import VmappedGridRunner, slice_state, trainable_mask_from_loaded
    from ..train import checkpoint as ckpt
    from ..utils import epoch_generator

    trial_list = list(args.trial_set) if args.trial_set is not None else list(range(ntrial))
    all_cells = [(t, lr) for t in trial_list for lr in lr_set]

    # a packed train split stays on the card for every chunk and epoch, and
    # the epochs send index batches only
    pds_res, waves_dev = None, None
    if (args.data_dir and not (args.real_sig_dir or args.rir_dir or args.sim_rir_dir
                               or args.synthetic) and is_packed(args.data_dir)):
        pds_res = PackedDataset(args.data_dir, load_anno=True)
        nbytes = len(pds_res) * nsample * pds_res.meta["nch"] * 4
        budget_b = float(os.environ.get("SARSSL_RESIDENT_BUDGET_GB", _RESIDENT_BUDGET_GB)) * 1e9
        if nbytes > budget_b:
            # a split that would crowd out the lanes' states and the ensemble
            # ring streams instead
            print(f"train split {nbytes / 1e9:.1f} GB exceeds the resident budget "
                  f"({budget_b / 1e9:.0f} GB, SARSSL_RESIDENT_BUDGET_GB): streaming instead",
                  flush=True)
            pds_res = None
        else:
            waves = torch.from_numpy(pds_res.all_waves(nsample))
            waves_dev = waves.pin_memory().to(dev) if dev.type == "cuda" else waves
            print(f"staged {len(pds_res)} train utts ({nbytes / 1e6:.0f} MB) on {dev}",
                  flush=True)

    results = {}
    nchunk = max(1, args.grid_chunk)
    starts = list(range(0, len(all_cells), nchunk))
    t_start = time.time()
    budget = args.time_budget or 0
    for ci, lo in enumerate(starts):
        cells = all_cells[lo: lo + nchunk]
        if len(all_cells) > nchunk:
            print(f"--- grid chunk {ci + 1}: cells {[f'trial{t}_lr{lr:g}' for t, lr in cells]}",
                  flush=True)
        # one partial_load a chunk, stacked into every lane
        st0, keys = fresh_state()
        tmask = (trainable_mask_from_loaded(model, keys)
                 if args.ds_trainmode == "lineareval" and keys else None)
        # the lr cells of a trial read the same data stream: one data slot a
        # trial, each lane gathering its slot on the card
        trials = sorted({t for t, _ in cells})
        runner = VmappedGridRunner(
            model, feat_cfg, [st0] * len(cells), cells, task=args.ds_task, dlabel=dlabel,
            trainable_mask=tmask, patience=10 if not args.smoke else 2,
            scan_block=max(1, args.scan_block), lane_slots=[trials.index(t) for t, _ in cells],
            device=dev)
        # a prorated deadline: results.json is written even when the grid
        # would outlive an outer time limit
        deadline = t_start + budget * (ci + 1) / len(starts) if budget else None
        staged_val = runner.stage_eval_blocks(make_batches("val", bs, 1, host=True))
        if waves_dev is not None:
            runner.stage_train_waves(waves_dev)
        # per-trial train-row universes; the lanes step in lockstep, so an
        # epoch's batch count is the smallest universe's
        trial_subs = ({t: packed_train_subset(args, pds_res, train_num, t) for t in trials}
                      if waves_dev is not None else {})
        res_num = min([train_num] + [len(v) for v in trial_subs.values() if v is not None])
        budget_hit = False
        for epoch in range(args.epochs):
            gens = [epoch_generator(args.seed, "train", 7000 + epoch + t * 100_000)
                    for t, _ in cells]
            t0 = time.time()
            if waves_dev is not None:
                acol = pds_res.annos()[args.ds_task]
                idx = {t: itertools.islice(pds_res.batch_indices(
                    bs, shuffle=True, seed=args.seed + t * 1000 + epoch, subset=trial_subs[t]),
                    max(1, res_num // bs)) for t in trials}
                tm = runner.train_epoch_resident(
                    ((np.stack(per), np.stack([np.asarray(acol[i], np.float32) for i in per]))
                     for per in zip(*idx.values())), gens)
            else:
                streams = [make_batches("train", bs, args.seed + t * 1000 + epoch, t, host=True)
                           for t in trials]
                tm = runner.train_epoch(
                    ((np.stack([w for w, _ in per]), np.stack([g for _, g in per]))
                     for per in zip(*streams)), gens)
            t1 = time.time()
            vm = runner.eval_epoch_staged(staged_val)
            t2 = time.time()
            ndone = sum(c.done for c in runner.cells)
            print(f"epoch {epoch}: mean train mae {tm['mae'].mean():.5f} mean val mae "
                  f"{vm['mae'].mean():.5f} cells done {ndone}/{len(cells)} [train {t1 - t0:.2f}s "
                  f"val {t2 - t1:.2f}s tot {time.time() - t_start:.1f}s]", flush=True)
            if runner.end_epoch(vm["mae"]):
                break
            if deadline is not None and time.time() > deadline:
                print(f"chunk {ci + 1} hit its prorated time budget at epoch {epoch}; "
                      "finalizing early", flush=True)
                budget_hit = True
                break

        # read before ensembled_states() marks every cell done (the JAX CLI
        # reads it after, so its flag is never set)
        stopped = [c.done for c in runner.cells]
        runner.ensembled_states()
        test_m = runner.eval_epoch(make_batches("test", bs, 2, host=True))
        val_m = runner.eval_epoch_staged(staged_val)
        for i, (t, lr) in enumerate(cells):
            cell = f"trial{t}_bs{bs}_lr{lr:g}"
            c = runner.cells[i]
            ckpt.save_named(os.path.join(args.exp_dir, cell, "ckpt"),
                            slice_state(runner.states, i), "ensemble_model", epoch=-1,
                            max_score=c.stopper.best)
            results[cell] = {"val_mae": float(val_m["mae"][i]),
                             "test_mae": float(test_m["mae"][i]), "lr": lr, "bs": bs,
                             "trial": t, "epochs_run": c.epochs_run,
                             # the deadline came before this cell stopped: its MAE
                             # is an unconverged ensemble's
                             "truncated": bool(budget_hit and not stopped[i])}
            print(f"{cell}: val MAE {results[cell]['val_mae']:.5f} test MAE "
                  f"{results[cell]['test_mae']:.5f}", flush=True)
        # chunks already done survive a run that is killed later
        with open(os.path.join(args.exp_dir, "results.partial.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
        del runner
    return results


def _room_trials(args, ntrial):
    """--room-trials: the number of trials the certain-room tree holds room
    blocks for (a protocol's default ntrial is clamped to it; an explicit
    --ntrial that needs more rooms raises)."""
    from ..data import PackedDataset, is_packed

    if is_packed(args.data_dir):
        rc = PackedDataset(args.data_dir).annos().get("room")
        if rc is None:
            raise ValueError(f"--room-trials: {args.data_dir} was packed without a 'room' "
                             "column: re-pack the R{idx}/ tree with cli.pack_data")
        room_ids = np.unique(np.asarray(rc, np.int64))
    else:
        room_ids = np.array(sorted(
            int(m.group(1)) for d in os.listdir(args.data_dir)
            if (m := re.fullmatch(r"R(\d+)", d)) and os.path.isdir(os.path.join(args.data_dir, d))))
        if not room_ids.size:
            raise ValueError(f"--room-trials: no R{{idx}}/ room subdirs under {args.data_dir} "
                             "(generate with cli.gen_simu_certain_room)")
    max_trials = len(room_ids) // args.ds_nsimroom
    if max_trials < 1:
        raise ValueError(f"{len(room_ids)} rooms < ds-nsimroom={args.ds_nsimroom}")
    if args.ntrial is None and ntrial > max_trials:
        print(f"room-trials: {len(room_ids)} rooms support only {max_trials} disjoint "
              f"{args.ds_nsimroom}-room trials (protocol ntrial {ntrial}); clamping")
        ntrial = max_trials
    if ntrial * args.ds_nsimroom > len(room_ids):
        raise ValueError(f"--ntrial {ntrial} x nsimroom {args.ds_nsimroom} needs "
                         f"{ntrial * args.ds_nsimroom} rooms, found {len(room_ids)}")
    return ntrial


def _rir_cv_splits(args):
    """--rir-cv: leave-one-room-out splits over the room subdirectories of
    --rir-dir, a val room drawn from the rest of each (one trial a room)."""
    from ..utils.metrics import cross_validation_datadirs

    rooms = sorted(d for d in os.listdir(args.rir_dir)
                   if os.path.isdir(os.path.join(args.rir_dir, d)))
    if len(rooms) < 3:
        raise ValueError(f"--rir-cv needs >= 3 room subdirs under {args.rir_dir}, found {rooms}")
    splits = list(cross_validation_datadirs(rooms, with_val=True, seed=args.seed))
    print(f"cross-validation over {len(rooms)} rooms -> {len(splits)} trials")
    return splits


def _real_sig_batches(args, split, bs, seed, num, nsample):
    """Host batches of the presaved real / sim mixture: train draws from the
    arms per --real-sim-ratio; val and test enumerate the real tree's split."""
    from ..data import (FixMicSigDataset, FixMicSigDatasetLOCATA, RandomMixDataset, Selecting,
                        batch_iterator)

    ratio = tuple(int(r) for r in args.real_sim_ratio)
    tr = [Selecting((0, nsample))]
    arms, weights = [], []
    if split == "train" and ratio[1]:
        arms.append(FixMicSigDataset(args.sim_sig_dir, load_anno=True, transforms=tr))
        weights.append(ratio[1])
    if ratio[0] or split != "train":
        arms.append(FixMicSigDatasetLOCATA(os.path.join(args.real_sig_dir, split),
                                           load_anno=True, transforms=tr))
        weights.append(ratio[0] if split == "train" else 1)
    if len(arms) == 1 and split != "train":
        # a fixed eval corpus: its first num files, in order
        arms[0].data_paths = arms[0].data_paths[:num]
        return batch_iterator(arms[0], bs, shuffle=False, num_workers=args.workers)
    # train draws num items with replacement over the whole of each arm (the
    # reference's randint per item), even from one arm
    ds = RandomMixDataset(arms, length=num, seed=seed * 13 + 5, probs=weights)
    return batch_iterator(ds, bs, shuffle=split == "train", seed=seed, num_workers=args.workers)


def _rir_batches(args, split, bs, seed, num, T, fs, rooms, pool):
    """Host batches of speech x RIR convolved on the fly: train from the real
    and / or simulated arm per --real-sim-ratio, val and test from the real
    arm when there is one; ``rooms`` limits the real arm (--rir-cv). Under
    --mp-loader the items are made in the run's process ``pool``."""
    from ..data import (MicSigFromRIRDataset, NpyRIRDataset, RandomMixDataset, SimRIRDataset,
                        SpeakerTreeDataset, batch_iterator, mp_batch_iterator)

    ratio = tuple(int(r) for r in args.real_sim_ratio)
    srcs = SpeakerTreeDataset(args.src_dir, T=T, fs=fs)

    def real_arm():
        return MicSigFromRIRDataset(NpyRIRDataset(args.rir_dir, fs=fs, rooms=rooms), srcs, T=T,
                                    fs=fs, seed=seed * 7 + 1, length=num)

    def sim_arm():
        return MicSigFromRIRDataset(SimRIRDataset(args.sim_rir_dir, fs=fs), srcs, T=T, fs=fs,
                                    seed=seed * 7 + 2, length=num, noise_type="diffuse_white")

    arms, weights = [], []
    if split == "train":
        if ratio[0] and args.rir_dir:
            arms.append(real_arm())
            weights.append(ratio[0])
        if ratio[1] and args.sim_rir_dir:
            arms.append(sim_arm())
            weights.append(ratio[1])
    else:
        arms.append(real_arm() if args.rir_dir else sim_arm())
        weights.append(1)
    ds = (arms[0] if len(arms) == 1 else
          RandomMixDataset(arms, length=num, seed=seed * 13 + 5, probs=weights))
    if pool is not None:
        return mp_batch_iterator(ds, bs, shuffle=split == "train", seed=seed,
                                 num_workers=args.workers, pool=pool)
    return batch_iterator(ds, bs, shuffle=split == "train", seed=seed, num_workers=args.workers)


def _file_batches(args, data_dir, split, bs, seed, trial, num, nsample, pi=0, pc=1):
    """Host batches (waves (bs, nsample, nch), the annotation columns) of a
    split read from a packed directory or an annotated wav tree. Train takes
    the trial's rows: its room block under --room-trials (then a fixed draw of
    --train-num of them), its fixed subset under --fixed-train-subset. Data
    rank ``pi`` of ``pc`` reads ``bs / pc`` rows a batch: its block of each
    packed batch (one shared permutation), its strided share of a tree
    (shuffled with its own seed)."""
    from ..data import FixMicSigDataset, PackedDataset, Selecting, batch_iterator, is_packed
    from ..data.shards import room_id_of_path

    train = split == "train"
    if is_packed(data_dir):
        pds = PackedDataset(data_dir, load_anno=True)
        subset = packed_train_subset(args, pds, num, trial) if train else None
        if subset is not None and args.room_trials:
            num = min(num, len(subset))
        from ..parallel import packed_batches

        it = packed_batches(pds, bs, pi, pc, shuffle=train, seed=seed, subset=subset)
        return ((w[:, :nsample], lab) for w, lab in itertools.islice(it, max(1, num // bs)))
    if args.room_trials and train:
        # the trial's room block, then a fixed seeded draw of num rows across
        # the whole block (not the first num paths, which would keep only the
        # block's lowest room ids)
        ds = FixMicSigDataset(data_dir, load_anno=True, transforms=[Selecting((0, nsample))])
        rooms = [room_id_of_path(p) for p in ds.data_paths]
        if any(r is None for r in rooms):
            raise ValueError(f"--room-trials: items outside R{{idx}}/ subdirs under {data_dir}")
        rows = trial_subset_draw(room_block_rows(rooms, args.ds_nsimroom, trial), num,
                                 args.seed, trial)
        ds.data_paths = [ds.data_paths[i] for i in rows]
    else:
        ds = FixMicSigDataset(data_dir, load_anno=True, data_num=num,
                              transforms=[Selecting((0, nsample))])
    if pc > 1:
        from ..parallel import shard_for_process

        ds.data_paths = shard_for_process(ds.data_paths, pi, pc)
        seed += pi * 7919
    return batch_iterator(ds, bs // pc, shuffle=train, seed=seed, num_workers=args.workers)


def pretrained_params(path: str, multipair: bool):
    """The parameters of a pretrain checkpoint file under the port's names,
    the trunk's (``model_sch.``) for the multi-pair model. Every leaf is read
    as f32, a leaf stored in f16 included (the JAX package's ``partial_load``
    keeps the stored dtype instead)."""
    from ..train import checkpoint as ckpt
    from ..utils import from_jax_params

    params, _ = from_jax_params({"params": ckpt.load_checkpoint(path)["params"]})
    if multipair:
        params = {"model_sch." + k: v for k, v in params.items()}
    return params


def grid_summary(task, mode, results):
    """The grid's ``results.json``: per (bs, lr) config the mean val and test
    MAE over trials; the best config by mean val MAE, non-finite ones left
    out of the choice."""
    by_cfg = {}
    for r in results.values():
        by_cfg.setdefault((r["bs"], r["lr"]), []).append(r)
    summary = {
        f"bs{bs}_lr{lr:g}": {
            "mean_val_mae": float(np.mean([r["val_mae"] for r in rs])),
            "mean_test_mae": float(np.mean([r["test_mae"] for r in rs])),
        } for (bs, lr), rs in by_cfg.items()}
    # a diverged cell (NaN val MAE) must neither win min() by NaN-compare
    # order nor knock its config out of contention silently
    finite = {k: v for k, v in summary.items() if np.isfinite(v["mean_val_mae"])}
    if len(finite) < len(summary):
        print(f"WARNING: {len(summary) - len(finite)} config(s) with "
              f"non-finite mean val MAE excluded from best-config selection")
    best = min(finite or summary, key=lambda k: summary[k]["mean_val_mae"])
    return {"task": task, "mode": mode, "cells": results, "summary": summary, "best": best,
            "best_test_mae": summary[best]["mean_test_mae"]}


def _ds_test(args, model, feat_cfg, make_batches, bs, dlabel, dev):
    """--ds-test modes:
    cal_metric          test loss and MAE of a trained checkpoint (``--ckpt``:
                        its ensemble model, else its best one);
    cal_metric_wo_info  the predict-the-train-mean baseline;
    vis_embed           a t-SNE of that checkpoint's test embeddings, coloured
                        by the raw labels, to ``<exp-dir>/tsne.png``."""
    from ..train import DownstreamLearner, create_train_state, make_downstream_eval_step
    from ..train import checkpoint as ckpt
    from ..train.learner import mae_without_training
    from ..train.steps import _target_transform

    if args.ds_test_mode == "cal_metric_wo_info":
        def targets(split, seed):
            return np.concatenate([_target_transform(args.ds_task, torch.as_tensor(g)).cpu().numpy()
                                   for _, g in make_batches(split, bs, seed)])
        r = mae_without_training(targets("train", args.seed), targets("test", 2))
        print(f"no-train baseline [{args.ds_task}]: "
              f"train MAE {r['mae_train']:.5f} test MAE {r['mae_test']:.5f} "
              f"(mean {r['mean']:.5f})")
        return 0

    state = create_train_state(model)
    if args.ckpt:
        path = (ckpt.ensemble_path(args.ckpt) if os.path.exists(ckpt.ensemble_path(args.ckpt))
                else ckpt.best_path(args.ckpt))
        ckpt.restore_state(state, ckpt.load_checkpoint(path), restore_opt=False)
        print(f"loaded {path}")
    eval_step = make_downstream_eval_step(model, feat_cfg, task=args.ds_task, dlabel=dlabel,
                                          device=dev)
    if args.ds_test_mode == "vis_embed":
        from ..utils import vis
        embeds, labels = [], []
        for wave, gt in make_batches("test", bs, 2):
            embeds.append(eval_step(state, wave, gt)["embed"].float().cpu().numpy())
            labels.append(torch.as_tensor(gt).cpu().numpy().ravel())
        out = vis.plot_tsne_embeddings(np.concatenate(embeds), np.concatenate(labels),
                                       os.path.join(args.exp_dir, "tsne.png"))
        print("t-SNE saved to", out)
        return 0
    m = DownstreamLearner(state=state, train_step=None, eval_step=eval_step,
                          lr_init=0.0).eval_epoch(make_batches("test", bs, 2), split="test")
    print(f"test [{args.ds_task}]: loss {m['loss']:.5f} MAE {m['mae']:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
