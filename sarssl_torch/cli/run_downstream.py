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
packed split. ``--synthetic`` carries TDOA labels only.

Usage:
  python -m sarssl_torch.cli.run_downstream --ds-train --ds-task T60 --data-dir DATA \
      --pretrain-ckpt DIR
  python -m sarssl_torch.cli.run_downstream --ds-train --synthetic --pretrain-ckpt DIR
  python -m sarssl_torch.cli.run_downstream --ds-test --synthetic --ckpt CELL/ckpt
  python -m sarssl_torch.cli.run_downstream --smoke            # tiny run on the card
  python -m sarssl_torch.cli.run_downstream --smoke --cpu      # tiny run on the CPU

It runs on the card unless ``--cpu`` is given (``--smoke`` included). The
parser holds every flag of the JAX CLI, with its default and ``dest``, so
``config.json`` has the same keys; a flag whose path is not ported yet raises
``NotImplementedError`` when it is set. ``--grid-chunk``, ``--scan-block``,
``--time-budget`` and ``--trial-set`` act only under ``--grid-vmap``, so here
they have no effect, as in the JAX CLI's sequential grid; ``--workers`` sets
the wav-tree loader's threads.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import sys

import numpy as np
import torch

_NOT_PORTED = "not ported yet"


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
    for flag in ("--rir-dir", "--sim-rir-dir", "--src-dir"):
        p.add_argument(flag, type=str, default=None, help=_NOT_PORTED)
    p.add_argument("--rir-cv", action="store_true", help=_NOT_PORTED)
    p.add_argument("--real-sig-dir", type=str, default=None, help=_NOT_PORTED)
    p.add_argument("--sim-sig-dir", type=str, default=None, help=_NOT_PORTED)
    p.add_argument("--real-sim-ratio", type=int, nargs=2, default=(1, 1),
                   metavar=("REAL", "SIM"),
                   help="training-arm mix of real and simulated data; here it only "
                        "selects the --real-exp training count")
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
                   help="wav-tree loader threads (the synthetic generator takes none)")
    p.add_argument("--grid-vmap", action="store_true", help=_NOT_PORTED)
    p.add_argument("--grid-chunk", type=int, default=8, help="--grid-vmap only")
    p.add_argument("--trial-set", type=int, nargs="+", default=None, help="--grid-vmap only")
    p.add_argument("--scan-block", type=int, default=25, help="--grid-vmap only")
    p.add_argument("--time-budget", type=float, default=0, help="--grid-vmap only")
    p.add_argument("--mp-loader", action="store_true", help=_NOT_PORTED)
    p.add_argument("--nmic", type=int, default=2,
                   help="microphone count; > 2 builds the multi-pair "
                        "SARSSLMultiCH head")
    p.add_argument("--ch-mode", type=str, default="M", choices=["M", "MM"],
                   help="mic pairing: ref-mic pairs or all pairs")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--mesh", type=str, default=None, help=_NOT_PORTED)
    return p


# flags whose path the port lacks, and what it waits for
_REAL_DATA = "waits for the port of the real-data half of the data path"
_UNPORTED = {
    **{dest: _REAL_DATA for dest in ("rir_dir", "sim_rir_dir", "src_dir", "rir_cv",
                                     "real_sig_dir", "sim_sig_dir", "mp_loader")},
    "grid_vmap": "waits for the port of the vmapped grid runner",
    "mesh": "the port runs on one card",
}


def _check_ported(args, parser) -> None:
    for dest, why in _UNPORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: it {why}")
    synthetic = args.synthetic or args.smoke  # --smoke runs on synthetic data
    if not (synthetic or args.data_dir):
        raise ValueError("no data source: pass --data-dir or --synthetic")
    if synthetic and args.ds_task != "TDOA":
        raise ValueError(f"--ds-task {args.ds_task}: the synthetic data carries TDOA labels only")
    if args.room_trials:
        if synthetic or not args.data_dir:
            raise ValueError("--room-trials reads a certain-room corpus from --data-dir and "
                             "composes with no other data source")
        if not (args.val_data_dir and args.test_data_dir):
            raise ValueError("--room-trials: pass --val-data-dir and --test-data-dir (held-out "
                             "corpora): evaluating on the training rooms would leak")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_ported(args, parser)

    from ..config import DownstreamConfig, real_ds_setting
    from ..data import (FixMicSigDataset, PackedDataset, SyntheticPairs, device_prefetch,
                        is_packed, synthetic)
    from ..models import SARSSL, SARSSLConfig, SARSSLMultiCH
    from ..ops import FeatureConfig, num_pairs, pairwise_tdoa
    from ..train import (DownstreamLearner, create_train_state, make_downstream_eval_step,
                         make_downstream_step, partial_load, trainable_mask_from_loaded)
    from ..train import checkpoint as ckpt
    from ..utils import MetricLogger, epoch_generator, resolve_device, save_config, set_seed

    dev = resolve_device("cpu" if args.cpu else "cuda")
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
        args.lr_set = [1e-3]
        args.bs_set = [4]
        args.ntrial = 1
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
        model.load_state_dict(init_sd, strict=True)
        keys = []
        if pre_sd is not None:
            keys = partial_load(model, pre_sd)
            if not keys:
                raise ValueError("--pretrain-ckpt matched zero parameter keys: wrong "
                                 "checkpoint for this model config")
        return create_train_state(model), keys

    def make_batches(split, bs, seed, trial=0):
        """The split's batches as device tensors: waves, and the task's
        targets (per pair for the multi-pair model)."""
        num = {"train": train_num, "val": args.val_num, "test": args.test_num}[split]
        nbatch = max(1, num // bs)
        if not args.synthetic:
            data_dir = {"train": args.data_dir, "val": args.val_data_dir or args.data_dir,
                        "test": args.test_data_dir or args.data_dir}[split]
            it = _file_batches(args, data_dir, split, bs, seed, trial, num, nsample)
        elif multipair:
            def gen():
                rng = np.random.default_rng(seed)
                for _ in range(nbatch):
                    wave, tdoa = synthetic.synth_batch_multich(rng, bs, nsample, nch=args.nmic)
                    yield wave, {"TDOA": tdoa / fs}
            it = gen()
        else:
            it = SyntheticPairs(nsample=nsample, seed=seed).batches(bs, nbatch, with_labels=True)

        def adapt():
            for wave, gt in it:
                g = np.asarray(gt[args.ds_task], np.float32)
                if multipair and args.ds_task == "TDOA":
                    # per-mic (against mic 0) annotations -> per-pair targets
                    g = pairwise_tdoa(torch.from_numpy(g.reshape(g.shape[0], -1)), args.nmic,
                                      args.ch_mode).numpy()
                yield wave, g
        return device_prefetch(adapt(), size=2, device=dev)

    os.makedirs(args.exp_dir, exist_ok=True)
    save_config(vars(args), os.path.join(args.exp_dir, "config.json"))

    if args.ds_test:
        return _ds_test(args, model, feat_cfg, make_batches, bs_set[0], dlabel, dev)

    results = {}
    for trial, bs, lr in itertools.product(range(ntrial), bs_set, lr_set):
        cell = f"trial{trial}_bs{bs}_lr{lr:g}"
        cell_dir = os.path.join(args.exp_dir, cell)
        state, keys = fresh_state()
        if pre_sd is not None:
            print(f"{cell}: partial_load: {len(keys)}/{len(state.optimizer.names)} "
                  f"parameters loaded")
        tmask = None
        if args.ds_trainmode == "lineareval" and keys:
            tmask = trainable_mask_from_loaded(model, keys)
        train_step = make_downstream_step(model, feat_cfg, task=args.ds_task,
                                          trainable_mask=tmask, dlabel=dlabel, device=dev)
        eval_step = make_downstream_eval_step(model, feat_cfg, task=args.ds_task,
                                              dlabel=dlabel, device=dev)
        logger = MetricLogger(os.path.join(cell_dir, "logs"), use_tensorboard=False)
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
            logger.close()
        results[cell] = {"val_mae": val_m["mae"], "test_mae": test_m["mae"],
                         "lr": lr, "bs": bs, "trial": trial, "epochs_run": learner.epoch}
        print(f"{cell}: val MAE {val_m['mae']:.5f} test MAE {test_m['mae']:.5f}", flush=True)
        kept = set(learner.best_epochs[-5:])
        ckpt.remove_checkpoint_epochs(os.path.join(cell_dir, "ckpt"),
                                      [e for e in range(learner.epoch) if e not in kept])

    out = grid_summary(args.ds_task, args.ds_trainmode, results)
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


def _file_batches(args, data_dir, split, bs, seed, trial, num, nsample):
    """Host batches (waves (bs, nsample, nch), the annotation columns) of a
    split read from a packed directory or an annotated wav tree. Train takes
    the trial's rows: its room block under --room-trials (then a fixed draw of
    --train-num of them), its fixed subset under --fixed-train-subset."""
    from ..data import FixMicSigDataset, PackedDataset, Selecting, batch_iterator, is_packed
    from ..data.shards import room_id_of_path

    train = split == "train"
    if is_packed(data_dir):
        pds = PackedDataset(data_dir, load_anno=True)
        subset = packed_train_subset(args, pds, num, trial) if train else None
        if subset is not None and args.room_trials:
            num = min(num, len(subset))
        it = pds.iter_batches(bs, shuffle=train, seed=seed, subset=subset)
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
    return batch_iterator(ds, bs, shuffle=train, seed=seed, num_workers=args.workers)


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
