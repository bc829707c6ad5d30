"""Pretext pre-training CLI (port of ``sarssl_tpu/cli/run_pretrain.py``).

Masked cross-channel reconstruction pre-training of the dual-encoder
MC-Conformer, with a cosine lr, early stopping, per-epoch checkpoints (flax
msgpack files both packages read) and JSONL metrics; ``--mel-bins`` for mel
features, ``--pretrain-frozen-encoder`` to retrain the decoder over the
encoders of ``--init-ckpt``, and ``--test`` to evaluate ``best_model``'s
reconstructions (MSEs, PESQ, wav / plot / .mat dumps).

Usage:
  python -m sarssl_torch.cli.run_pretrain --pretrain --synthetic --fused-attention
  python -m sarssl_torch.cli.run_pretrain --test --synthetic --exp-dir DIR
  python -m sarssl_torch.cli.run_pretrain --smoke            # tiny run on the card
  python -m sarssl_torch.cli.run_pretrain --smoke --cpu      # tiny run on the CPU

It runs on the card unless ``--cpu`` is given (``--smoke`` included). The
parser holds every flag of the JAX CLI, with its default and ``dest``, so
``config.json`` has the same keys; a flag whose path is not ported yet raises
``NotImplementedError`` when it is set.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser("sarssl_torch pretrain")
    p.add_argument("--pretrain", action="store_true")
    p.add_argument("--test", action="store_true",
                   help="evaluate <exp-dir>/checkpoints/best_model's reconstructions")
    p.add_argument("--smoke", action="store_true",
                   help="tiny synthetic end-to-end run (CI)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the file-free synthetic pair generator (host)")
    p.add_argument("--device-synth", action="store_true", help="not ported yet")
    p.add_argument("--data-dir", type=str, default=None, help="not ported yet")
    p.add_argument("--val-data-dir", type=str, default=None, help="not ported yet")
    p.add_argument("--exp-dir", type=str, default="exp/pretrain")
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--fused-attention", action="store_true",
                   help="the hand-written fused attention kernels (CUDA)")
    p.add_argument("--mel-bins", type=int, default=0,
                   help="> 0: mel-scale features with this many bands")
    p.add_argument("--train-num", type=int, default=512000)
    p.add_argument("--val-num", type=int, default=4000)
    p.add_argument("--workers", type=int, default=8,
                   help="data loader workers (the synthetic generator takes none)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--parity", action="store_true",
                   help="reference quirks: fresh Adam each epoch")
    p.add_argument("--pretrain-frozen-encoder", action="store_true",
                   help="freeze the encoders of --init-ckpt, retrain the decoder on the "
                        "kept-channel-only pretext")
    p.add_argument("--init-ckpt", type=str, default=None,
                   help="checkpoint dir to initialize from (best_model)")
    p.add_argument("--real-data-dirs", type=str, nargs="+", default=None,
                   help="not ported yet")
    p.add_argument("--real-corpora", type=str, nargs="+", default=None, help="not ported yet")
    p.add_argument("--real-data-probs", type=float, nargs="+", default=None,
                   help="not ported yet")
    p.add_argument("--remove-spkoverlap", action="store_true", help="not ported yet")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume-from-best", action="store_true",
                   help="resume from best_model instead of latest")
    p.add_argument("--extra-val-dirs", type=str, nargs="+", default=None,
                   help="not ported yet")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--mesh", type=str, default=None, help="not ported yet")
    p.add_argument("--resident", action="store_true", help="not ported yet")
    p.add_argument("--resident-dtype", type=str, default="float32",
                   choices=["float32", "int16"], help="not ported yet")
    p.add_argument("--resident-num", type=int, default=None, help="not ported yet")
    return p


# flags whose path the port lacks, and what it waits for
_DATA_PATH = "waits for the port of the data path"
_UNPORTED = {
    "device_synth": _DATA_PATH, "data_dir": _DATA_PATH, "val_data_dir": _DATA_PATH,
    "real_data_dirs": _DATA_PATH, "real_corpora": _DATA_PATH, "real_data_probs": _DATA_PATH,
    "remove_spkoverlap": _DATA_PATH, "extra_val_dirs": _DATA_PATH, "resident": _DATA_PATH,
    "resident_dtype": _DATA_PATH, "resident_num": _DATA_PATH,
    "mesh": "the port runs on one card",
}


def _check_ported(args, parser) -> None:
    for dest, why in _UNPORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: it {why}")
    if not (args.synthetic or args.smoke):
        raise NotImplementedError("reading data from files is not ported yet: pass --synthetic")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_ported(args, parser)

    from ..config import AcousticSetting
    from ..data import SyntheticPairs, device_prefetch
    from ..models import SARSSL, SARSSLConfig
    from ..ops import FeatureConfig
    from ..train import (PretrainLearner, cosine_schedule, create_train_state,
                         make_pretrain_eval_step, make_pretrain_step,
                         trainable_mask_from_loaded)
    from ..train import checkpoint as ckpt
    from ..utils import (MetricLogger, count_params, epoch_generator, from_jax_params,
                         resolve_device, save_config, set_seed)

    dev = resolve_device("cpu" if args.cpu else "cuda")
    # every matmul and convolution in full f32 where the model computes in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {dev}; TF32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    if args.smoke:
        args.pretrain = True
        args.synthetic = True
        args.epochs = min(args.epochs, 2)
        args.bs = 4
        args.train_num = 16
        args.val_num = 8

    ac = AcousticSetting()
    nsample = ac.nsample if not args.smoke else 2304
    feat_cfg = FeatureConfig(mel_bins=args.mel_bins)
    nt = feat_cfg.num_frames(nsample)
    nf = feat_cfg.nf_used

    if args.smoke:
        # as in the JAX CLI, the smoke model keeps the default pretext input
        # under --pretrain-frozen-encoder; only the freeze applies
        mcfg = SARSSLConfig(dtype="float32").tiny(
            sig_shape=(nf, nt, 2, 2), patch_shape=(nf, 1),
            spec_dembed=32, spat_dembed=16)
    else:
        mcfg = SARSSLConfig(
            sig_shape=(nf, nt, 2, 2), patch_shape=(nf, 1), dtype=args.dtype,
            fused_attention=args.fused_attention,
            frozen_encoder_pretext=args.pretrain_frozen_encoder)

    model = SARSSL(mcfg, device=dev, seed=args.seed)
    set_seed(args.seed)
    state = create_train_state(model, lr=args.lr)
    print("# Parameters (M):", count_params(model, ["spec_encoder", "spat_encoder", "decoder"]))

    ckpt_dir = os.path.join(args.exp_dir, "checkpoints")
    log_dir = os.path.join(args.exp_dir, "logs")
    os.makedirs(ckpt_dir, exist_ok=True)
    # a --test run points --exp-dir at a training run: its config goes beside
    # that run's instead of over it
    save_config(vars(args), os.path.join(args.exp_dir,
                                         "config_test.json" if args.test else "config.json"))

    if args.test:
        return _pretext_test(args, state, feat_cfg, nsample, dev)

    trainable_mask = None
    if args.init_ckpt:
        payload = ckpt.load_checkpoint(ckpt.best_path(args.init_ckpt))
        params, _ = from_jax_params({"params": payload["params"]})
        loaded = ckpt.partial_load(model, params)
        state.reset_optimizer()
        print(f"partial_load: {len(loaded)}/{len(list(model.parameters()))} keys loaded")
        if args.pretrain_frozen_encoder:
            # freeze everything loaded but the decoder
            trainable_mask = trainable_mask_from_loaded(
                model, [k for k in loaded if not k.startswith("decoder")])

    train_step = make_pretrain_step(model, feat_cfg, device=dev, trainable_mask=trainable_mask)
    eval_step = make_pretrain_eval_step(model, feat_cfg, device=dev)

    logger = MetricLogger(log_dir)
    learner = PretrainLearner(
        state=state, train_step=train_step, eval_step=eval_step,
        lr_schedule=cosine_schedule(args.epochs, args.lr, warmup_steps=args.warmup_epochs),
        ckpt_dir=ckpt_dir, patience=100, fresh_opt_each_epoch=args.parity, logger=logger)

    resume_path = (ckpt.best_path(ckpt_dir) if args.resume_from_best
                   else ckpt.latest_path(ckpt_dir))
    if (args.resume or args.resume_from_best) and os.path.exists(resume_path):
        payload = ckpt.load_checkpoint(resume_path)
        ckpt.restore_state(learner.state, payload, restore_opt=not args.resume_from_best)
        learner.epoch = payload["meta"]["epoch"] + 1
        # the early-stop high-water mark too, else the first resumed epoch is
        # a "new best" whatever its loss and can overwrite best_model
        learner.stopper.best = payload["meta"].get("max_score", learner.stopper.best)
        print(f"resumed from epoch {payload['meta']['epoch']} "
              f"({os.path.basename(resume_path)})")

    def batches(split, epoch):
        num = args.train_num if split == "train" else args.val_num
        # val reads one fixed set across epochs
        gen = SyntheticPairs(nsample=nsample, seed=args.seed + epoch if split == "train" else 1)
        return device_prefetch(gen.batches(args.bs, max(1, num // args.bs)), size=2,
                               device=dev)

    try:
        for epoch in range(learner.epoch, args.epochs):
            tm = learner.train_epoch(batches("train", epoch),
                                     epoch_generator(args.seed, "train", epoch))
            vm = learner.eval_epoch(batches("val", epoch),
                                    epoch_generator(args.seed, "val", epoch))
            learner.end_epoch(vm["loss"])
            print(f"epoch {epoch}: train loss {tm['loss']:.5f} "
                  f"val loss {vm['loss']:.5f} diff {vm['diff']:.5f} "
                  f"lr {tm['lr']:.2e} {tm['utt_per_sec']:.1f} utt/s", flush=True)
            if learner.should_stop:
                print("early stopping")
                break
    finally:
        logger.close()

    if args.smoke:
        h = learner.history
        if not h["train_loss"]:  # e.g. --resume with no epochs left to run
            print("SMOKE PASS (no epochs left to run)")
            return 0
        ok = (len(h["train_loss"]) < 2
              or h["train_loss"][-1] < h["train_loss"][0])
        print("SMOKE", "PASS" if ok else "FAIL",
              f"(loss {h['train_loss'][0]:.4f} -> {h['train_loss'][-1]:.4f})")
        return 0 if ok else 1
    return 0


def _pretext_test(args, state, feat_cfg, nsample, dev):
    """--test: reconstruction metrics of ``best_model`` on the fixed val set,
    and per-item dumps of its first batch (the reference's ``run_pretrain.py``
    'all' and 'ins' modes)."""
    import json

    from .. import ops
    from ..data import SyntheticPairs, device_prefetch
    from ..train import checkpoint as ckpt
    from ..train.pretext_eval import pretext_metrics

    payload = ckpt.load_checkpoint(ckpt.best_path(os.path.join(args.exp_dir, "checkpoints")))
    ckpt.restore_state(state, payload, restore_opt=False)
    print(f"loaded best checkpoint (epoch {payload['meta']['epoch']})")

    model, mcfg = state.model, state.model.cfg
    batches = SyntheticPairs(nsample=nsample, seed=1).batches(
        args.bs, max(1, args.val_num // args.bs))
    out_dir = os.path.join(args.exp_dir, "test_dumps")
    os.makedirs(out_dir, exist_ok=True)
    mses, mse_masks, pesqs, pesq_mask_chs = [], [], [], []
    gen = torch.Generator().manual_seed(123)  # one mask a batch
    model.eval()
    for bi, wave in enumerate(device_prefetch(batches, size=2, device=dev)):
        with torch.no_grad():
            feats = ops.stft_features(torch.as_tensor(wave).to(dev, torch.float32), feat_cfg)
            mask = ops.gen_patch_mask(gen, feats.shape[0], mcfg.npatch,
                                      mcfg.effective_nmasked(), nmic=2, device=dev)
            _, _, aux = model.pretext(feats, mask, False)
        m = pretext_metrics(aux, mcfg.sig_shape, mcfg.patch_shape, compute_pesq=True)
        mses.append(m["mse"])
        mse_masks.append(m["mse_mask"])
        pesqs.append(m["pesq"])
        pesq_mask_chs.append(m["pesq_mask_ch"])
        if bi == 0:
            _write_dumps(out_dir, m)
    summary = {"mse": float(np.mean(mses)), "mse_mask": float(np.mean(mse_masks)),
               "pesq": float(np.nanmean(np.concatenate(pesqs))),
               "pesq_mask_ch": float(np.nanmean(np.concatenate(pesq_mask_chs)))}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"pretext test: mse {summary['mse']:.6f} "
          f"masked mse {summary['mse_mask']:.6f} "
          f"pesq {summary['pesq']:.3f} "
          f"pesq[masked ch] {summary['pesq_mask_ch']:.3f} "
          f"(dumps in {out_dir})")
    return 0


def _write_dumps(out_dir, m):
    """The first batch's dumps: item 0's TF maps (``recon_tf.png``) and
    waveforms (``pred0.wav``, ``tar0.wav``), and up to 32 items' mask,
    prediction, target and PESQ (``ins_{i}.mat``)."""
    from ..data import write_wav
    from ..utils.vis import plot_tf_reconstruction

    pred_tf, tar_tf = m["pred_tf"], m["tar_tf"]
    if plot_tf_reconstruction(pred_tf[0], tar_tf[0], None,
                              os.path.join(out_dir, "recon_tf.png")) is None:
        print("recon_tf.png not written: matplotlib is not installed")
    write_wav(os.path.join(out_dir, "pred0.wav"), m["sig_pred"][0], 16000)
    write_wav(os.path.join(out_dir, "tar0.wav"), m["sig_tar"][0], 16000)
    try:
        from scipy.io import savemat
        for i in range(min(pred_tf.shape[0], 32)):
            savemat(os.path.join(out_dir, f"ins_{i}.mat"),
                    {"mask": m["mask_dense"][i], "pred": pred_tf[i], "tar": tar_tf[i],
                     "pesq": m["pesq"][i]})
    except Exception as e:  # the .mat files are a convenience only
        print("savemat skipped:", e)


if __name__ == "__main__":
    sys.exit(main())
