"""Epoch loops (port of ``sarssl_tpu/train/learner.py``): score smoothing,
early stopping, the pretext learner (an externally scheduled learning rate,
an optional fresh optimizer per epoch under ``--parity``) and the downstream
learner (smoothed-val early stopping with one lr/10 second stage, and the
uniform ensemble of the last best epochs), each with a checkpoint per epoch;
and the predict-the-train-mean baseline.

Metrics stay on the device inside an epoch: a step's loss is a 0-d tensor
that is only appended, so the host runs ahead of the card. They are read
once at the epoch's end, before its time is taken. Randomness comes from the
CPU ``torch.Generator`` given for the epoch: each step gets a child of it
(``utils/seeding.step_generator``), as the JAX learner splits a subkey.

Over a mesh (``parallel/steps.py``) every rank runs the same loop: the
steps' metrics are the global batch's, the same on every rank, so every
rank takes the same stopping decisions; checkpoints are written by rank 0
(``checkpoint.py``), and the caller gives a logger to rank 0 only.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import MetricLogger
from ..utils.seeding import step_generator
from ..utils.weights import from_jax_params
from . import checkpoint as ckpt


def smooth_data(values: List[float], alpha: float = 0.6) -> List[float]:
    """EMA smoothing of validation metrics."""
    out = []
    s = values[0] if values else 0.0
    for i, v in enumerate(values):
        s = v if i == 0 else alpha * s + (1 - alpha) * v
        out.append(s)
    return out


@dataclass
class EarlyStopping:
    """Max-score early stopping."""

    patience: int = 10
    best: float = -np.inf
    counter: int = 0
    stopped: bool = False

    def update(self, score: float) -> bool:
        """Returns True if this score is a new best (ties count as best)."""
        if score >= self.best:
            self.best = score
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.stopped = True
        return False

    def reset_counter(self):
        self.counter = 0
        self.stopped = False


def _data_ranks(state) -> int:
    """How many data ranks share each batch (1 off a mesh)."""
    layout = getattr(state.model, "shard_layout", None)
    return 1 if layout is None else layout.mesh.data_size


def _read_sums(*series: List[torch.Tensor]) -> Tuple[float, ...]:
    """Sums of 0-d device tensors, in f64, read back in one transfer."""
    if not series[0]:
        return tuple(0.0 for _ in series)
    return tuple(torch.stack([torch.stack(s).double().sum() for s in series]).tolist())


@dataclass
class PretrainLearner:
    """Pretext-task epoch loop."""

    state: object
    train_step: Callable
    eval_step: Callable
    lr_schedule: Callable[[int], float]
    ckpt_dir: Optional[str] = None
    patience: int = 100
    fresh_opt_each_epoch: bool = False
    logger: Optional[MetricLogger] = None
    stopper: EarlyStopping = field(default_factory=lambda: EarlyStopping(100))

    def __post_init__(self):
        self.stopper.patience = self.patience
        self.epoch = 0
        self.history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}

    def train_epoch(self, batches: Iterable, generator: torch.Generator) -> Dict[str, float]:
        if self.fresh_opt_each_epoch:
            self.state.reset_optimizer()
        lr = self.lr_schedule(self.epoch)
        losses, diffs, nutt, t0 = [], [], 0, time.time()
        for wave in batches:
            m = self.train_step(self.state, wave, lr, step_generator(generator))
            losses.append(m["loss"])
            diffs.append(m["diff"])
            nutt += wave.shape[0] * _data_ranks(self.state)
        n = len(losses)
        tot, tot_diff = _read_sums(losses, diffs)
        dt = time.time() - t0
        metrics = {"loss": tot / max(n, 1), "diff": tot_diff / max(n, 1),
                   "lr": lr, "utt_per_sec": nutt / max(dt, 1e-9)}
        self.history["train_loss"].append(metrics["loss"])
        if self.logger:
            self.logger.log("train", self.epoch, metrics)
        return metrics

    def eval_epoch(self, batches: Iterable, generator: torch.Generator,
                   split: str = "val") -> Dict[str, float]:
        losses, diffs = [], []
        for wave in batches:
            m = self.eval_step(self.state, wave, step_generator(generator))
            losses.append(m["loss"])
            diffs.append(m["diff"])
        n = len(losses)
        tot, tot_diff = _read_sums(losses, diffs)
        metrics = {"loss": tot / max(n, 1), "diff": tot_diff / max(n, 1)}
        if split == "val":
            self.history["val_loss"].append(metrics["loss"])
        if self.logger:
            self.logger.log(split, self.epoch, metrics)
        return metrics

    def end_epoch(self, val_loss: float) -> bool:
        """Checkpoint + early stopping; returns True on a new best."""
        is_best = self.stopper.update(-val_loss)
        if self.ckpt_dir:
            ckpt.save_checkpoint(self.ckpt_dir, self.state, self.epoch,
                                 self.stopper.best, is_best=is_best)
        self.epoch += 1
        return is_best

    @property
    def should_stop(self) -> bool:
        return self.stopper.stopped


@dataclass
class DownstreamLearner:
    """Fine-tune / lineareval epoch loop with smoothed-val early stopping and
    the reference's two-stage lr/10 schedule."""

    state: object
    train_step: Callable
    eval_step: Callable
    lr_init: float
    ckpt_dir: Optional[str] = None
    patience: int = 10
    smooth_alpha: float = 0.6
    logger: Optional[MetricLogger] = None

    def __post_init__(self):
        self.epoch = 0
        self.lr = self.lr_init
        self.lr_drops = 0
        self.stopper = EarlyStopping(self.patience)
        self.val_raw: List[float] = []
        self.best_epochs: List[int] = []

    def train_epoch(self, batches: Iterable, generator: torch.Generator) -> Dict[str, float]:
        losses, maes = [], []
        for wave, gt in batches:
            m = self.train_step(self.state, wave, gt, self.lr, step_generator(generator))
            losses.append(m["loss"])
            maes.append(m["mae"])
        n = len(losses)
        tot, tot_mae = _read_sums(losses, maes)
        metrics = {"loss": tot / max(n, 1), "mae": tot_mae / max(n, 1), "lr": self.lr}
        if self.logger:
            self.logger.log("train", self.epoch, metrics)
        return metrics

    def eval_epoch(self, batches: Iterable, split: str = "val") -> Dict[str, float]:
        """Mean loss and MAE over the batches, and ``mae_pair{k}``, the mean
        of the step's ``mae_dims``, when the step returns them (dlabel > 1)."""
        losses, maes, dims = [], [], []
        for wave, gt in batches:
            m = self.eval_step(self.state, wave, gt)
            losses.append(m["loss"])
            maes.append(m["mae"])
            if "mae_dims" in m:
                dims.append(m["mae_dims"])
        n = len(losses)
        tot, tot_mae = _read_sums(losses, maes)
        metrics = {"loss": tot / max(n, 1), "mae": tot_mae / max(n, 1)}
        if dims:
            for k, v in enumerate(torch.stack(dims).double().sum(0).tolist()):
                metrics[f"mae_pair{k}"] = v / n
        if self.logger:
            self.logger.log(split, self.epoch, metrics)
        return metrics

    def end_epoch(self, val_metric: float) -> bool:
        """Smoothed early stopping and a checkpoint; at the first stop lr /=
        10 and the counter restarts, at the second training halts. Returns
        True when training should halt."""
        self.val_raw.append(val_metric)
        smoothed = smooth_data(self.val_raw, self.smooth_alpha)[-1]
        is_best = self.stopper.update(-smoothed)
        if is_best:
            self.best_epochs.append(self.epoch)
        if self.ckpt_dir:
            ckpt.save_checkpoint(self.ckpt_dir, self.state, self.epoch,
                                 self.stopper.best, is_best=is_best)
        self.epoch += 1
        if self.stopper.stopped:
            if self.lr_drops == 0:
                self.lr /= 10.0
                self.lr_drops = 1
                self.stopper.reset_counter()
                return False
            return True
        return False

    @torch.no_grad()
    def ensemble(self, k: int = 5) -> Dict[str, torch.Tensor]:
        """Uniform average of the epoch checkpoints ``[max(0, best-k+1) ..
        best]`` that exist (consecutive epochs ending at the last best, not
        the sparse set of improving ones), over the whole model state:
        parameters and BatchNorm running stats alike. Installs both on the
        model, writes ``ensemble_model`` and returns the averaged parameters
        by name; with no epoch file, returns the current parameters."""
        assert self.ckpt_dir, "ensembling needs a checkpoint dir"
        best = self.best_epochs[-1] if self.best_epochs else self.epoch - 1
        epochs = [e for e in range(max(0, best - k + 1), best + 1)
                  if os.path.exists(ckpt.epoch_path(self.ckpt_dir, e))]
        model = self.state.model
        if not epochs:
            params = {n: p.detach() for n, p in model.named_parameters()}
            layout = getattr(model, "shard_layout", None)
            return params if layout is None else layout.full_dict(params)
        plist, blist = [], []
        for e in epochs:
            payload = ckpt.load_checkpoint(ckpt.epoch_path(self.ckpt_dir, e))
            params, buffers = from_jax_params({"params": payload["params"],
                                               "batch_stats": payload["batch_stats"]})
            plist.append(params)
            blist.append(buffers)
        avg, avg_bs = ckpt.ensemble_params(plist), ckpt.ensemble_params(blist)
        ckpt.load_full_state_dict(model, {**avg, **avg_bs})
        ckpt.save_named(self.ckpt_dir, self.state, "ensemble_model", epoch=-1,
                        max_score=self.stopper.best)
        return avg


def mae_without_training(train_targets, test_targets) -> Dict[str, float]:
    """Predict-the-train-mean MAE baseline (the reference's ``mae_wotrain``):
    the floor any learned model must beat."""
    train_targets = np.asarray(train_targets, np.float64).ravel()
    test_targets = np.asarray(test_targets, np.float64).ravel()
    mean = float(train_targets.mean())
    return {
        "mean": mean,
        "mae_train": float(np.mean(np.abs(train_targets - mean))),
        "mae_test": float(np.mean(np.abs(test_targets - mean))),
        "min_train": float(train_targets.min()),
        "max_train": float(train_targets.max()),
        "min_test": float(test_targets.min()),
        "max_test": float(test_targets.max()),
    }
