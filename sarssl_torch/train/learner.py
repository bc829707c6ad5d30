"""Epoch loops (port of the pre-training half of
``sarssl_tpu/train/learner.py``): score smoothing, early stopping and the
pretext learner, with an externally scheduled learning rate, an optional
fresh optimizer per epoch (``--parity``) and a checkpoint per epoch.

Metrics stay on the device inside an epoch: a step's loss is a 0-d tensor
that is only appended, so the host runs ahead of the card. They are read
once at the epoch's end, before its time is taken. Randomness comes from the
CPU ``torch.Generator`` given for the epoch: each step gets a child of it
(``utils/seeding.step_generator``), as the JAX learner splits a subkey.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import MetricLogger
from ..utils.seeding import step_generator
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
            nutt += wave.shape[0]
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
