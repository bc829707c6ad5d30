"""Experiment configuration (the port's own copy of ``sarssl_tpu/config.py``):
the acoustic constants, the pretrain schedule and the downstream lr x bs x
trial grids (the simulated ones in ``DownstreamConfig``, the real-world
ones from ``real_ds_setting``), and the experiment directory layout, as
plain dataclasses the CLIs read.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple


@dataclass(frozen=True)
class AcousticSetting:
    fs: int = 16000
    T: float = 4.112          # seconds per utterance (256 STFT frames)
    nmic: int = 2
    mic_dist_range: Tuple[float, float] = (0.03, 0.20)
    c: float = 343.0
    snr_range: Tuple[float, float] = (15.0, 30.0)

    @property
    def nsample(self) -> int:
        return round(self.T * self.fs)  # round: float products
        # epsilon-under an integer must not drop a sample


@dataclass
class PretrainConfig:
    acoustics: AcousticSetting = field(default_factory=AcousticSetting)
    batch_size: int = 128
    nepoch: int = 30
    lr: float = 1e-3
    lr_final: float = 1e-6
    schedule: str = "cosine"   # sim pretraining; real fine-tune uses fixed 1e-4
    patience: int = 100
    train_num: int = 512000
    val_num: int = 4000
    dtype: str = "bfloat16"
    fresh_opt_each_epoch: bool = False  # --parity enables (learner.py:83)
    seed: int = 100


# Downstream grids (opt.py:201-256)
SIM_LR_SET = (1e-3, 5e-4, 1e-4, 5e-5)
SIM_BS_SET = (8,)
REAL_LR_SET = (1e-3, 1e-4)
REAL_BS_SET = (16,)


def sim_room_ntrial(nsimroom: int) -> int:
    """The ntrial rule (opt.py:205-206): max(1, round(32/nsimroom))."""
    return max(1, round(32 / nsimroom))


SIM_ROOM_TRIALS = {n: sim_room_ntrial(n) for n in (2, 4, 8, 16, 32, 64, 128, 256)}

# Real-world downstream training-set sizes by (train_mode, real_sim_ratio)
# for the non-TDOA tasks; TDOA always uses 80,000 (opt.py:216-256).
_REAL_NUM = {
    "finetune":   {(1, 0): 1600, (1, 1): 3200, (0, 1): 32000},
    "scratchlow": {(1, 0): 1600, (1, 1): 16000, (0, 1): 32000},
}


def real_ds_setting(task: str, train_mode: str,
                    real_sim_ratio: Sequence[int] = (1, 1)) -> Dict:
    """The real-world downstream setting (opt.py:216-256): bs 16, lr {1e-3,
    1e-4}, 200 epochs, 1 trial, and the training count: TDOA 80,000, the
    other tasks by train mode and real/sim mixing ratio."""
    ratio = tuple(int(r) for r in real_sim_ratio)
    assert ratio in ((1, 0), (1, 1), (0, 1)), ratio
    if task == "TDOA":
        num = 80_000
    else:
        if train_mode not in _REAL_NUM:
            raise ValueError(
                f"no real-world training count defined for train mode "
                f"'{train_mode}' (reference opt.py:235-236 raises too)")
        num = _REAL_NUM[train_mode][ratio]
    return {"nepoch": 200, "num": num, "lr_set": list(REAL_LR_SET),
            "bs_set": list(REAL_BS_SET), "ntrial": 1}


@dataclass
class DownstreamConfig:
    """The simulated downstream grid. Only what the downstream CLI reads:
    patience, epochs, counts and dtype come from its flags and
    ``DownstreamLearner``."""
    task: str = "TDOA"         # TDOA | DRR | T60 | C50 | ABS | SNR
    train_mode: str = "finetune"  # finetune | lineareval | scratchlow
    nsimroom: int = 8
    lr_set: Sequence[float] = SIM_LR_SET
    bs_set: Sequence[int] = SIM_BS_SET

    @property
    def ntrial(self) -> int:
        return sim_room_ntrial(self.nsimroom)

    @property
    def train_num(self) -> int:
        return self.nsimroom * 100

    @property
    def T(self) -> float:
        # TDOA uses 1.04 s clips (64 frames), the other tasks 4.112 s
        return 1.04 if self.task == "TDOA" else 4.112


def exp_dirs(root: str = "exp", time_ver: str | None = None) -> Dict[str, str]:
    """Experiment directory layout (reference opt.py dir())."""
    tv = time_ver or time.strftime("%m%d%H%M")
    base = os.path.join(root, tv)
    return {
        "base": base,
        "ckpt_pretrain": os.path.join(base, "pretrain", "checkpoints"),
        "log_pretrain": os.path.join(base, "pretrain", "logs"),
        "ckpt_downstream": os.path.join(base, "downstream", "checkpoints"),
        "log_downstream": os.path.join(base, "downstream", "logs"),
        "results": os.path.join(base, "results"),
    }
