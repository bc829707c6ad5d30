"""Experiment configuration (the port's own copy of ``sarssl_tpu/config.py``):
the acoustic constants, the pretrain schedule and the downstream lr x bs x
trial grids, as plain dataclasses the CLIs read. ``DownstreamConfig``,
``real_ds_setting`` and ``exp_dirs`` come with the downstream CLI.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


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
