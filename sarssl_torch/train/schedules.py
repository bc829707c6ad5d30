"""Learning-rate schedules (port of ``sarssl_tpu/train/schedules.py``).

A warm-up ramp multiplied onto a cosine or linear decay over *epochs*: the
learner feeds the epoch index and applies the value for the whole epoch.
Plain Python floats.
"""
from __future__ import annotations

import math


def _progress(step, total_steps, warmup_steps):
    p = (step - warmup_steps) / float(max(total_steps - warmup_steps, 1))
    return min(max(p, 0.0), 1.0)


def cosine_schedule(total_steps: int, base: float, warmup_steps: int = 0,
                    linear_end: float = 1e-5):
    def fn(step):
        lr = base * 0.5 * (1.0 + math.cos(math.pi * _progress(step, total_steps, warmup_steps)))
        if warmup_steps:
            lr *= min(1.0, step / warmup_steps)
        return float(lr)
    return fn


def linear_schedule(total_steps: int, base: float, warmup_steps: int = 0,
                    linear_end: float = 1e-5):
    def fn(step):
        p = _progress(step, total_steps, warmup_steps)
        lr = linear_end + (base - linear_end) * (1.0 - p)
        if warmup_steps:
            lr *= min(1.0, step / warmup_steps)
        return float(lr)
    return fn


def exp_decay(lr_init: float, step_size: float, gamma: float):
    """``lr = lr_init * gamma ** (epoch / step_size)``."""
    def fn(epoch):
        return float(lr_init * gamma ** (epoch / step_size))
    return fn
