"""Profiling helpers (port of ``sarssl_tpu/utils/profiling.py``): a
``torch.profiler`` trace around a region and a step timer that synchronises
the device before it reads the clock."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, torch.nn.Module):
        return next(tree.parameters(), None)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(tree) -> None:
    """Wait until the device of the first tensor leaf of ``tree`` (a tensor,
    a module, or nested dicts / lists / tuples) has finished its work."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the context (the host, and the card where
    there is one) and write it as a Chrome trace, ``<log_dir>/trace.json``
    (Perfetto or ``chrome://tracing`` read it). Yields the profiler, whose
    ``key_averages()`` sum the kernels by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time statistics with device synchronisation."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> Optional[float]:
        if outputs is not None:
            sync(outputs)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {"mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3),
                "items_per_sec": float(items_per_step / t.mean())}
