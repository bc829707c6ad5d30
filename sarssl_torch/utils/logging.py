"""Metric logging (port of ``sarssl_tpu/utils/logging.py``): JSONL always;
TensorBoard event files when tensorboardX is installed."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._writers: Dict[str, Any] = {}
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self._tb = SummaryWriter
            except ImportError:
                pass

    def log(self, split: str, step: int, metrics: Dict[str, float]):
        # anything float() converts is kept; arrays and strings are skipped
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                pass
        rec = {"split": split, "step": int(step), "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            if split not in self._writers:
                self._writers[split] = self._tb(os.path.join(self.log_dir, split))
            w = self._writers[split]
            for k, v in scalars.items():
                w.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        for w in self._writers.values():
            w.close()


def save_config(obj: Any, path: str):
    """JSON dump of a run's configuration."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def default(o):
        if hasattr(o, "__dict__"):
            return o.__dict__
        return str(o)

    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=default)
