"""Downstream result-grid readers (the port's own copy of
``sarssl_tpu/utils/results.py``): the ``results.json`` that
``run_downstream`` writes, read into best-config MAE tables over the lr x bs
grid and across trials.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List


def read_results(exp_dir: str) -> Dict:
    with open(os.path.join(exp_dir, "results.json")) as f:
        return json.load(f)


def mae_table(exp_dirs: List[str], metric: str = "test_mae") -> Dict[str, Dict]:
    """Per experiment, keyed by task: the best config, its test MAE and the
    grid of per-config means of ``metric``."""
    out = {}
    for d in exp_dirs:
        r = read_results(d)
        out[r.get("task", os.path.basename(d))] = {
            "best_config": r["best"],
            "best_test_mae": r["best_test_mae"],
            "grid": {k: v[f"mean_{metric}"] if f"mean_{metric}" in v
                     else v.get("mean_test_mae")
                     for k, v in r["summary"].items()},
        }
    return out


def print_mae_table(exp_dirs: List[str]):
    table = mae_table(exp_dirs)
    width = max(len(t) for t in table) + 2
    print(f"{'task':{width}s} {'best config':>16s} {'test MAE':>12s}")
    for task, row in table.items():
        print(f"{task:{width}s} {row['best_config']:>16s} "
              f"{row['best_test_mae']:>12.5f}")
