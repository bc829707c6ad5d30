"""Delimited text tables read into typed numpy columns.

The JAX package reads two corpus tables with pandas: LOCATA's position and
time TSVs (``sarssl_tpu/data/locata.py``) and ACE's T60 / DRR CSV
(``sarssl_tpu/data/extractors.py``). The port reads them with the ``csv``
module and types each column as ``pandas.read_csv`` does for such files: a
column whose cells all read as integers is int64, one whose cells all read as
numbers (missing cells as NaN) is float64, any other is a column of strings.
A number is read with ``float()``. pandas' default converter agrees with it
bit for bit on the cells these corpora hold (at most 15 significant digits, a
decimal exponent within +-22); on longer cells the two may differ in the last
place.
"""
from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np

# the cells pandas reads as missing by default
NA_CELLS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                      "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                      "nan", "null"})


def _column(cells: List[str]) -> np.ndarray:
    missing = [c in NA_CELLS for c in cells]
    if not any(missing):
        try:
            return np.array([int(c) for c in cells], np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)],
                        np.float64)
    except ValueError:
        return np.array([np.nan if m else c for c, m in zip(cells, missing)], object)


def read_table(path: str, sep: str) -> Dict[str, np.ndarray]:
    """{column name: typed values} of a table with a header row; ``sep`` is
    the literal separator (one or more characters). Blank lines are skipped;
    a row with another number of cells than the header raises."""
    with open(path, newline="") as f:
        if len(sep) == 1:
            rows = [r for r in csv.reader(f, delimiter=sep) if r]
        else:
            rows = [line.rstrip("\r\n").split(sep) for line in f if line.strip("\r\n")]
    if not rows:
        raise ValueError(f"{path}: empty table")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} cells, the header {len(header)}")
    return {name: _column([r[j] for r in body]) for j, name in enumerate(header)}
