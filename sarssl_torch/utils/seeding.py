"""Deterministic seeding (port of ``sarssl_tpu/utils/seeding.py``).

The JAX package folds one root key per (purpose, epoch). The port gives each
(purpose, epoch) its own CPU ``torch.Generator``, seeded from the run's seed,
the purpose and the epoch, and derives a child generator per step from it,
as the JAX learner splits a subkey per step. No global state is read.
"""
from __future__ import annotations

import random
import zlib

import numpy as np
import torch

_PURPOSES = {"train": 0, "val": 1, "test": 2, "data": 3, "mask": 4, "init": 5}
_MASK64 = (1 << 64) - 1


def set_seed(seed: int) -> None:
    """Seed the host-side RNGs: ``random``, numpy and torch."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def _purpose_id(purpose: str) -> int:
    """The JAX package's ids; unknown purposes take a stable crc32 digest
    (``hash()`` is salted per process), offset past the reserved ids."""
    pid = _PURPOSES.get(purpose)
    if pid is None:
        pid = len(_PURPOSES) + zlib.crc32(purpose.encode()) % 991
    return pid


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _mix(seed: int, *words: int) -> int:
    h = _splitmix64(seed & _MASK64)
    for word in words:
        h = _splitmix64(h ^ (word & _MASK64))
    return h >> 1  # manual_seed takes 63 bits


def epoch_generator(seed: int, purpose: str, epoch: int) -> torch.Generator:
    """An independent CPU generator per (purpose, epoch) of the run."""
    return torch.Generator().manual_seed(_mix(seed, _purpose_id(purpose), epoch))


def batch_generator(seed: int, purpose: str, epoch: int, index: int,
                    device="cpu") -> torch.Generator:
    """An independent generator per (purpose, epoch, batch index) on
    ``device``: the on-card synthesizer draws batch ``index`` of an epoch
    from it, so a batch does not depend on the batches before it."""
    return torch.Generator(device=device).manual_seed(
        _mix(seed, _purpose_id(purpose), epoch, index))


def step_generator(parent: torch.Generator) -> torch.Generator:
    """A child generator seeded by one draw of ``parent``."""
    seed = int(torch.randint(0, 2 ** 62, (), dtype=torch.int64, generator=parent))
    return torch.Generator().manual_seed(seed)
