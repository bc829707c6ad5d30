"""Host -> device prefetch (port of ``sarssl_tpu/data/prefetch.py``): while
the card runs step N, the next batches are already being copied to it.

A copy from pageable host memory waits for the work queued before it, which
would keep the host from running ahead of the card. So each batch is copied
into its own fresh pinned buffer and sent with ``non_blocking=True`` on a
side stream, ``size`` batches in flight; the compute stream waits on the
copy's event before the batch is used. A pinned buffer is never refilled
while its copy runs: PyTorch's pinned-memory cache holds a freed buffer until
the copy's stream has passed it.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ..utils.device import resolve_device


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    return batch


def device_prefetch(batches: Iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield batches (arrays, tensors, or tuples / dicts of them) as device
    tensors, keeping ``size`` in flight. On the CPU they pass as they are."""
    assert size >= 1, f"prefetch size {size} would drop every batch"
    dev = resolve_device(device)
    if dev.type != "cuda":
        yield from batches
        return
    stream = torch.cuda.Stream(dev)

    def put(batch):
        def one(x):
            t = torch.as_tensor(x)
            if t.device.type == "cuda":
                return t
            pinned = t.pin_memory()
            with torch.cuda.stream(stream):
                return pinned.to(dev, non_blocking=True)
        out = _map(one, batch)
        done = torch.cuda.Event()
        done.record(stream)
        return out, done

    queue = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == size:
            break
    while queue:
        out, done = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(done)
        _map(lambda t: t.record_stream(compute), out)
        yield out
