"""Each data rank's share of the input (port of
``sarssl_tpu/parallel/hostdata.py``).

In the JAX package a host process reads its slice of the corpus and adds its
rows to one global array. Here a rank reads its rows and keeps them: the
"process" of the data is the rank's data index, not its global rank, so the
``M`` ranks of one data shard read the same rows (a port run at ``DxM`` is a
JAX pod of ``D`` hosts with ``M`` devices each).

  * :func:`shard_for_process`: the strided split of an item list, every
    shard the same length (the remainder dropped), as JAX's;
  * :func:`packed_batches`: a data rank's block of each global batch of a
    packed directory, so that the blocks joined in rank order are the
    one-rank batch;
  * :func:`global_batch_from_local`: a rank's rows on its device;
  * :func:`host_batch_iterator`: a rank's batches onto its device, a few in
    flight (``data/prefetch.py::device_prefetch``).
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import torch

from .mesh import Rows


def shard_for_process(items: Sequence, process_index: int = 0, process_count: int = 1) -> list:
    """Strided slice of ``items`` owned by data rank ``process_index`` of
    ``process_count`` (a mesh's ``data_index`` / ``data_size``; the default
    is one process: the whole list). Every shard holds EXACTLY ``len(items)
    // process_count`` items, so every rank takes as many steps and none
    waits in a collective the others never reach."""
    n_common = len(items) // process_count
    return list(items[process_index::process_count][:n_common])


def packed_batches(pds, batch_size: int, process_index: int = 0, process_count: int = 1,
                   **kw) -> Iterator:
    """Data rank ``process_index``'s rows of each global batch of
    ``batch_size`` rows of a ``PackedDataset`` (``batch_indices(batch_size,
    **kw)``, one permutation shared by every rank): its contiguous block of
    the sorted batch, gathered alone as ``iter_batches`` gathers a batch."""
    rows = Rows(process_index, process_count, torch.device("cpu"))
    for idxs in pds.batch_indices(batch_size, **kw):
        local = rows.local(idxs)
        yield next(pds.iter_batches(len(local), subset=local))


def global_batch_from_local(local_batch, rows: Rows) -> torch.Tensor:
    """This rank's rows (its ``(local_nb, ...)`` block of the global batch)
    as a tensor on its device; every data rank passes the same local_nb."""
    return torch.as_tensor(local_batch).to(rows.device)


def host_batch_iterator(batches: Iterable, rows: Rows, prefetch: int = 2) -> Iterator:
    """A rank's host batches (arrays, or tuples / dicts of them) onto its
    device with ``prefetch`` copies in flight."""
    from ..data.prefetch import device_prefetch

    return device_prefetch(batches, size=prefetch, device=rows.device)
