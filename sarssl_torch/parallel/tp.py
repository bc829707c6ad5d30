"""Collectives as autograd functions, the building blocks of the sharded
step (``parallel/steps.py``) and of the layers that run sharded
(``models/common.py``, ``conformer.py``, ``decoder.py``, ``sarssl.py``).

Megatron-style tensor parallelism over the ``model`` group:

  * :func:`copy_to` enters a column-parallel region: identity forward, the
    gradient summed over the group in the backward (each rank's columns give
    only their share of the input's gradient);
  * :func:`reduce_from` leaves a row-parallel one: the partial products
    summed over the group forward, identity backward (every rank holds the
    whole sum, and each passes its gradient on to its own shard).

Over the ``data`` group, :func:`reduce_from` also makes a loss's numerator
global (each rank's backward then gives its rows' share of the gradient,
which the step sums), and :func:`all_reduce` sums BatchNorm's statistics
with a gradient through the sum (forward and backward both summed: a rank's
statistics reach every rank's outputs). A group of one rank runs the
collective all the same.

Sums run in float32 (a bfloat16 partial is cast up first and the sum cast
back). ``torch.distributed.nn.functional`` is deprecated, hence these.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous().clone() if x.dtype != torch.float32 else x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; identity backward."""
    return _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, and its gradient summed backward."""
    return _AllReduce.apply(x, group)


@torch.no_grad()
def summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, outside autograd (metrics, counts)."""
    return _summed(x.detach(), group)


@torch.no_grad()
def gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of a tensor joined along ``dim``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
