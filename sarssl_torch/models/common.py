"""Shared layers that reproduce flax.linen's semantics in PyTorch.

Parameters are float32; each layer computes in its ``dtype`` (bf16 compute
over f32 parameters, as the JAX package runs). Initialisers follow flax's
defaults (lecun-normal kernels, zero biases) unless a caller asks for
xavier-uniform, and draw from an explicit ``torch.Generator``.

:func:`remat` is flax's ``nn.remat`` for these modules: the region's
activations are recomputed in the backward, with the dropout seeds and the
BatchNorm running stats of the first forward.

Sharded over a mesh (``parallel/steps.py`` sets the attributes): a
row-parallel ``Dense`` sums its partial products over the model group and
adds its bias once after (``reduce_group``); ``BatchNorm`` normalises with
the global batch's statistics (``data_group``); ``Dropout`` hashes the index
its rows have in the global batch (``data_shard``) and, where a caller says
so, the index a model shard's columns have in the whole tensor.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.dropout import hash_dropout
from ..parallel import tp


class SeedReplay:
    """Stands in for a generator inside a rematerialised region: the first
    pass draws each seed from ``generator`` and records it, a recomputation
    reads the recorded seeds in the same order (:func:`remat`)."""

    def __init__(self, generator, seeds: list):
        self.generator, self.seeds, self.pos = generator, seeds, 0

    def draw(self) -> int:
        if self.pos == len(self.seeds):
            self.seeds.append(draw_seed(self.generator))
        self.pos += 1
        return self.seeds[self.pos - 1]


class LaneSeeds:
    """Stands in for a generator inside a vmapped grid step
    (``train/grid.py``): built from an ``(nsites,)`` int64 tensor of uint32
    seeds that ``torch.func.vmap`` batches over the lanes, it hands out the
    next entry at each draw, a 0-d tensor holding each lane's own seed. The
    grid pre-draws a step's seeds, in site order, from each lane's step
    generator, which are the draws a sequential step makes; ``pos`` counts
    the draws of a step."""

    def __init__(self, seeds: torch.Tensor):
        self.seeds, self.pos = seeds, 0

    def draw(self) -> torch.Tensor:
        if self.pos == self.seeds.shape[0]:
            raise RuntimeError(f"the step drew more than the {self.pos} dropout seeds "
                               "pre-drawn for it")
        self.pos += 1
        return self.seeds[self.pos - 1]


def draw_seed(generator):
    """One uint32 dropout seed from a CPU generator (no device sync), or the
    next seed of a :class:`SeedReplay` or a :class:`LaneSeeds` (a batched
    0-d tensor)."""
    if isinstance(generator, (SeedReplay, LaneSeeds)):
        return generator.draw()
    return int(torch.randint(0, 2 ** 32, (), dtype=torch.int64, generator=generator))


def data_seed(seed, data_shard, numel: int):
    """A dropout seed for data shard ``data_shard = (index, count)`` of a
    tensor whose global batch holds ``count`` blocks of ``numel`` elements:
    the shard's rows start at flat index ``index * numel`` of the global
    tensor, and the counter hash reads ``index + seed`` mod 2**32, so that
    offset folds into the seed."""
    index = data_shard[0]
    return seed if index == 0 else (seed + index * numel) % 2 ** 32


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    # flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; the kernel is
    stored as torch's ``(out, in)`` weight."""

    def __init__(self, din: int, dout: int, bias: bool = True, dtype=torch.float32,
                 xavier: bool = False, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dout, din))
        if xavier:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        else:
            lecun_normal_(self.weight, din, generator)
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None
        self.reduce_group = None  # row-parallel: the model group to sum over

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.reduce_group is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)
        y = tp.reduce_from(F.linear(x.to(self.dtype), self.weight.to(self.dtype)),
                           self.reduce_group)
        return y if b is None else y + b


def same_pads(n: int, k: int, s: int):
    """flax's 'SAME' padding of one axis of length ``n`` for a kernel ``k`` at
    stride ``s``: ``ceil(n / s)`` outputs, the odd pad row at the end (torch's
    symmetric ``padding`` would start a strided conv's windows elsewhere)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias over ``(nb, cin, *spatial)`` (1-D or
    2-D), computing in ``dtype``. ``padding``: 'SAME' (flax's, from the
    input's size), 'VALID', or a ``(lo, hi)`` pair per spatial axis. The
    weight is torch's ``(cout, cin, *kernel)``, lecun-normal."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding="SAME",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        nd = len(self.kernel_size)
        self.stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel_size))
        lecun_normal_(self.weight.data, math.prod(self.kernel_size) * cin, generator)

    def forward(self, x):
        if self.padding == "SAME":
            pads = [same_pads(n, k, s) for n, k, s in
                    zip(x.shape[2:], self.kernel_size, self.stride)]
        elif self.padding == "VALID":
            pads = [(0, 0)] * len(self.kernel_size)
        else:
            pads = self.padding
        x = x.to(self.dtype)
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            pads = [(0, 0)] * len(pads)
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(x, self.weight.to(self.dtype), None, self.stride, [lo for lo, _ in pads])


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 (torch's default is 1e-5), statistics
    in f32, output in dtype."""

    eps = 1e-6

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over channel dim 1.

    Training normalises with the biased batch variance and updates
    ``running = 0.9 * running + 0.1 * batch`` with the *biased* variance, as
    flax does (torch's BatchNorm keeps an unbiased running variance).
    Statistics are f32; the output is in ``dtype``. With a ``data_group``
    (a batch sharded over data ranks) the statistics are the global batch's,
    in f32 and summed over the group with their gradient, in two passes as
    ``F.batch_norm`` takes them on one rank: the mean from ``sum x``, then
    the variance from ``sum (x - mean)^2`` (the one-pass ``E[x^2] - mean^2``
    loses the digits that the mean holds against the spread).
    """

    momentum = 0.9  # flax's sense: the weight of the old running value
    eps = 1e-5

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.update_stats = True  # off while remat recomputes the forward
        self.data_group = None

    def forward(self, x, train: bool = False):
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        if self.data_group is not None:
            return self._global(x)
        if self.update_stats:
            self._update(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.dtype)

    @torch.no_grad()
    def _update(self, x):
        dims = [0] + list(range(2, x.ndim))
        var, mean = torch.var_mean(x.detach().float(), dim=dims, correction=0)
        self._update_from(mean, var)

    @torch.no_grad()
    def _update_from(self, mean, var):
        self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
        self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)

    def _global(self, x):
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        n = x.numel() // x.shape[1] * torch.distributed.get_world_size(self.data_group)
        shape = [1, -1] + [1] * (x.ndim - 2)
        mean = tp.all_reduce(xf.sum(dims), self.data_group) / n
        centred = xf - mean.view(shape)
        var = tp.all_reduce((centred * centred).sum(dims), self.data_group) / n
        if self.update_stats:
            self._update_from(mean.detach(), var.detach())
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(self.dtype)


class Dropout(nn.Module):
    """Inverted dropout with the counter-hash mask (``kernels/dropout.py``):
    the Triton kernel on CUDA tensors, the plain version on CPU tensors. One
    seed per call, drawn from the caller's generator.

    ``data_shard = (index, count)``: this rank's rows are block ``index`` of
    ``count`` equal blocks of the global batch (the leading dim); the block's
    offset folds into the seed (:func:`data_seed`). ``index_map``: a model
    shard's place in the whole tensor, ``(row_local, row_total,
    col_offset)`` (``kernels/dropout.py``). So each rank draws its slice of
    the unsharded mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.data_shard = (0, 1)

    def forward(self, x, train: bool = False, generator=None, index_map=None):
        if not train or self.rate == 0.0:
            return x
        numel = x.numel() if index_map is None else x.numel() // index_map[0] * index_map[1]
        seed = data_seed(draw_seed(generator), self.data_shard, numel)
        return hash_dropout(x.contiguous(), seed, self.rate, index_map)


@contextlib.contextmanager
def _stats_frozen(module: nn.Module, frozen: bool):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)] if frozen else []
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class _Remat(torch.autograd.Function):
    """Runs ``run(x)`` without keeping its graph; the backward runs it again
    with autograd on and takes the gradients of ``x`` and of the region's
    parameters (inputs of this function, so they flow back as any input's
    do)."""

    @staticmethod
    def forward(ctx, run, x, *params):
        ctx.run = run
        ctx.save_for_backward(x, *params)
        with torch.no_grad():
            return run(x, False)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        x = x.detach().requires_grad_(need[0])
        with torch.enable_grad():
            y = ctx.run(x, True)
        wrt = [t for t, n in zip([x, *params], need) if n]
        grads = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        return (None, *(next(grads) if n else None for n in need))


def remat(module: nn.Module, fn, x, generator=None):
    """``fn(x, generator)`` (a forward of ``module``) with its activations
    recomputed in the backward instead of kept, as flax's ``nn.remat``.

    A rerun of the forward would draw new dropout seeds from the caller's
    generator (gradients of other masks than the forward's) and update the
    BatchNorm running stats twice. So the region draws through a
    :class:`SeedReplay`: the first pass takes its seeds from ``generator``
    and records them, the recomputation reads them back, and the generator
    ends where a plain forward leaves it; the recomputation updates no
    running stat. Without autograd (eval, ``no_grad``) ``fn`` simply runs.
    (``torch.utils.checkpoint`` keeps the global RNG only, not an explicit
    generator, and imports ``torch._dynamo`` when first called.)"""
    if not torch.is_grad_enabled():
        return fn(x, generator)
    seeds: list = []

    def run(inp, recompute):
        with _stats_frozen(module, recompute):
            return fn(inp, SeedReplay(generator, seeds))

    return _Remat.apply(run, x, *module.parameters())
