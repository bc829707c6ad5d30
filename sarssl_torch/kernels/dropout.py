"""Counter-hash inverted dropout: a Triton kernel and its plain version.

Replaces the Pallas kernel ``sarssl_tpu/kernels/dropout.py::_apply``
(``_mask_kernel``, via ``tpu_dropout`` and its VJP ``_dropout_bwd``). The mask
is not the TPU's hardware PRNG, which has no counterpart here, but the
counter hash of ``fused_dropout`` (``_hash_mask``, dropout.py:105-122): a
murmur3 finalizer over ``flat_index + seed`` in uint32 arithmetic, kept where
``hash >= uint32(rate * 2**32)``. Given the same uint32 seed the mask equals
the JAX one bit for bit. The backward applies the same kernel to the gradient
with the same seed, so no mask tensor is ever stored.

Bound on an H100: one read and one write of the tensor, about 10 integer
operations per element; at 3.35 TB/s the bytes dominate. The kernel is one
elementwise pass in blocks of 4096 contiguous elements with masked loads,
which is all a bandwidth-bound pass needs.

Under ``torch.func.vmap`` (the vmapped downstream grid, ``train/grid.py``)
every lane has its own seed: ``launch_dropout_lanes`` hashes each lane's
flat index with that lane's seed, as ``jax.vmap`` of ``fused_dropout`` does.
Its grid is (blocks of a lane, lanes of a run, runs of lanes): a grid's
second and third dimensions hold 65535 blocks each, so one launch takes up
to 65535**2 lanes, in runs of equal length; the seed is one load a program
and no element divides by the lane size. A lane shorter than a block would
leave most of each program idle, so those lanes go to
``hash_dropout_short_lanes_kernel``: a
program takes a block of the flat ``(N * lane_numel)`` tensor, finds each
element's lane and its index in the lane (one 32-bit division an element,
:func:`short_lane_index`), gathers the lanes' seeds and hashes ``j +
seeds[lane]`` as the lanes kernel does, so the mask is the same bit for bit.

``_HashDropout`` (one int seed) carries a ``vmap`` rule that hands the lanes
to ``_HashDropoutLanes``, whose backward is the same lane-seeded kernel.
Launches count as ``hash_dropout`` and ``hash_dropout_lanes`` (a
short-lane launch also as ``hash_dropout_lanes_short``).

Any tensor the JAX hash takes runs: fewer than 2**32 elements (a lane of
fewer than 2**32 under vmap), since JAX indexes with a uint32 iota
(``sarssl_tpu/kernels/dropout.py:117``) and the hash reads the index's 32
bits. Each program forms its block's first offset in int64 for the
addresses and in uint32 for the hash, and its elements' offsets from it in
32 bits, so all hash and index arithmetic stays 32-bit.
:func:`dropout_refusal` says what is refused.

A shard of a tensor (``parallel/``: a tensor-parallel rank's heads or
feed-forward units) hashes the flat index its elements have in the whole
tensor, so every rank draws its slice of the unsharded mask. The shard's
``index_map = (row_local, row_total, col_offset)`` says where its elements
lie: local element ``i`` is global element ``(i // row_local) * row_total +
col_offset + i % row_local`` (rows of ``row_total`` elements, of which the
shard holds ``row_local`` from ``col_offset`` on). A data shard's rows are a
contiguous block of the whole tensor, so its offset is folded into the seed
by the caller (``models/common.py``). ``None`` (or ``row_local ==
row_total``, offset 0) is the unsharded index.
"""
from __future__ import annotations

import functools

import torch

from ._build import GRID_YZ, import_triton, launches

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B
BLOCK = 4096  # elements a program of the Triton kernels


def keep_threshold(rate: float) -> int:
    """``np.uint32(min(max(rate, 0), 0.9999999) * 2**32)`` as in JAX."""
    return int(min(max(rate, 0.0), 0.9999999) * 4294967296.0)


def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """``1/(1-rate)`` rounded to ``dtype``, as ``jnp.asarray(.., x.dtype)``."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def dropout_refusal(n: int):
    """Why the kernels refuse ``n`` elements (a tensor, or a lane), or None:
    the hash takes a uint32 index, as JAX's uint32 iota gives it."""
    if n >= 2 ** 32:
        return (f"{n} elements: the dropout hash indexes elements with a uint32, as JAX's "
                f"fused_dropout does (a uint32 iota, sarssl_tpu/kernels/dropout.py:117)")
    return None


def lanes_grid(lane_numel: int, nlane: int) -> tuple:
    """The lane-seeded kernel's grid over ``nlane`` lanes of ``lane_numel``
    elements: (blocks of a lane, lanes of a run, runs of lanes), the program
    at ``(i, y, z)`` taking block i of lane ``z * grid[1] + y`` (none past
    the last lane). A grid's second and third dimensions hold ``GRID_YZ``
    blocks each; the runs are of equal length, so fewer than one run of
    programs go idle."""
    if nlane > GRID_YZ ** 2:
        raise ValueError(f"the lane-seeded dropout takes up to {GRID_YZ}**2 lanes, got {nlane}")
    runs = -(-nlane // GRID_YZ)
    return -(-lane_numel // BLOCK), -(-nlane // runs), runs


def short_lane_index(nlane: int, lane_numel: int, block: int = BLOCK) -> tuple:
    """``(lane, j)`` of every element of the flat ``(nlane * lane_numel)``
    tensor, int64, in flat order, as the short-lane kernel's programs find
    them: program ``i`` takes elements ``i * block .. + block``; its first
    element's lane ``lane0 = base // lane_numel`` and the remainder ``r0`` in
    int64, then for each element ``t = r0 + k`` (below ``lane_numel +
    block``, 32 bits) ``lane = lane0 + t // lane_numel`` and ``j = t %
    lane_numel``."""
    n = nlane * lane_numel
    base = torch.arange(0, n, block, dtype=torch.int64)
    lane0 = base // lane_numel
    r0 = base - lane0 * lane_numel
    t = r0[:, None] + torch.arange(block, dtype=torch.int64)[None]
    dl = t // lane_numel
    inb = (base[:, None] + torch.arange(block, dtype=torch.int64)[None]) < n
    return (lane0[:, None] + dl)[inb], (t - dl * lane_numel)[inb]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2**32 in int64 without overflow: split c into 16-bit halves
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _check_index_map(n: int, index_map) -> None:
    row_local, row_total, col_offset = index_map
    if not (0 < row_local <= row_total and 0 <= col_offset <= row_total - row_local):
        raise ValueError(f"index map {index_map}: a row of row_local elements from "
                         "col_offset on must lie inside a row of row_total")
    if n % row_local:
        raise ValueError(f"index map {index_map}: {n} elements are not whole rows")


def _hash_keep(x: torch.Tensor, rate: float) -> torch.Tensor:
    """keep for the hash inputs ``x`` (int64 holding ``index + seed``)."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), _C1)
    x = _mul32(x ^ (x >> 15), _C2)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def short_lanes_keep_mask(seeds: torch.Tensor, lane_numel: int, rate: float) -> torch.Tensor:
    """Plain version of the short-lane kernel's mask, ``(N, lane_numel)``
    bool: ``hash(j + seeds[lane])`` over :func:`short_lane_index`'s map;
    ``seeds`` (N,) integers whose low 32 bits are the lanes' seeds."""
    lane, j = short_lane_index(seeds.shape[0], lane_numel)
    s = seeds.to(torch.int64).cpu() & _M32
    return _hash_keep(j + s[lane], rate).reshape(seeds.shape[0], lane_numel)


def hash_keep_mask(n: int, seed, rate: float, device=None, index_map=None) -> torch.Tensor:
    """Plain version of the mask: ``(n,)`` bool, int64 arithmetic masked to
    32 bits. ``seed`` is a uint32 int, or a 0-d int64 tensor: under
    ``torch.func.vmap`` a lane's own seed, so each lane hashes its lane-local
    index with its seed, as ``jax.vmap`` of ``fused_dropout`` does.
    ``index_map``: a shard's ``(row_local, row_total, col_offset)`` (module
    note), None for the unsharded index."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    if index_map is not None:
        _check_index_map(n, index_map)
        row_local, row_total, col_offset = index_map
        i = (i // row_local) * row_total + col_offset + i % row_local
    return _hash_keep(i + seed, rate)


def dropout_plain(x: torch.Tensor, seed, rate: float, index_map=None) -> torch.Tensor:
    """Plain PyTorch version: ``where(keep, x * scale, 0)``; ``seed`` and
    ``index_map`` as in :func:`hash_keep_mask`. Under ``torch.func.vmap``
    with a batched seed it is the plain version of
    :func:`launch_dropout_lanes`."""
    if rate == 0.0:
        return x
    keep = hash_keep_mask(x.numel(), seed, rate, x.device, index_map).reshape(x.shape)
    scale = torch.tensor(keep_scale(rate, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    triton, tl = import_triton()

    # row_local never a constant (Triton makes an int argument of 1 one),
    # so that it casts to uint32
    @triton.jit(do_not_specialize=["row_local"])
    def hash_dropout_kernel(x_ptr, out_ptr, n, seed_bits, thresh_bits, scale, row_local,
                            row_total_bits, col_offset_bits, BLOCK: tl.constexpr,
                            MAPPED: tl.constexpr):
        # the block's first element in int64 for the addresses (n may pass
        # 2**31) and in uint32 for the hash (n < 2**32), its elements'
        # offsets k from it in int32
        base = tl.program_id(0).to(tl.int64) * BLOCK
        b32 = base.to(tl.uint32)
        k = tl.arange(0, BLOCK)
        inb = k < tl.minimum(n - base, BLOCK).to(tl.int32)
        x = tl.load(x_ptr + base + k, mask=inb, other=0.0)
        seed = seed_bits.to(tl.uint32, bitcast=True)
        thresh = thresh_bits.to(tl.uint32, bitcast=True)
        if MAPPED:
            # a shard's element: its flat index in the whole tensor, mod
            # 2**32, all in uint32: the block's first row and column, then
            # each element's. The column plus k stays below 2**32, as a row
            # of more than 2**32 - BLOCK elements is the whole tensor, whose
            # offsets are below n
            rl = row_local.to(tl.uint32)
            row0 = b32 // rl
            t = (b32 - row0 * rl) + k.to(tl.uint32)
            dr = t // rl
            h = ((row0 + dr) * row_total_bits.to(tl.uint32, bitcast=True)
                 + col_offset_bits.to(tl.uint32, bitcast=True) + (t - dr * rl) + seed)
        else:
            h = b32 + k.to(tl.uint32) + seed
        h = (h ^ (h >> 16)) * tl.full((BLOCK,), 0x7FEB352D, tl.uint32)
        h = (h ^ (h >> 15)) * tl.full((BLOCK,), 0x846CA68B, tl.uint32)
        h = h ^ (h >> 16)
        y = tl.where(h >= thresh, x.to(tl.float32) * scale, 0.0)
        tl.store(out_ptr + base + k, y.to(out_ptr.dtype.element_ty), mask=inb)

    return triton, hash_dropout_kernel


@functools.lru_cache(maxsize=None)
def _triton_lanes_kernel():
    triton, tl = import_triton()

    @triton.jit
    def hash_dropout_lanes_kernel(x_ptr, out_ptr, seed_ptr, nlane, lanes_y, lane_numel,
                                  thresh_bits, scale, BLOCK: tl.constexpr):
        # grid (blocks of a lane, lanes_y lanes of a run, runs): the lane is
        # the program's second and third index, so no element divides; the
        # block's first offset j0 in its lane, and the lane's base, in int64
        # (N * lane_numel and lane_numel may pass 2**31), k from it in int32
        lane = tl.program_id(2).to(tl.int64) * lanes_y + tl.program_id(1)
        j0 = tl.program_id(0).to(tl.int64) * BLOCK
        k = tl.arange(0, BLOCK)
        inb = (k < tl.minimum(lane_numel - j0, BLOCK).to(tl.int32)) & (lane < nlane)
        base = lane * lane_numel + j0
        x = tl.load(x_ptr + base + k, mask=inb, other=0.0)
        # the lane's seed: the low 32 bits of its int64 entry, on the device
        seed = tl.load(seed_ptr + tl.minimum(lane, nlane - 1)).to(tl.uint32)
        thresh = thresh_bits.to(tl.uint32, bitcast=True)
        h = j0.to(tl.uint32) + k.to(tl.uint32) + seed
        h = (h ^ (h >> 16)) * tl.full((BLOCK,), 0x7FEB352D, tl.uint32)
        h = (h ^ (h >> 15)) * tl.full((BLOCK,), 0x846CA68B, tl.uint32)
        h = h ^ (h >> 16)
        y = tl.where(h >= thresh, x.to(tl.float32) * scale, 0.0)
        tl.store(out_ptr + base + k, y.to(out_ptr.dtype.element_ty), mask=inb)

    return triton, hash_dropout_lanes_kernel


@functools.lru_cache(maxsize=None)
def _triton_short_lanes_kernel():
    triton, tl = import_triton()

    # lane_numel never a constant (Triton makes an int argument of 1 one)
    @triton.jit(do_not_specialize=["lane_numel"])
    def hash_dropout_short_lanes_kernel(x_ptr, out_ptr, seed_ptr, n, lane_numel, thresh_bits,
                                        scale, BLOCK: tl.constexpr):
        # lanes shorter than BLOCK: a block of the flat (nlane * lane_numel)
        # tensor a program. Its first element's offset, lane and place in
        # that lane in int64 (n may pass 2**31); each element's t = r0 + k
        # below lane_numel + BLOCK, so its lane step and index in 32 bits
        base = tl.program_id(0).to(tl.int64) * BLOCK
        k = tl.arange(0, BLOCK)
        inb = k < tl.minimum(n - base, BLOCK).to(tl.int32)
        ln = lane_numel.to(tl.int64)
        lane0 = base // ln
        t = (base - lane0 * ln).to(tl.int32) + k
        ln32 = lane_numel.to(tl.int32)
        dl = t // ln32
        j = t - dl * ln32
        x = tl.load(x_ptr + base + k, mask=inb, other=0.0)
        # each element's lane seed: the low 32 bits of its int64 entry
        seed = tl.load(seed_ptr + (lane0 + dl), mask=inb, other=0).to(tl.uint32)
        thresh = thresh_bits.to(tl.uint32, bitcast=True)
        h = j.to(tl.uint32) + seed
        h = (h ^ (h >> 16)) * tl.full((BLOCK,), 0x7FEB352D, tl.uint32)
        h = (h ^ (h >> 15)) * tl.full((BLOCK,), 0x846CA68B, tl.uint32)
        h = h ^ (h >> 16)
        y = tl.where(h >= thresh, x.to(tl.float32) * scale, 0.0)
        tl.store(out_ptr + base + k, y.to(out_ptr.dtype.element_ty), mask=inb)

    return triton, hash_dropout_short_lanes_kernel


def _as_int32(u: int) -> int:
    """uint32 bits as a signed int32 value (Triton types int args by range)."""
    return u - (1 << 32) if u >= (1 << 31) else u


def _check_input(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


def launch_dropout(x: torch.Tensor, seed: int, rate: float, index_map=None) -> torch.Tensor:
    """Launch the Triton kernel on a contiguous CUDA tensor; ``index_map`` as
    in :func:`hash_keep_mask`."""
    n = x.numel()
    refusal = dropout_refusal(n)
    if refusal:
        raise ValueError(f"launch_dropout: {refusal}")
    _check_input(x, "launch_dropout")
    if not 0 <= seed < 2 ** 32:
        raise ValueError("seed must be a uint32")
    if index_map is not None:
        _check_index_map(n, index_map)
    # a whole row (row_local == row_total) is the unsharded index
    mapped = index_map is not None and index_map[0] != index_map[1]
    row_local, row_total, col_offset = index_map if mapped else (1, 1, 0)
    if row_total >= 2 ** 32:
        raise ValueError("the index map's row_total must be a uint32")
    triton, kernel = _triton_kernel()
    out = torch.empty_like(x)
    grid = (triton.cdiv(n, BLOCK),)
    with torch.cuda.device(x.device):
        kernel[grid](x, out, n, _as_int32(seed), _as_int32(keep_threshold(rate)),
                     keep_scale(rate, x.dtype), row_local, _as_int32(row_total),
                     _as_int32(col_offset), BLOCK=BLOCK, MAPPED=mapped, num_warps=8)
    launches["hash_dropout"] += 1
    return out


def launch_dropout_lanes(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Launch the lane-seeded Triton kernel on a contiguous CUDA tensor
    ``(N, ...)``: ``out[l, j] = keep(hash(j + seeds[l])) ? x[l, j] * scale
    : 0`` over each lane's flat index j, as ``jax.vmap`` of ``fused_dropout``
    computes it. ``seeds``: ``(N,)`` integers whose low 32 bits are the
    lanes' uint32 seeds (int64 in ``[0, 2**32)``, or their int32 / uint32
    bits), read on the device."""
    if x.ndim < 1 or seeds.shape != (x.shape[0],):
        raise ValueError(f"seeds {tuple(seeds.shape)} must hold one seed a lane of "
                         f"{tuple(x.shape)}")
    if seeds.dtype.is_floating_point or seeds.dtype == torch.bool:
        raise ValueError(f"seeds must be integers, not {seeds.dtype}")
    nlane = x.shape[0]
    lane_numel = x[0].numel() if nlane else 0
    refusal = dropout_refusal(lane_numel)
    if refusal:
        raise ValueError(f"launch_dropout_lanes: a lane of {refusal}")
    _check_input(x, "launch_dropout_lanes")
    out = torch.empty_like(x)
    if nlane == 0 or lane_numel == 0:
        return out
    seeds = seeds.to(device=x.device, dtype=torch.int64).contiguous()
    grid = lanes_grid(lane_numel, nlane)  # also refuses past GRID_YZ**2 lanes
    thresh, scale = _as_int32(keep_threshold(rate)), keep_scale(rate, x.dtype)
    if lane_numel < BLOCK:
        triton, kernel = _triton_short_lanes_kernel()
        n = nlane * lane_numel
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(n, BLOCK),)](x, out, seeds, n, lane_numel, thresh, scale,
                                              BLOCK=BLOCK, num_warps=8)
        launches["hash_dropout_lanes_short"] += 1
    else:
        _, kernel = _triton_lanes_kernel()
        with torch.cuda.device(x.device):
            kernel[grid](x, out, seeds, nlane, grid[1], lane_numel, thresh, scale,
                         BLOCK=BLOCK, num_warps=8)
    launches["hash_dropout_lanes"] += 1
    return out


def _launch(x: torch.Tensor, seed, rate: float, index_map=None) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):  # a 0-d seed tensor outside vmap: one lane
        if index_map is not None:
            raise ValueError("a lane-seeded dropout takes no index map")
        return launch_dropout_lanes(x.reshape(1, *x.shape), seed.reshape(1), rate)[0]
    if index_map is None:
        return launch_dropout(x, seed, rate)
    return launch_dropout(x, seed, rate, index_map)


class _HashDropoutLanes(torch.autograd.Function):
    """Dropout of ``(N, ...)`` lanes with one seed a lane; the backward
    applies the same lane-seeded kernel to the gradient."""

    @staticmethod
    def forward(x, seeds, rate):
        return launch_dropout_lanes(x, seeds, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, seeds, ctx.rate = inputs
        ctx.save_for_backward(seeds)

    @staticmethod
    def backward(ctx, g):
        (seeds,) = ctx.saved_tensors
        return launch_dropout_lanes(g.contiguous(), seeds, ctx.rate), None, None


class _HashDropout(torch.autograd.Function):
    """Dropout with one uint32 seed (a Python int) and an optional index map.
    Under ``torch.func.vmap`` its ``vmap`` rule runs the lanes through
    :class:`_HashDropoutLanes`, each with its own seed (a batched seed
    tensor) or all with one (an int)."""

    @staticmethod
    def forward(x, seed, rate, index_map=None):
        return _launch(x, seed, rate, index_map)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, seed, ctx.rate, *index_map = inputs
        ctx.index_map = index_map[0] if index_map else None
        ctx.n_inputs = len(inputs)
        if isinstance(seed, torch.Tensor):
            ctx.save_for_backward(seed)
            ctx.seed = None
        else:
            ctx.seed = seed

    @staticmethod
    def backward(ctx, g):
        # same seed -> same mask; d(x*scale*keep)/dx = scale*keep
        seed = ctx.saved_tensors[0] if ctx.seed is None else ctx.seed
        grad = _launch(g.contiguous(), seed, ctx.rate, ctx.index_map)
        return (grad,) + (None,) * (ctx.n_inputs - 1)

    @staticmethod
    def vmap(info, in_dims, x, seed, rate, index_map=None):
        if index_map is not None:
            raise ValueError("the vmapped (lane-seeded) dropout takes no index map")
        x_dim, seed_dim = in_dims[:2]
        n = info.batch_size
        # the lanes' physical layout: batch dim first, each lane contiguous
        x = (x.movedim(x_dim, 0) if x_dim is not None else x.expand(n, *x.shape)).contiguous()
        if not isinstance(seed, torch.Tensor):
            seeds = torch.full((n,), seed, dtype=torch.int64, device=x.device)
        elif seed_dim is None:
            seeds = seed.reshape(1).expand(n)
        else:
            seeds = seed.movedim(seed_dim, 0).reshape(n)
        return _HashDropoutLanes.apply(x, seeds, rate), 0


def hash_dropout(x: torch.Tensor, seed, rate: float, index_map=None) -> torch.Tensor:
    """Inverted dropout with the counter-hash mask of ``seed`` (a uint32 int,
    or under ``torch.func.vmap`` a batched 0-d int64 tensor: one seed a
    lane); ``index_map``: a shard's ``(row_local, row_total, col_offset)``
    (module note), None for the unsharded index.

    CUDA tensors go through the Triton kernels (the lane-seeded one under
    vmap); CPU tensors through :func:`dropout_plain`.
    """
    if rate == 0.0:
        return x
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, index_map)
    return _HashDropout.apply(x, seed, rate, index_map)
