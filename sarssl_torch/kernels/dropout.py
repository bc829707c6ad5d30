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
"""
from __future__ import annotations

import functools

import torch

from ._build import import_triton, launches

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B
_BLOCK = 4096


def keep_threshold(rate: float) -> int:
    """``np.uint32(min(max(rate, 0), 0.9999999) * 2**32)`` as in JAX."""
    return int(min(max(rate, 0.0), 0.9999999) * 4294967296.0)


def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """``1/(1-rate)`` rounded to ``dtype``, as ``jnp.asarray(.., x.dtype)``."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # (x * c) mod 2**32 in int64 without overflow: split c into 16-bit halves
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep_mask(n: int, seed: int, rate: float, device=None) -> torch.Tensor:
    """Plain version of the mask: ``(n,)`` bool, int64 arithmetic masked to
    32 bits."""
    x = (torch.arange(n, dtype=torch.int64, device=device) + seed) & _M32
    x = _mul32(x ^ (x >> 16), _C1)
    x = _mul32(x ^ (x >> 15), _C2)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def dropout_plain(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version: ``where(keep, x * scale, 0)``."""
    if rate == 0.0:
        return x
    keep = hash_keep_mask(x.numel(), seed, rate, x.device).reshape(x.shape)
    scale = torch.tensor(keep_scale(rate, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    triton, tl = import_triton()

    @triton.jit
    def hash_dropout_kernel(x_ptr, out_ptr, n, seed_bits, thresh_bits, scale,
                            BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inb = offs < n
        x = tl.load(x_ptr + offs, mask=inb, other=0.0)
        seed = seed_bits.to(tl.uint32, bitcast=True)
        thresh = thresh_bits.to(tl.uint32, bitcast=True)
        h = offs.to(tl.uint32) + seed
        h = (h ^ (h >> 16)) * tl.full((BLOCK,), 0x7FEB352D, tl.uint32)
        h = (h ^ (h >> 15)) * tl.full((BLOCK,), 0x846CA68B, tl.uint32)
        h = h ^ (h >> 16)
        y = tl.where(h >= thresh, x.to(tl.float32) * scale, 0.0)
        tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=inb)

    return triton, hash_dropout_kernel


def _as_int32(u: int) -> int:
    """uint32 bits as a signed int32 value (Triton types int args by range)."""
    return u - (1 << 32) if u >= (1 << 31) else u


def launch_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Launch the Triton kernel on a contiguous CUDA tensor."""
    if not x.is_cuda:
        raise ValueError("launch_dropout takes a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("launch_dropout takes a contiguous tensor")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError("launch_dropout indexes elements with int32")
    if not 0 <= seed < 2 ** 32:
        raise ValueError("seed must be a uint32")
    triton, kernel = _triton_kernel()
    out = torch.empty_like(x)
    grid = (triton.cdiv(n, _BLOCK),)
    with torch.cuda.device(x.device):
        kernel[grid](x, out, n, _as_int32(seed), _as_int32(keep_threshold(rate)),
                     keep_scale(rate, x.dtype), BLOCK=_BLOCK, num_warps=8)
    launches["hash_dropout"] += 1
    return out


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return launch_dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        # same seed -> same mask; d(x*scale*keep)/dx = scale*keep
        return launch_dropout(g.contiguous(), ctx.seed, ctx.rate), None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout with the counter-hash mask of ``seed``.

    CUDA tensors go through the Triton kernel; CPU tensors through
    :func:`dropout_plain`.
    """
    if rate == 0.0:
        return x
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate)
    return _HashDropout.apply(x, seed, rate)
