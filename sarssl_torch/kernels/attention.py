"""Fused rel-pos attention: the CUDA kernels (``csrc/attention.cu``), their
plain PyTorch version and the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/attention.py::fused_attention`` (forward
``_call_fwd``, backward ``_fa_bwd``):

    out = dropout(softmax((qu @ k^T + bias) * scale)) @ v

``qu = q + u_bias`` and ``bias`` (the relative-shifted ``(q + v_bias) P^T``)
are built outside the kernel, so their own gradients flow through autograd.
Attention dropout hashes the flat ``(b, h, i, j)`` index of the probability
tensor with ``kernels/dropout.py``'s counter hash, so the plain version is
exactly the JAX unfused path (``models/conformer.py:110-119``: softmax, then
``fused_dropout``, then PV) and the kernel's mask equals it bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_cuda_status, launches, load_library
from .dropout import dropout_plain, keep_threshold

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32


def attention_plain(qu, k, v, bias, seed: int, scale: float, rate: float):
    """Plain version: f32 scores and softmax, ``p.astype(T)``, hash dropout on
    p, f32-accumulated PV, output in ``qu``'s dtype."""
    s = (torch.matmul(qu.float(), k.float().transpose(-1, -2)) + bias.float()) * scale
    p = torch.softmax(s, dim=-1).to(qu.dtype)
    p = dropout_plain(p, seed, rate)
    return torch.matmul(p.float(), v.float()).to(qu.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("attention")
    lib.attn_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _U, _U,
                             _F, _P]
    lib.attn_fwd.restype = _I
    lib.attn_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _F, _F, _U, _U, _F, _P]
    lib.attn_bwd.restype = _I
    lib.attn_smem_bytes.argtypes = [_I, _I]
    lib.attn_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _check(qu, k, v, bias):
    ts = (qu, k, v, bias)
    if not all(t.is_cuda and t.device == qu.device for t in ts):
        raise ValueError("fused attention takes CUDA tensors on one device")
    if qu.dtype not in _DTYPES or any(t.dtype != qu.dtype for t in ts):
        raise ValueError(f"fused attention takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if qu.ndim != 4 or k.shape != qu.shape or v.shape != qu.shape:
        raise ValueError("qu, k, v must be (B, H, L, D) of one shape")
    B, H, L, D = qu.shape
    if bias.shape != (B, H, L, L):
        raise ValueError(f"bias must be {(B, H, L, L)}, got {tuple(bias.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused attention takes contiguous tensors")
    if B * H * L * L >= 2 ** 32:
        raise ValueError("the dropout index of (B, H, L, L) must fit in uint32")
    lib = _library()
    if lib.attn_smem_bytes(L, D) > _SMEM_LIMIT:
        raise ValueError(f"L={L} needs more shared memory than a block has")
    return lib


def _drop_args(seed, rate):
    """(rate, seed, threshold, 1/(1-rate)); the kernel scales the f32
    probabilities before rounding them to the input type."""
    if rate == 0.0:
        return 0.0, 0, 0, 1.0
    return float(rate), seed, keep_threshold(rate), 1.0 / (1.0 - rate)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_attention_fwd(qu, k, v, bias, seed: int, scale: float, rate: float):
    lib = _check(qu, k, v, bias)
    B, H, L, D = qu.shape
    out = torch.empty_like(qu)
    code = lib.attn_fwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), B, H, L, D, scale,
                        *_drop_args(seed, rate), _stream(qu))
    check_cuda_status(lib, code, "attn_fwd")
    launches[f"attention_fwd_d{D}"] += 1
    return out


def launch_attention_bwd(qu, k, v, bias, g, seed: int, scale: float, rate: float):
    lib = _check(qu, k, v, bias)
    if g.shape != qu.shape or g.dtype != qu.dtype or not g.is_contiguous():
        raise ValueError("g must be a contiguous tensor like qu")
    B, H, L, D = qu.shape
    dqu, dk, dv = (torch.empty_like(qu) for _ in range(3))
    dbias = torch.empty_like(bias)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=qu.device)
    code = lib.attn_bwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), g.data_ptr(), dqu.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), dbias.data_ptr(), stats.data_ptr(), B, H, L, D,
                        scale, *_drop_args(seed, rate), _stream(qu))
    check_cuda_status(lib, code, "attn_bwd")
    launches[f"attention_bwd_d{D}"] += 1
    return dqu, dk, dv, dbias


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qu, k, v, bias, seed, scale, rate):
        ctx.save_for_backward(qu, k, v, bias)
        ctx.args = (seed, scale, rate)
        return launch_attention_fwd(qu, k, v, bias, seed, scale, rate)

    @staticmethod
    def backward(ctx, g):
        qu, k, v, bias = ctx.saved_tensors
        grads = launch_attention_bwd(qu, k, v, bias, g.contiguous(), *ctx.args)
        return (*grads, None, None, None)


def fused_attention(qu, k, v, bias, seed: int, scale: float, rate: float = 0.0):
    """``dropout(softmax((qu k^T + bias) * scale)) v`` for (B, H, L, D) inputs.

    CUDA tensors run the hand-written kernels (forward and backward); CPU
    tensors run :func:`attention_plain`. ``seed`` is a uint32, ignored at
    rate 0.
    """
    if qu.device.type == "cpu":
        return attention_plain(qu, k, v, bias, seed, scale, rate)
    return _FusedAttention.apply(qu, k, v, bias, seed, scale, rate)
