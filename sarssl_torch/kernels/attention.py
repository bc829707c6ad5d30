"""Fused rel-pos attention: the CUDA kernels, their plain PyTorch version and
the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/attention.py::fused_attention`` (forward
``_call_fwd``, backward ``_fa_bwd``):

    out = dropout(softmax((qu @ k^T + bias) * scale)) @ v

``qu = q + u_bias`` and ``bias`` (the relative-shifted ``(q + v_bias) P^T``)
are built outside the kernel, so their own gradients flow through autograd.
Attention dropout hashes the flat ``(b, h, i, j)`` index of the probability
tensor with ``kernels/dropout.py``'s counter hash, so the plain version is
exactly the JAX unfused path (``models/conformer.py:110-119``: softmax, then
``fused_dropout``, then PV) and the kernel's mask equals it bit for bit. A
tensor-parallel rank holds heads ``head_offset .. head_offset + H`` of
``heads_total``: it hashes the index its probabilities have in the whole
``(B, heads_total, L, L)`` tensor, ``((b * heads_total + head_offset + h) * L
+ i) * L + j``, so its mask is the head slice of the unsharded one.

Three sets of kernels, chosen by dtype and head dim (:func:`attention_route`):

* ``"tc"``, ``csrc/attention_mma.cu``: bfloat16 at head dim 32, 64 or 128
  and any sequence length. Tensor cores (``mma.sync``), ``cp.async``
  pipelines; the forward also returns the rows' log-sum-exp, which the
  ``autograd.Function`` saves with ``out`` for the backward. Each kernel has
  an instance for whole 64-row tiles (L a multiple of 64: the flagship's
  shapes) and one that masks the last tile and reads the bias rows at any
  alignment (the CLS token's L = 257 takes it; ``single_ch_each_patch``'s
  L = 512 at D = 32 the first).
* ``"tf32x3"``, ``csrc/attention_f32_mma.cu``: float32 at head dim 32, 64 or
  128 and any L, with the same structure, on the tensor cores as three TF32
  products per product (each operand split into a TF32 high and low part),
  which hold the float32 tolerance of 1e-4 that one TF32 product misses.
* ``"fma"``, ``csrc/attention.cu``: head dim 16 at either dtype, as scalar
  f32 FMAs. A block keeps whole score rows in shared memory: 64 query rows
  where they fit, 32 where they do not (:func:`fma_row_block`), so every L up
  to 704 runs at every head dim; a longer one raises.

For a CUDA tensor the wrapper launches the set it names here or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_cuda_status, launches, load_library
from .dropout import dropout_plain, keep_threshold

HEAD_DIMS = (16, 32, 64, 128)
MMA_HEAD_DIMS = (32, 64, 128)  # head dims of the tensor-core kernels (either dtype)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32


def _heads(H: int, heads_total, head_offset: int):
    """``(heads_total, head_offset)`` of a launch over H heads (None: H)."""
    heads_total = H if heads_total is None else heads_total
    if not 0 <= head_offset <= heads_total - H:
        raise ValueError(f"heads {head_offset}..{head_offset + H} do not lie in "
                         f"{heads_total} heads")
    return heads_total, head_offset


def attention_plain(qu, k, v, bias, seed: int, scale: float, rate: float,
                    heads_total=None, head_offset: int = 0):
    """Plain version: f32 scores and softmax, ``p.astype(T)``, hash dropout on
    p (at the heads' place in ``heads_total``), f32-accumulated PV, output in
    ``qu``'s dtype."""
    B, H, L, _ = qu.shape
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    s = (torch.matmul(qu.float(), k.float().transpose(-1, -2)) + bias.float()) * scale
    p = torch.softmax(s, dim=-1).to(qu.dtype)
    p = dropout_plain(p, seed, rate, (H * L * L, heads_total * L * L, head_offset * L * L))
    return torch.matmul(p.float(), v.float()).to(qu.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("attention")
    lib.attn_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _U, _U,
                             _F, _I, _I, _P]
    lib.attn_fwd.restype = _I
    lib.attn_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_bwd.restype = _I
    lib.attn_smem_bytes.argtypes = [_I, _I, _I]
    lib.attn_smem_bytes.restype = _I
    lib.attn_row_block.argtypes = [_I, _I, _I]
    lib.attn_row_block.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


_FMA_PASSES = {"fwd": 0, "bwd": 1}


def fma_smem_bytes(kind: str, L: int, D: int) -> int:
    """Dynamic shared memory a block of the FMA forward (``kind="fwd"``) or
    backward (``"bwd"``, the larger of its two kernels) takes at (L, D)."""
    return _library().attn_smem_bytes(L, D, _FMA_PASSES[kind])


def fma_row_block(kind: str, L: int, D: int) -> int:
    """Query rows a block of the FMA forward or backward row pass takes at
    (L, D): 64, or 32 where 64 rows of scores do not fit."""
    return _library().attn_row_block(L, D, _FMA_PASSES[kind])


def _check_fma_smem(kind: str, L: int, D: int) -> None:
    need = fma_smem_bytes(kind, L, D)
    if need > _SMEM_LIMIT:
        raise ValueError(f"the FMA attention {kind} at L={L}, D={D} needs {need} bytes "
                         f"of shared memory, more than a block has ({_SMEM_LIMIT})")


@functools.lru_cache(maxsize=None)
def _library_mma():
    lib = load_library("attention_mma")
    lib.attn_mma_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_fwd.restype = _I
    lib.attn_mma_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_mma_bwd.restype = _I
    lib.attn_mma_smem_bytes.argtypes = [_I, _I, _I]
    lib.attn_mma_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def mma_smem_bytes(kernel: str, D: int, exact: bool = True) -> int:
    """Dynamic shared memory a block of a tensor-core kernel takes, in its
    instance for whole tiles (``exact``) or for any L."""
    which = {"attn_fwd_mma": 0, "attn_bwd_mma": 1, "attn_dqu_mma": 2, "attn_delta": None}[kernel]
    return 0 if which is None else _library_mma().attn_mma_smem_bytes(D, which, int(exact))


@functools.lru_cache(maxsize=None)
def _library_tf32():
    lib = load_library("attention_f32_mma")
    lib.attn_tf32_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_fwd.restype = _I
    lib.attn_tf32_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_F, _F, _U, _U, _F, _I, _I, _P]
    lib.attn_tf32_bwd.restype = _I
    lib.attn_tf32_smem_bytes.argtypes = [_I, _I]
    lib.attn_tf32_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def tf32_smem_bytes(kernel: str, D: int) -> int:
    """Dynamic shared memory a block of a 3xTF32 kernel takes (either
    instance)."""
    which = {"attn_fwd_tf32": 0, "attn_bwd_tf32": 1, "attn_dqu_tf32": 2,
             "attn_delta_f32": None}[kernel]
    return 0 if which is None else _library_tf32().attn_tf32_smem_bytes(D, which)


def attention_route(dtype: torch.dtype, L: int, D: int) -> str:
    """The set of kernels ``fused_attention`` runs for CUDA tensors of this
    dtype, sequence length and head dim (module note): ``"tc"``
    (``attention_mma.cu``, bfloat16 at D = 32 / 64 / 128), ``"tf32x3"``
    (``attention_f32_mma.cu``, float32 at those D) or ``"fma"``
    (``attention.cu``, D = 16). Every L runs on the first two, so only dtype
    and head dim decide."""
    if D not in MMA_HEAD_DIMS:
        return "fma"
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def _check(qu, k, v, bias, heads_total=None):
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
    heads_total, _ = _heads(H, heads_total, 0)
    if B * heads_total * L * L >= 2 ** 32:
        raise ValueError("the dropout index of (B, heads_total, L, L) must fit in uint32")
    if B * H > 65535:
        raise ValueError("B * H must fit the launch grid's second dimension")


def _check_like_qu(t, qu, name):
    if t.shape != qu.shape or t.dtype != qu.dtype or t.device != qu.device:
        raise ValueError(f"{name} must be a tensor like qu")


def _drop_args(seed, rate, H, heads_total, head_offset):
    """(rate, seed, threshold, 1/(1-rate), heads_total, head_offset); the
    kernel scales the f32 probabilities before rounding them to the input
    type."""
    heads_total, head_offset = _heads(H, heads_total, head_offset)
    if rate == 0.0:
        return 0.0, 0, 0, 1.0, heads_total, head_offset
    return float(rate), seed, keep_threshold(rate), 1.0 / (1.0 - rate), heads_total, head_offset


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows_addressable(t) -> bool:
    """Whether the tensor-core kernels can address a (B, H, L, D) tensor's
    rows through its strides: contiguous, 16-byte aligned rows."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and not any(s * t.element_size() % 16 for s in t.stride()[:3]))


def _row_strides(t):
    """Element strides over (b, h, l), as the C entries take them."""
    if not _rows_addressable(t):
        raise ValueError("rows must be contiguous and 16-byte aligned")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


# ---------------------------------------------------------------------------
# scalar-FMA kernels (csrc/attention.cu)
# ---------------------------------------------------------------------------
def launch_attention_fwd_fma(qu, k, v, bias, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    _check(qu, k, v, bias, heads_total)
    lib = _library()
    B, H, L, D = qu.shape
    _check_fma_smem("fwd", L, D)
    out = torch.empty_like(qu)
    code = lib.attn_fwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), B, H, L, D, scale,
                        *_drop_args(seed, rate, H, heads_total, head_offset), _stream(qu))
    check_cuda_status(lib, code, "attn_fwd")
    launches[f"attention_fwd_d{D}"] += 1
    return out


def launch_attention_bwd_fma(qu, k, v, bias, g, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    _check(qu, k, v, bias, heads_total)
    _check_like_qu(g, qu, "g")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    lib = _library()
    B, H, L, D = qu.shape
    _check_fma_smem("bwd", L, D)
    dqu, dk, dv = (torch.empty_like(qu) for _ in range(3))
    dbias = torch.empty_like(bias)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=qu.device)
    code = lib.attn_bwd(_DTYPES[qu.dtype], qu.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), g.data_ptr(), dqu.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), dbias.data_ptr(), stats.data_ptr(), B, H, L, D,
                        scale, *_drop_args(seed, rate, H, heads_total, head_offset),
                        _stream(qu))
    check_cuda_status(lib, code, "attn_bwd")
    launches[f"attention_bwd_d{D}"] += 1
    return dqu, dk, dv, dbias


# ---------------------------------------------------------------------------
# tensor-core kernels (csrc/attention_mma.cu: bf16; csrc/attention_f32_mma.cu:
# f32 as 3xTF32), one calling convention
# ---------------------------------------------------------------------------
def _check_mma(qu, k, v, bias, heads_total, route):
    _check(qu, k, v, bias, heads_total)
    B, H, L, D = qu.shape
    if attention_route(qu.dtype, L, D) != route:
        want = "bfloat16" if route == "tc" else "float32"
        raise ValueError(f"the {route} kernels take {want} and head dim in "
                         f"{MMA_HEAD_DIMS}, got {qu.dtype}, D={D}")
    if any(t.data_ptr() % 16 for t in (qu, k, v)):
        raise ValueError("the tensor-core kernels read qu, k and v in 16-byte chunks: their "
                         "data must start 16-byte aligned")


def _launch_fwd(route, entry, lib, qu, k, v, bias, seed, scale, rate, heads_total,
                head_offset):
    _check_mma(qu, k, v, bias, heads_total, route)
    B, H, L, D = qu.shape
    out = torch.empty((B, L, H, D), dtype=qu.dtype, device=qu.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=qu.device)
    code = getattr(lib, entry)(qu.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), _row_strides(out), B, H, L, D,
                               scale, *_drop_args(seed, rate, H, heads_total, head_offset),
                               _stream(qu))
    check_cuda_status(lib, code, entry)
    launches[f"attention_fwd_d{D}"] += 1
    launches[f"attention_fwd_{route}_d{D}"] += 1
    return out, lse


def _launch_bwd(route, entry, lib, qu, k, v, bias, g, out, lse, seed, scale, rate,
                heads_total, head_offset):
    _check_mma(qu, k, v, bias, heads_total, route)
    _check_like_qu(g, qu, "g")
    _check_like_qu(out, qu, "out")
    B, H, L, D = qu.shape
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous (B, H, L) float32")
    dqu, dk, dv = (torch.empty_like(qu) for _ in range(3))
    dbias = torch.empty_like(bias)
    delta = torch.empty_like(lse)
    code = getattr(lib, entry)(qu.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                               g.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                               dqu.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                               _row_strides(g), _row_strides(out), B, H, L, D, scale,
                               *_drop_args(seed, rate, H, heads_total, head_offset),
                               _stream(qu))
    check_cuda_status(lib, code, entry)
    launches[f"attention_bwd_d{D}"] += 1
    launches[f"attention_bwd_{route}_d{D}"] += 1
    return dqu, dk, dv, dbias


def launch_attention_fwd_mma(qu, k, v, bias, seed: int, scale: float, rate: float,
                             heads_total=None, head_offset: int = 0):
    """bf16 (``attention_mma.cu``). Returns ``(out, lse)``: ``out`` is a (B, H,
    L, D) view of a (B, L, H, D) buffer, so that ``out.transpose(1,
    2).reshape(B, L, H * D)`` copies nothing; ``lse`` is the rows'
    log-sum-exp, (B, H, L) float32."""
    return _launch_fwd("tc", "attn_mma_fwd", _library_mma(), qu, k, v, bias, seed, scale,
                       rate, heads_total, head_offset)


def launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, seed: int, scale: float,
                             rate: float, heads_total=None, head_offset: int = 0):
    """bf16 (``attention_mma.cu``). ``g`` and ``out`` may be strided over (b,
    h, l); their rows must be contiguous and 16-byte aligned."""
    return _launch_bwd("tc", "attn_mma_bwd", _library_mma(), qu, k, v, bias, g, out, lse,
                       seed, scale, rate, heads_total, head_offset)


def launch_attention_fwd_tf32(qu, k, v, bias, seed: int, scale: float, rate: float,
                              heads_total=None, head_offset: int = 0):
    """f32 as 3xTF32 (``attention_f32_mma.cu``); returns ``(out, lse)`` as
    :func:`launch_attention_fwd_mma` does."""
    return _launch_fwd("tf32x3", "attn_tf32_fwd", _library_tf32(), qu, k, v, bias, seed,
                       scale, rate, heads_total, head_offset)


def launch_attention_bwd_tf32(qu, k, v, bias, g, out, lse, seed: int, scale: float,
                              rate: float, heads_total=None, head_offset: int = 0):
    """f32 as 3xTF32 (``attention_f32_mma.cu``); ``g`` and ``out`` as in
    :func:`launch_attention_bwd_mma`."""
    return _launch_bwd("tf32x3", "attn_tf32_bwd", _library_tf32(), qu, k, v, bias, g, out,
                       lse, seed, scale, rate, heads_total, head_offset)


_TC_LAUNCHES = {"tc": (launch_attention_fwd_mma, launch_attention_bwd_mma),
                "tf32x3": (launch_attention_fwd_tf32, launch_attention_bwd_tf32)}


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qu, k, v, bias, seed, scale, rate, heads_total, head_offset):
        ctx.args = (seed, scale, rate, heads_total, head_offset)
        _check(qu, k, v, bias, heads_total)
        ctx.route = attention_route(qu.dtype, qu.shape[2], qu.shape[3])
        if ctx.route in _TC_LAUNCHES:
            out, lse = _TC_LAUNCHES[ctx.route][0](qu, k, v, bias, *ctx.args)
            ctx.save_for_backward(qu, k, v, bias, out, lse)
            return out
        ctx.save_for_backward(qu, k, v, bias)
        return launch_attention_fwd_fma(qu, k, v, bias, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        if ctx.route in _TC_LAUNCHES:
            qu, k, v, bias, out, lse = ctx.saved_tensors
            if not _rows_addressable(g):
                g = g.contiguous()
            grads = _TC_LAUNCHES[ctx.route][1](qu, k, v, bias, g, out, lse, *ctx.args)
        else:
            qu, k, v, bias = ctx.saved_tensors
            grads = launch_attention_bwd_fma(qu, k, v, bias, g.contiguous(), *ctx.args)
        return (*grads, None, None, None, None, None)


def fused_attention(qu, k, v, bias, seed: int, scale: float, rate: float = 0.0,
                    heads_total=None, head_offset: int = 0):
    """``dropout(softmax((qu k^T + bias) * scale)) v`` for (B, H, L, D) inputs.

    CUDA tensors run the hand-written kernels, forward and backward, on the
    set :func:`attention_route` names: the tensor-core sets for bfloat16 or
    float32 at head dim 32, 64 or 128 and any L (their output is a (B, H, L,
    D) view of a (B, L, H, D) buffer), the FMA set at head dim 16. CPU tensors
    run
    :func:`attention_plain`. ``seed`` is a uint32, ignored at rate 0. A
    tensor-parallel rank's H heads are ``head_offset ..`` of ``heads_total``
    (None: H), which places its dropout mask (module note).
    """
    if qu.device.type == "cpu":
        return attention_plain(qu, k, v, bias, seed, scale, rate, heads_total, head_offset)
    return _FusedAttention.apply(qu, k, v, bias, seed, scale, rate, heads_total, head_offset)
