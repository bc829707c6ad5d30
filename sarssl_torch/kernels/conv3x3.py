"""SAME 3x3 convolution, NHWC x HWIO: the CUDA kernel (``csrc/conv3x3.cu``),
its plain PyTorch version and the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/conv3x3.py::conv3x3`` (the Pallas kernel
``_pallas_conv3x3`` and its VJP):

  * forward: ``y = conv(x, w)`` with f32 accumulation, ``y`` in ``x``'s dtype;
  * dx: the same kernel on ``dy`` with ``w`` rotated 180 degrees and its
    in/out channels swapped (``rot180_io``), as the JAX VJP does;
  * dW: a library filter gradient (``torch.nn.grad.conv2d_weight``), as the
    JAX package leaves dW to XLA outside Pallas.

The kernel is on no model path: the port's ``CNNFrontEnd`` keeps
``F.conv2d``, as the JAX front end keeps the XLA conv.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import check_cuda_status, launches, load_library

# (C, Cout) pairs the kernel is instantiated for (csrc/conv3x3.cu)
CHANNELS = ((64, 64), (128, 128), (64, 128), (128, 64))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: nine shifted taps, each a ``(N*H*W, C) x (C, Cout)``
    matmul, summed in f32; the result in ``x``'s dtype."""
    N, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((N * H * W, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dw in range(3):
            acc.addmm_(xp[:, dh:dh + H, dw:dw + W].reshape(N * H * W, C), wf[dh, dw])
    return acc.reshape(N, H, W, -1).to(x.dtype)


def rot180_io(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) -> (3, 3, Cout, C): dx of a stride-1 SAME conv is the
    conv of dy with these weights."""
    return w.flip(0, 1).transpose(2, 3)


def weight_grad(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dW (HWIO, ``w``'s dtype) of ``conv(x, w)`` given ``dy``: a library
    filter gradient on the NCHW views of the NHWC tensors."""
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
                                     dy.to(x.dtype).permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0).to(w.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("conv3x3")
    lib.conv3x3.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.conv3x3.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """Run the kernel on CUDA tensors, ``x`` (N, H, W, C) contiguous and
    ``w`` (3, 3, C, Cout), cast to ``x``'s dtype; count one launch of
    ``name``."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x must be (N, H, W, C) and w (3, 3, C, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    Cout = w.shape[3]
    if (C, Cout) not in CHANNELS:
        raise ValueError(f"{name}: (C, Cout) = {(C, Cout)} has no kernel instance; "
                         f"the kernel takes {CHANNELS}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    if not 0 < N <= 65535 or H == 0 or W == 0:
        raise ValueError(f"{name}: N must be in 1..65535 and H, W positive")
    lib = _library()
    wk = w.to(x.dtype).contiguous()
    y = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    code = lib.conv3x3(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(), y.data_ptr(), N, H, W,
                       C, Cout, torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_status(lib, code, name)
    launches[name] += 1
    return y


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return launch_conv3x3(x, w, "conv3x3_fwd")


def conv3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv3x3(x, w)``: the kernel on ``dy`` with ``rot180_io(w)``."""
    return launch_conv3x3(dy, rot180_io(w), "conv3x3_dx")


class Conv3x3Function(torch.autograd.Function):
    """``apply(x, w, fwd, dx)``: ``fwd(x, w)`` forward; dx by ``dx(dy, w)``,
    dW by :func:`weight_grad`. ``conv3x3`` and ``conv3x3_s2d`` pass their
    own launcher pair."""

    @staticmethod
    def forward(ctx, x, w, fwd, dx):
        ctx.save_for_backward(x, w)
        ctx.dx = dx
        return fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = ctx.dx(dy, w).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = weight_grad(x, dy, w) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of ``x`` (N, H, W, C) with ``w`` (3, 3, C, Cout).

    CUDA tensors run the hand-written kernel (forward and dx); CPU tensors
    run :func:`conv3x3_plain`."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    return Conv3x3Function.apply(x, w, conv3x3_fwd, conv3x3_dx)
