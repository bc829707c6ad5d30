"""SAME 3x3 convolution, NHWC x HWIO: the CUDA kernels, their plain PyTorch
version and the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/conv3x3.py::conv3x3`` (the Pallas kernel
``_pallas_conv3x3`` and its VJP):

  * forward: ``y = conv(x, w)`` with f32 accumulation, ``y`` in ``x``'s dtype;
  * dx: the same kernel on ``dy`` with ``w`` rotated 180 degrees and its
    in/out channels swapped (``rot180_io``), as the JAX VJP does;
  * dW: a library filter gradient (``torch.nn.grad.conv2d_weight``), as the
    JAX package leaves dW to XLA outside Pallas.

Two kernels, chosen by dtype and channels (:func:`takes_tensor_cores`):

* ``csrc/conv3x3_mma.cu``: bfloat16 at the channel pairs of ``CHANNELS``. An
  implicit GEMM on the tensor cores (``wgmma``). It multiplies blocks of
  64 x 64 channels: the wrapper packs the weight into those blocks
  (:func:`pack_weights`), in the order :func:`dense_slots` names.
  :func:`conv3x3_from_blocks` repeats that arithmetic in plain PyTorch, for
  any table of blocks (the s2d form's is in ``conv_s2d.py``).
* ``csrc/conv3x3.cu``: float32 at the same pairs, as f32 FMAs. A float32
  product on the tensor cores would be TF32 and miss the 1e-4 tolerance.

For a CUDA tensor the wrapper launches the kernel it names here or raises.
The kernels are on no model path: the port's ``CNNFrontEnd`` keeps
``F.conv2d``, as the JAX front end keeps the XLA conv.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import check_cuda_status, launches, load_library

# (C, Cout) pairs both kernels are instantiated for
CHANNELS = ((64, 64), (128, 128), (64, 128), (128, 64))
BLOCK = 64  # channels per block of the tensor-core kernel (csrc/conv3x3_mma.cu)
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


def takes_tensor_cores(dtype: torch.dtype, C: int, Cout: int) -> bool:
    """Whether the conv wrappers run ``conv3x3_mma.cu`` for CUDA tensors of
    this dtype and these channels. float32 at the same pairs runs
    ``conv3x3.cu``; the wrappers raise on anything else."""
    return dtype == torch.bfloat16 and (C, Cout) in CHANNELS


def dense_slots(kh: int) -> list:
    """The block table of a dense weight, ``[dh][j][k-chunk][0]`` -> the
    block's place among the ``9 * kh`` blocks of one output chunk, as
    :func:`pack_weights` lays them out (every block exists)."""
    return [[[[(dh * 3 + j) * kh + k if k < kh else -1, -1] for k in range(2)]
             for j in range(3)] for dh in range(3)]


def pack_weights(w: torch.Tensor, blk: int = BLOCK) -> torch.Tensor:
    """(3, 3, C, Cout) -> (Cout/blk, 9 C/blk, blk, blk) contiguous: for each
    output chunk the ``blk x blk`` blocks in the order (dh, j, k-chunk). A
    view of ``w`` when C == Cout == blk and ``w`` is contiguous."""
    kh, nh = w.shape[2] // blk, w.shape[3] // blk
    return (w.reshape(3, 3, kh, blk, nh, blk).permute(4, 0, 1, 2, 3, 5)
            .reshape(nh, 9 * kh, blk, blk).contiguous())


def conv3x3_from_blocks(x: torch.Tensor, packed: torch.Tensor, slots,
                        shared_blocks: bool) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: ``x`` (N, H, W,
    kh * blk) and the weight's operands as they are, f32 sums, one ``blk x
    blk`` product per block that ``slots`` names and none for the others.

    ``packed`` is (P, S, blk, blk). ``shared_blocks`` False: output chunk
    ``n`` takes ``packed[n]`` and ``slots[dh][j][k][0]`` (a dense weight as
    :func:`pack_weights` lays it out). True: both output chunks take
    ``packed[0]``, chunk ``n`` through ``slots[dh][j][k][n]`` (the s2d view
    with ``conv_s2d.S2D_SLOTS``: ``w``'s nine blocks serve both parities)."""
    N, H, W, C = x.shape
    blk = packed.shape[-1]
    kh = C // blk
    nh = 2 if shared_blocks else packed.shape[0]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.zeros((N * H * W, nh, blk), dtype=torch.float32, device=x.device)
    for n in range(nh):
        blocks, col = (packed[0], n) if shared_blocks else (packed[n], 0)
        for dh in range(3):
            for j in range(3):
                for k in range(kh):
                    slot = slots[dh][j][k][col]
                    if slot < 0:
                        continue
                    a = xp[:, dh:dh + H, j:j + W, k * blk:(k + 1) * blk]
                    out[:, n].addmm_(a.reshape(N * H * W, blk), blocks[slot].float())
    return out.reshape(N, H, W, nh * blk).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("conv3x3")
    lib.conv3x3.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.conv3x3.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_mma():
    lib = load_library("conv3x3_mma")
    lib.conv3x3_mma.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.conv3x3_mma.restype = _I
    lib.conv3x3_mma_smem_bytes.argtypes = [_I] * 3
    lib.conv3x3_mma_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def mma_smem_bytes(kh: int, mt: int, stages: int) -> int:
    """Dynamic shared memory a block of ``conv3x3_mma_kernel<kh, mt, stages>``
    takes."""
    return _library_mma().conv3x3_mma_smem_bytes(kh, mt, stages)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x must be (N, H, W, C) and w (3, 3, C, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if (x.shape[3], w.shape[3]) not in CHANNELS:
        raise ValueError(f"{name}: (C, Cout) = {(x.shape[3], w.shape[3])} has no kernel "
                         f"instance; the kernels take {CHANNELS}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    if not 0 < x.shape[0] <= 65535 or x.shape[1] == 0 or x.shape[2] == 0:
        raise ValueError(f"{name}: N must be in 1..65535 and H, W positive")


def launch_conv3x3_fma(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """Run the FMA kernel (``conv3x3.cu``) on CUDA tensors, ``x`` (N, H, W, C)
    contiguous and ``w`` (3, 3, C, Cout), cast to ``x``'s dtype; count one
    launch of ``name``. It takes bfloat16 too: the tensor-core kernel is timed
    against it."""
    _check(x, w, name)
    N, H, W, C = x.shape
    Cout = w.shape[3]
    lib = _library()
    wk = w.to(x.dtype).contiguous()
    y = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    code = lib.conv3x3(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(), y.data_ptr(), N, H, W,
                       C, Cout, torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_status(lib, code, name)
    launches[name] += 1
    return y


def launch_conv3x3_mma(x: torch.Tensor, packed: torch.Tensor, name: str) -> torch.Tensor:
    """Run the tensor-core kernel (``conv3x3_mma.cu``) on ``x`` (N, H, W, C)
    bfloat16 contiguous with the weight as :func:`pack_weights` lays it out,
    (Cout/64, 9 C/64, 64, 64); count one launch of ``name`` and one of
    ``name + "_tc"``."""
    if not (x.is_cuda and packed.device == x.device and x.dtype == packed.dtype
            == torch.bfloat16 and x.is_contiguous() and packed.is_contiguous()):
        raise ValueError(f"{name}: the tensor-core kernel takes contiguous bfloat16 CUDA "
                         f"tensors on one device")
    N, H, W, C = x.shape
    cout = packed.shape[0] * BLOCK
    if not takes_tensor_cores(x.dtype, C, cout) or x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core kernel takes 16-byte aligned tensors at "
                         f"(C, Cout) in {CHANNELS}, got {(C, cout)}")
    if tuple(packed.shape[1:]) != (9 * (C // BLOCK), BLOCK, BLOCK):
        raise ValueError(f"{name}: {tuple(packed.shape)} is not the packed weight of "
                         f"C = {C}")
    lib = _library_mma()
    y = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    code = lib.conv3x3_mma(x.data_ptr(), packed.data_ptr(), y.data_ptr(), N, H, W, C, cout,
                           torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_status(lib, code, name)
    launches[name] += 1
    launches[name + "_tc"] += 1
    return y


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """Run the kernel that :func:`takes_tensor_cores` names on CUDA tensors,
    ``x`` (N, H, W, C) contiguous and ``w`` (3, 3, C, Cout), cast to ``x``'s
    dtype."""
    _check(x, w, name)
    if takes_tensor_cores(x.dtype, x.shape[3], w.shape[3]):
        return launch_conv3x3_mma(x, pack_weights(w.to(x.dtype)), name)
    return launch_conv3x3_fma(x, w, name)


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
