"""SAME 3x3 convolution, NHWC x HWIO: the CUDA kernels, their plain PyTorch
version and the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/conv3x3.py::conv3x3`` (the Pallas kernel
``_pallas_conv3x3`` and its VJP):

  * forward: ``y = conv(x, w)`` with f32 accumulation, ``y`` in ``x``'s dtype;
  * dx: the same kernel on ``dy`` with ``w`` rotated 180 degrees and its
    in/out channels swapped (``rot180_io``), as the JAX VJP does;
  * dW: a library filter gradient (``torch.nn.grad.conv2d_weight``), as the
    JAX package leaves dW to XLA outside Pallas.

The kernels, chosen by dtype, channels and image size (:func:`conv_kernel`):

* ``csrc/conv3x3_mma.cu``: bfloat16 at the channel pairs of ``CHANNELS``. An
  implicit GEMM on the tensor cores (``wgmma``). It multiplies blocks of
  64 x 64 channels: the wrapper packs the weight into those blocks
  (:func:`pack_weights`), in the order :func:`dense_slots` names.
  :func:`conv3x3_from_blocks` repeats that arithmetic in plain PyTorch, for
  any table of blocks (the s2d form's is in ``conv_s2d.py``).
* ``csrc/conv3x3_any_mma.cu``: bfloat16 at every other (C, Cout), as the
  Pallas kernel takes any: the tensor-core design with C and Cout at run
  time, in K chunks of 64 input channels and passes of NB output channels
  (:func:`any_mma_passes`). One launch a call: the kernel's blocks first
  pack the weight into those blocks, zero-padded, into a scratch
  (:func:`pack_weights_any` is its plain version; for dx they rotate the
  weight as they pack it), meet at a grid barrier (a cooperative launch)
  and run the conv; :func:`conv3x3_from_padded_blocks` repeats the conv's
  arithmetic in plain PyTorch.
* ``csrc/conv3x3_tf32.cu``: float32 at every (C, Cout). The same design with
  each product taken as three TF32 products on the tensor cores (3xTF32:
  operands split by :func:`split_tf32` into hi + lo, lo hi + hi lo + hi hi),
  which holds the f32 tolerance of 1e-4; K chunks of 32 f32 channels and
  passes of at most 32 output channels, 64 where C <= 32
  (:func:`tf32_passes`), the weight's hi and lo blocks packed by the same
  launch's blocks before its grid barrier (:func:`pack_weights_tf32`);
  :func:`conv3x3_tf32x3` repeats its arithmetic in plain PyTorch. Each K
  chunk's products are summed apart and added to the sum in f32 (the tensor
  core's adder cuts each sum toward zero, so a long running sum in it
  drifts).
* ``csrc/conv3x3.cu``: the f32 FMA kernels of the first version, at
  ``CHANNELS`` and (``conv3x3_any_kernel``) at any pair. No route takes
  them: they are launched only directly (:func:`launch_conv3x3_fma`,
  :func:`launch_conv3x3_any`), as the yardstick of the tensor-core kernels.

Images smaller than a row tile (:func:`conv_tiling`): both dtypes, at any
(C, Cout), run the image groups of their tensor-core kernel (built as
libraries of their own from ``csrc/conv3x3_any_mma_groups.cu`` and
``csrc/conv3x3_tf32_groups.cu``), a tile of G whole images, G = floor(256 /
(H W)), staged without a halo; each pixel's taps are rows of the staged group
or a zero row (:func:`group_tap_rows`), and
:func:`conv3x3_from_image_groups` repeats that arithmetic in plain PyTorch.

Any H, W and N: the tensor-core kernels walk their tiles in a loop and take
any N in one launch; the FMA kernels put their pixel tiles on the grid's x
dimension and launch runs of at most 65535 images (:func:`conv_batch_chunks`).

A call of the runtime-channel kernels works out its route, G, passes and
checks once a shape (:func:`_conv_plan`), allocates its output alone (the
packed weight goes to a scratch kept for the stream, :func:`_workspace`,
packed anew every call) and hands the C entry six arguments.

For a CUDA tensor the wrapper launches the kernel it names here or raises.
The kernels are on no model path: the port's ``CNNFrontEnd`` keeps
``F.conv2d``, as the JAX front end keeps the XLA conv.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ._build import GRID_YZ, check_cuda_status, launches, load_library, raw_stream

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
    this dtype and these channels (bfloat16 at ``CHANNELS``). Every other
    pair and dtype runs a runtime-channel tensor-core kernel
    (:func:`conv_kernel`)."""
    return dtype == torch.bfloat16 and (C, Cout) in CHANNELS


GROUP_PIXELS = 256  # output pixels of an image-group tile (conv3x3_any_mma.cu's GM)


def conv_tiling(dtype: torch.dtype, H: int, W: int, C: int, Cout: int) -> int:
    """How many images a tile of the tensor-core kernels holds for CUDA
    tensors of this dtype and shape: G = floor(256 / (H W)) whole images
    (the image groups of ``conv3x3_any_mma.cu`` in bfloat16, of
    ``conv3x3_tf32.cu`` in float32), or 0 for row tiles (of 16 x 32 pixels
    at ``conv3x3_mma.cu``'s C = 64 instance, else 16 x 16).

    The rule: image groups wherever the share of a group tile's 256 outputs
    inside an image, G H W / 256, exceeds the row tiles' share, H W over the
    pixels of the tiles that cover one image; row tiles at a tie, where their
    fragments serve three output rows each. So (4, 8) takes groups of 8
    (1/8 of a 16 x 16 tile inside, 1/16 of a 16 x 32 one), (1, 1) groups of
    256, and (16, 16) or anything past 256 pixels row tiles (at C = 64 (16,
    16) fills half of a 16 x 32 tile: groups of one). The same rule in
    float32, whose row tiles are 16 x 16."""
    if dtype not in _DTYPES or H * W > GROUP_PIXELS:
        return 0
    th, tw = (16, 32) if takes_tensor_cores(dtype, C, Cout) and C == BLOCK else (16, 16)
    rows_share = H * W / (-(-H // th) * th * -(-W // tw) * tw)
    G = GROUP_PIXELS // (H * W)
    return G if G * H * W / GROUP_PIXELS > rows_share else 0


def conv_kernel(dtype: torch.dtype, C: int, Cout: int, H: int | None = None,
                W: int | None = None) -> str:
    """The kernel the conv wrappers run for CUDA tensors of this dtype and
    these channels: ``"tc"`` (``conv3x3_mma.cu``, bfloat16 at ``CHANNELS``),
    ``"tc_any"`` (``conv3x3_any_mma.cu``'s row tiles, bfloat16 at every other
    pair) or ``"tf32"`` (``conv3x3_tf32.cu``'s row tiles, float32 at every
    pair). Given H and W, ``"tc_groups"`` / ``"tf32_groups"`` (the image
    groups of the same two sources) where :func:`conv_tiling` names groups."""
    groups = H is not None and conv_tiling(dtype, H, W, C, Cout)
    if dtype == torch.float32:
        return "tf32_groups" if groups else "tf32"
    if groups:
        return "tc_groups"
    return "tc" if takes_tensor_cores(dtype, C, Cout) else "tc_any"


def conv_batch_chunks(N: int) -> list:
    """``(n0, nn)`` launches of an FMA conv kernel (the yardstick) that cover
    N images: at most :data:`GRID_YZ` a launch (the grid's y dimension)."""
    return [(n0, min(GRID_YZ, N - n0)) for n0 in range(0, N, GRID_YZ)]


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


def any_mma_passes(Cout: int) -> tuple:
    """``(passes, NB)`` of ``conv3x3_any_mma.cu`` for Cout output channels:
    ``ceil(Cout / 64)`` passes of NB channels, NB the least multiple of 8
    that covers Cout in that many (wgmma's N; the launch passes NB to the
    kernel, which takes ``ceil(Cout / NB)`` passes)."""
    passes = -(-Cout // BLOCK)
    per_pass = -(-Cout // passes)
    return passes, -(-per_pass // 8) * 8


def pack_weights_any(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) -> (passes, ceil(C / 64), 9, NB, 64) contiguous, zero
    past C and Cout: for each pass of NB output channels and each K chunk of
    64 input channels the nine taps' blocks, each ``[co][ci]`` (the kernel's
    K-major B operand). The plain version of ``conv3x3_any_mma.cu``'s
    ``pack_share`` (the packing each launch's blocks do before its grid barrier)."""
    _, _, C, Cout = w.shape
    passes, nb = any_mma_passes(Cout)
    kc = -(-C // BLOCK)
    wp = torch.zeros((3, 3, kc * BLOCK, passes * nb), dtype=w.dtype, device=w.device)
    wp[:, :, :C, :Cout] = w
    return (wp.reshape(9, kc, BLOCK, passes, nb).permute(3, 1, 0, 4, 2)
            .contiguous())


def conv3x3_from_padded_blocks(x: torch.Tensor, packed: torch.Tensor,
                               Cout: int) -> torch.Tensor:
    """``conv3x3_any_mma.cu``'s arithmetic in plain PyTorch: ``x`` (N, H, W,
    C) zero-padded to the K chunks, one ``64 x NB`` product a (pass, chunk,
    tap) block of ``packed`` (as :func:`pack_weights_any` lays it out), f32
    sums, the first Cout channels in ``x``'s dtype."""
    N, H, W, C = x.shape
    passes, kc, _, nb, blk = packed.shape
    xp = F.pad(x.float(), (0, kc * blk - C, 1, 1, 1, 1))
    out = torch.zeros((N * H * W, passes, nb), dtype=torch.float32, device=x.device)
    for p in range(passes):
        for k in range(kc):
            for tap in range(9):
                dh, dw = divmod(tap, 3)
                a = xp[:, dh:dh + H, dw:dw + W, k * blk:(k + 1) * blk]
                out[:, p].addmm_(a.reshape(N * H * W, blk), packed[p, k, tap].float().T)
    return out.reshape(N, H, W, passes * nb)[..., :Cout].to(x.dtype)


def group_tap_rows(H: int, W: int, G: int) -> torch.Tensor:
    """(256, 9) int64: for each output row p of an image-group tile and tap
    (dh, dw) the chunk row its A fragment reads in the staged group (row 1 +
    q for the group's pixel q), or 0, the zero row, where the tap falls
    outside p's image or p outside the group's G images. The plain version of
    each lane's ``a_off`` in ``conv3x3_any_mma_groups_kernel``."""
    p = torch.arange(GROUP_PIXELS)
    h, w = (p % (H * W)) // W, p % W
    rows = torch.zeros((GROUP_PIXELS, 9), dtype=torch.int64)
    for tap in range(9):
        dh, dw = divmod(tap, 3)
        ok = ((p < G * H * W) & (h + dh - 1 >= 0) & (h + dh - 1 < H) & (w + dw - 1 >= 0)
              & (w + dw - 1 < W))
        rows[:, tap] = torch.where(ok, 1 + p + (dh - 1) * W + (dw - 1), 0)
    return rows


def image_group_pixels(N: int, H: int, W: int, G: int) -> torch.Tensor:
    """(ceil(N / G), 256) int64: the flat output pixel (n H W + h W + w) that
    row p of group tile t writes, -1 where the epilogue masks it (past the
    group's images, or a missing image of a ragged last group)."""
    t = torch.arange(-(-N // G))[:, None]
    p = torch.arange(GROUP_PIXELS)[None, :]
    pix = t * G * H * W + p
    return torch.where((p < G * H * W) & (pix < N * H * W), pix, -1)


def conv3x3_from_image_groups(x: torch.Tensor, packed: torch.Tensor, Cout: int,
                              G: int) -> torch.Tensor:
    """The image-group mode's arithmetic in plain PyTorch: ``x`` (N, H, W, C)
    in tiles of G images, each staged as a zero row then its pixels' rows
    (zero-padded to the K chunks, zeros past a ragged last group); row p of a
    tile takes tap t's ``64 x NB`` blocks of ``packed`` (as
    :func:`pack_weights_any` lays it out) on staged row
    ``group_tap_rows(H, W, G)[p, t]``; f32 sums; the rows that
    :func:`image_group_pixels` names written back, the first Cout channels in
    ``x``'s dtype."""
    N, H, W, C = x.shape
    passes, kc, _, nb, blk = packed.shape
    T = -(-N // G)
    staged = torch.zeros((T, 1 + GROUP_PIXELS, kc * blk), dtype=torch.float32, device=x.device)
    flat = x.reshape(N * H * W, C).float()
    pixels = image_group_pixels(N, H, W, G).to(x.device)
    real = pixels >= 0
    staged[:, 1:][real] = F.pad(flat, (0, kc * blk - C))[pixels[real]]
    rows = group_tap_rows(H, W, G).to(x.device)
    out = torch.zeros((T, GROUP_PIXELS, passes * nb), dtype=torch.float32, device=x.device)
    for tap in range(9):  # the tap's rows once, times its blocks of every pass and chunk
        blocks = packed[:, :, tap].float().permute(1, 3, 0, 2).reshape(kc * blk, passes * nb)
        out += staged[:, rows[:, tap]] @ blocks
    y = torch.empty((N * H * W, Cout), dtype=torch.float32, device=x.device)
    y[pixels[real]] = out[real][:, :Cout]
    return y.reshape(N, H, W, Cout).to(x.dtype)


TF32_BLOCK = 32  # f32 channels of a K chunk of conv3x3_tf32.cu (128-byte rows)
# output channels of a pass of conv3x3_tf32.cu at most (wgmma's N): 32, or 64
# where C <= 32 (one K chunk, whose weights a block copies once)
TF32_NB, TF32_NB_ONE_CHUNK = 32, 64


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: ``cvt.rna.tf32.f32`` on the int32 view (add half of the 13 dropped
    bits' unit to the magnitude, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi) (x -
    hi is exact in f32), as ``mma_common.cuh::split_tf32`` and
    ``conv3x3_tf32.cu::split_tf32_bits`` split it."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def tf32_passes(Cout: int, C: int) -> tuple:
    """``(passes, NB)`` of ``conv3x3_tf32.cu`` for C input and Cout output
    channels: ``ceil(Cout / 32)`` passes of NB channels, NB the least
    multiple of 8 that covers Cout in that many (wgmma's N, at most 32: a
    stage's hi and lo weight blocks and its input tile fit twice in shared
    memory); where C <= 32 ``ceil(Cout / 64)`` passes (one K chunk: a block
    copies its weights once, and one stage of them fits at NB = 64)."""
    passes = -(-Cout // (TF32_NB_ONE_CHUNK if C <= TF32_BLOCK else TF32_NB))
    per_pass = -(-Cout // passes)
    return passes, -(-per_pass // 8) * 8


def pack_weights_tf32(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) -> (passes, ceil(C / 32), 2, 9, NB, 32) float32
    contiguous, zero past C and Cout: for each pass of NB output channels
    and each K chunk of 32 input channels the nine taps' TF32 hi blocks
    ([.., 0, ..]) then their lo blocks ([.., 1, ..]), each ``[co][ci]`` (the
    kernel's K-major B operand). The plain version of ``conv3x3_tf32.cu``'s
    ``pack_share`` (the packing each launch's blocks do before its grid barrier)."""
    _, _, C, Cout = w.shape
    passes, nb = tf32_passes(Cout, C)
    kc = -(-C // TF32_BLOCK)
    wp = torch.zeros((3, 3, kc * TF32_BLOCK, passes * nb), dtype=torch.float32, device=w.device)
    wp[:, :, :C, :Cout] = w
    blocks = wp.reshape(9, kc, TF32_BLOCK, passes, nb).permute(3, 1, 0, 4, 2)
    return torch.stack(split_tf32(blocks), dim=2).contiguous()


def conv3x3_tf32x3(x: torch.Tensor, w: torch.Tensor, groups: int = 0) -> torch.Tensor:
    """``conv3x3_tf32.cu``'s arithmetic in plain PyTorch: ``x`` (N, H, W, C)
    split into TF32 hi + lo, the weight packed by :func:`pack_weights_tf32`,
    and the conv as the three split products lo hi + hi lo + hi hi summed in
    f32, in row tiles (:func:`conv3x3_from_padded_blocks`) or, with
    ``groups`` = G > 0, in tiles of G whole images
    (:func:`conv3x3_from_image_groups`); float32 out."""
    Cout = w.shape[3]
    packed = pack_weights_tf32(w)
    w_hi, w_lo = packed[:, :, 0], packed[:, :, 1]
    hi, lo = split_tf32(x)

    def conv(a, b):
        if groups:
            return conv3x3_from_image_groups(a, b, Cout, groups)
        return conv3x3_from_padded_blocks(a, b, Cout)

    return conv(lo, w_hi) + conv(hi, w_lo) + conv(hi, w_hi)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("conv3x3")
    lib.conv3x3.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.conv3x3.restype = _I
    lib.conv3x3_any.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.conv3x3_any.restype = _I
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


@functools.lru_cache(maxsize=None)
def _library_any_mma(groups: bool = False):
    """``conv3x3_any_mma.cu``'s row tiles, or with ``groups`` its image groups
    (``conv3x3_any_mma_groups.cu``, a library of their own)."""
    lib = load_library("conv3x3_any_mma_groups" if groups else "conv3x3_any_mma")
    lib.conv3x3_any_mma.argtypes = [_P] * 6
    lib.conv3x3_any_mma.restype = _I
    lib.conv3x3_any_mma_smem_bytes.argtypes = [_I, _I]
    lib.conv3x3_any_mma_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_tf32(groups: bool = False):
    """``conv3x3_tf32.cu``'s row tiles, or with ``groups`` its image groups
    (``conv3x3_tf32_groups.cu``, a library of their own)."""
    lib = load_library("conv3x3_tf32_groups" if groups else "conv3x3_tf32")
    lib.conv3x3_tf32.argtypes = [_P] * 6
    lib.conv3x3_tf32.restype = _I
    lib.conv3x3_tf32_smem_bytes.argtypes = [_I, _I]
    lib.conv3x3_tf32_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def tf32_smem_bytes(nb: int, groups: bool = False) -> int:
    """Dynamic shared memory a block of ``conv3x3_tf32_kernel<nb, *>`` (with
    ``groups``: ``conv3x3_tf32_groups_kernel<nb, *>``) takes."""
    return _library_tf32(groups).conv3x3_tf32_smem_bytes(nb, int(groups))


def any_mma_smem_bytes(nb: int, groups: bool = False) -> int:
    """Dynamic shared memory a block of ``conv3x3_any_mma_kernel<nb, *>``
    (with ``groups``: ``conv3x3_any_mma_groups_kernel<nb, *>``) takes."""
    return _library_any_mma(groups).conv3x3_any_mma_smem_bytes(nb, int(groups))


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
    if min(x.shape) == 0 or w.shape[3] == 0:
        raise ValueError(f"{name}: N, H, W, C and Cout must be positive, got "
                         f"{tuple(x.shape)} -> {w.shape[3]}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")


def _launch_fma(entry: str, x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """The C entry ``entry`` of ``conv3x3.cu`` on ``x`` (N, H, W, C) and ``w``
    (3, 3, C, Cout) cast to ``x``'s dtype, once for each run of
    :func:`conv_batch_chunks`; counts a pass over more than one launch as
    ``name + "_chunked"``."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    lib = _library()
    wk = w.to(x.dtype).contiguous()
    y = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    chunks = conv_batch_chunks(N)
    for n0, nn in chunks:
        code = getattr(lib, entry)(_DTYPES[x.dtype], x[n0].data_ptr(), wk.data_ptr(),
                                   y[n0].data_ptr(), nn, H, W, C, Cout,
                                   torch.cuda.current_stream(x.device).cuda_stream)
        check_cuda_status(lib, code, name)
    if len(chunks) > 1:
        launches[name + "_chunked"] += 1
    return y


def launch_conv3x3_fma(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """Run the FMA kernel (``conv3x3.cu``'s instances, (C, Cout) in
    ``CHANNELS``) on CUDA tensors, ``x`` (N, H, W, C) contiguous and ``w``
    (3, 3, C, Cout), cast to ``x``'s dtype; count one launch of ``name``. No
    route takes it: in both dtypes it is the yardstick the tensor-core
    kernels are timed against, launched directly."""
    _check(x, w, name)
    if (x.shape[3], w.shape[3]) not in CHANNELS:
        raise ValueError(f"{name}: the FMA kernel's instances take (C, Cout) in {CHANNELS}, "
                         f"got {(x.shape[3], w.shape[3])}")
    y = _launch_fma("conv3x3", x, w, name)
    launches[name] += 1
    return y


def launch_conv3x3_any(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """Run ``conv3x3.cu``'s runtime-channel kernel on CUDA tensors, ``x`` (N,
    H, W, C) contiguous and ``w`` (3, 3, C, Cout) at any C, Cout, cast to
    ``x``'s dtype; count one launch of ``name`` and one of ``name + "_any"``.
    No route takes it: in both dtypes it is the yardstick of the
    runtime-channel tensor-core kernels, launched directly."""
    _check(x, w, name)
    y = _launch_fma("conv3x3_any", x, w, name)
    launches[name] += 1
    launches[name + "_any"] += 1
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


_CALL = ctypes.c_int * 8  # the runtime-channel C entries' call: N, H, W, C, Cout, NB, rot, G


class _Plan:
    """What a conv call of one shape needs that depends on the shape alone,
    checked once (:func:`_conv_plan`): the kernel (``conv_kernel``'s name),
    G, Cout and, for the runtime-channel tensor-core kernels, the scratch's
    shape, the C entry's ``call`` and the launch counter's suffix (the
    library is loaded at the first launch, so that a plan is made without a
    card)."""

    __slots__ = ("kernel", "groups", "cout", "scratch", "scratch_bytes", "call", "call_ptr",
                 "suffix", "aligned")


@functools.lru_cache(maxsize=4096)
def _conv_plan(dtype: torch.dtype, N: int, H: int, W: int, C: int, wshape: tuple, rot: bool,
               groups) -> _Plan:
    """The plan of a conv of ``x`` (N, H, W, C) of ``dtype`` with a weight of
    shape ``wshape``, (3, 3, C, Cout) or with ``rot`` (3, 3, Cout, C); with
    ``groups`` None the kernel and G that :func:`conv_kernel` and
    :func:`conv_tiling` name, else the runtime-channel tensor-core kernel of
    ``dtype`` with G = ``groups`` (0: row tiles). Raises on what the kernels
    do not take; the device, layout and alignment are checked each call."""
    plan = _Plan()
    if dtype not in _DTYPES:
        raise ValueError(f"the conv kernels take float32 or bfloat16, got {dtype}")
    if len(wshape) != 4 or tuple(wshape[:2]) != (3, 3) or wshape[3 if rot else 2] != C:
        raise ValueError(f"x must be (N, H, W, C) and w (3, 3, C, Cout), got "
                         f"{(N, H, W, C)} and {tuple(wshape)}" + (" (rotated)" if rot else ""))
    plan.cout = wshape[2] if rot else wshape[3]
    if min(N, H, W, C, plan.cout) <= 0:
        raise ValueError(f"N, H, W, C and Cout must be positive, got {(N, H, W, C)} -> "
                         f"{plan.cout}")
    if groups is None:
        plan.kernel = conv_kernel(dtype, C, plan.cout, H, W)
        groups = conv_tiling(dtype, H, W, C, plan.cout)
    else:
        plan.kernel = ("tf32" if dtype == torch.float32 else "tc_any") + ("_groups" if groups
                                                                          else "")
    if groups < 0 or groups * H * W > GROUP_PIXELS:
        raise ValueError(f"a tile holds at most {GROUP_PIXELS} pixels, got {groups} images of "
                         f"{H} x {W}")
    plan.groups = groups
    if plan.kernel == "tc":
        return plan
    if dtype == torch.float32:
        passes, nb = tf32_passes(plan.cout, C)
        plan.scratch = (passes, -(-C // TF32_BLOCK), 2, 9, nb, TF32_BLOCK)
        plan.suffix = "_tf32_groups" if groups else "_tf32"
        plan.aligned = C % 4 == 0  # x's rows are 16-byte pieces: x must start 16-byte aligned
    else:
        passes, nb = any_mma_passes(plan.cout)
        plan.scratch = (passes, -(-C // BLOCK), 9, nb, BLOCK)
        plan.suffix = "_tc_groups" if groups else "_tc_any"
        plan.aligned = C % 8 == 0
    plan.scratch_bytes = math.prod(plan.scratch) * (4 if dtype == torch.float32 else 2)
    plan.call = _CALL(N, H, W, C, plan.cout, nb, int(rot), groups)
    plan.call_ptr = ctypes.addressof(plan.call)
    return plan


# the scratch the runtime-channel kernels pack the weight into, one a (device,
# stream): a call packs its weight anew and the next call on the stream runs
# after it, so the bytes are reused, never the packed weight. Kept up to this
# size (a small call's allocation is a share of its time); a larger scratch
# (C = Cout = 2048 in f32 takes 302 MB) is a call's own.
_WORKSPACES: dict = {}
_WORKSPACE_KEPT = 1 << 24


def _workspace(x: torch.Tensor, stream: int, nbytes: int) -> torch.Tensor:
    """At least ``nbytes`` of scratch on ``x``'s device for a call on
    ``stream``: the stream's kept scratch, grown as a call needs, up to
    ``_WORKSPACE_KEPT`` bytes, else the call's own."""
    if nbytes > _WORKSPACE_KEPT:
        return torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    key = (x.get_device(), stream)
    buf = _WORKSPACES.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _WORKSPACES[key] = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    return buf


def _launch_runtime_channels(x: torch.Tensor, w: torch.Tensor, name: str, plan: _Plan
                             ) -> torch.Tensor:
    """One call of ``plan``'s runtime-channel tensor-core kernel on CUDA
    tensors (the shapes checked by the plan): the output allocated, the
    weight's scratch the stream's (:func:`_workspace`), one C call, one
    kernel launch that packs the weight and runs the conv; counts one launch
    of ``name`` and one of ``name + plan.suffix``."""
    if not (x.is_cuda and w.get_device() == x.get_device() and x.is_contiguous()):
        raise ValueError(f"{name}: the tensor-core kernels take a contiguous x and w on one "
                         f"CUDA device")
    if w.dtype != x.dtype or not w.is_contiguous():
        w = w.to(x.dtype).contiguous()
    if plan.aligned and x.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core kernels read x in 16-byte pieces where its "
                         f"rows are: x must start 16-byte aligned")
    N, H, W, _ = x.shape
    stream = raw_stream(x)
    wp = _workspace(x, stream, plan.scratch_bytes)
    y = x.new_empty((N, H, W, plan.cout))
    if x.dtype == torch.float32:
        lib = _library_tf32(plan.groups > 0)
        entry = lib.conv3x3_tf32
    else:
        lib = _library_any_mma(plan.groups > 0)
        entry = lib.conv3x3_any_mma
    code = entry(x.data_ptr(), w.data_ptr(), wp.data_ptr(), y.data_ptr(), plan.call_ptr, stream)
    if code:
        check_cuda_status(lib, code, name)
    launches[name] += 1
    launches[name + plan.suffix] += 1
    return y


def launch_conv3x3_any_mma(x: torch.Tensor, w: torch.Tensor, name: str,
                           rot: bool = False, groups: int = 0) -> torch.Tensor:
    """Run the runtime-channel tensor-core kernel (``conv3x3_any_mma.cu``) on
    ``x`` (N, H, W, C) bfloat16 contiguous with ``w`` (3, 3, C, Cout), or
    with ``rot`` ``rot180_io(w)`` of ``w`` (3, 3, Cout, C), cast to bfloat16:
    one launch that packs the weight (as :func:`pack_weights_any` does) and
    runs the conv in row tiles, or with ``groups`` = G > 0 in tiles of G
    whole images (G H W <= 256); count one launch of ``name`` and one of
    ``name + "_tc_any"`` (row tiles) or ``name + "_tc_groups"``."""
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        raise ValueError(f"{name}: the tensor-core kernel takes contiguous bfloat16 CUDA "
                         f"tensors on one device")
    return _launch_runtime_channels(
        x, w, name, _conv_plan(x.dtype, *x.shape, w.shape, rot, groups))


def launch_conv3x3_tf32(x: torch.Tensor, w: torch.Tensor, name: str, rot: bool = False,
                        groups: int = 0) -> torch.Tensor:
    """Run the 3xTF32 tensor-core kernel (``conv3x3_tf32.cu``) on ``x`` (N, H,
    W, C) float32 contiguous with ``w`` (3, 3, C, Cout), or with ``rot``
    ``rot180_io(w)`` of ``w`` (3, 3, Cout, C), cast to float32: one launch
    that packs the weight (as :func:`pack_weights_tf32` does) and runs the
    conv in row tiles, or with ``groups`` = G > 0 in tiles of G whole images
    (G H W <= 256), each K chunk's products summed apart. Counts one launch of
    ``name`` and one of ``name + "_tf32"`` (row tiles) or ``name +
    "_tf32_groups"``."""
    if x.dtype != torch.float32 or not x.is_cuda:
        raise ValueError(f"{name}: the 3xTF32 kernel takes contiguous float32 CUDA tensors on "
                         f"one device")
    return _launch_runtime_channels(
        x, w, name, _conv_plan(x.dtype, *x.shape, w.shape, rot, groups))


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, name: str,
                   rot: bool = False) -> torch.Tensor:
    """Run the kernel that :func:`conv_kernel` names on CUDA tensors, ``x``
    (N, H, W, C) contiguous and ``w`` (3, 3, C, Cout), or with ``rot``
    ``rot180_io(w)`` of ``w`` (3, 3, Cout, C), cast to ``x``'s dtype (the
    runtime-channel tensor-core kernels rotate ``w`` as they pack it). The
    route and the shape's checks come from :func:`_conv_plan`, once a shape."""
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (N, H, W, C), got {tuple(x.shape)}")
    plan = _conv_plan(x.dtype, *x.shape, w.shape, rot, None)
    if plan.kernel != "tc":
        return _launch_runtime_channels(x, w, name, plan)
    _check(x, w.transpose(2, 3) if rot else w, name)
    return launch_conv3x3_mma(x, pack_weights((rot180_io(w) if rot else w).to(x.dtype)), name)


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return launch_conv3x3(x, w, "conv3x3_fwd")


def conv3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv3x3(x, w)``: the kernel on ``dy`` with ``rot180_io(w)``."""
    return launch_conv3x3(dy, w, "conv3x3_dx", rot=True)


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
