"""SAME 3x3 convolution, NHWC x HWIO: the CUDA kernels, their plain PyTorch
version and the ``autograd.Function`` that joins them.

Replaces ``sarssl_tpu/kernels/conv3x3.py::conv3x3`` (the Pallas kernel
``_pallas_conv3x3`` and its VJP):

  * forward: ``y = conv(x, w)`` with f32 accumulation, ``y`` in ``x``'s dtype;
  * dx: the same kernel on ``dy`` with ``w`` rotated 180 degrees and its
    in/out channels swapped (``rot180_io``), as the JAX VJP does;
  * dW: a library filter gradient (``torch.nn.grad.conv2d_weight``), as the
    JAX package leaves dW to XLA outside Pallas.

Four kernels, chosen by dtype and channels (:func:`conv_kernel`):

* ``csrc/conv3x3_mma.cu``: bfloat16 at the channel pairs of ``CHANNELS``. An
  implicit GEMM on the tensor cores (``wgmma``). It multiplies blocks of
  64 x 64 channels: the wrapper packs the weight into those blocks
  (:func:`pack_weights`), in the order :func:`dense_slots` names.
  :func:`conv3x3_from_blocks` repeats that arithmetic in plain PyTorch, for
  any table of blocks (the s2d form's is in ``conv_s2d.py``).
* ``csrc/conv3x3.cu``: float32 at the same pairs, as f32 FMAs. A float32
  product on the tensor cores would be TF32 and miss the 1e-4 tolerance.
* ``csrc/conv3x3_any_mma.cu``: bfloat16 at every other (C, Cout), as the
  Pallas kernel takes any: the tensor-core design with C and Cout at run
  time, in K chunks of 64 input channels and passes of NB output channels
  (:func:`any_mma_passes`); a kernel of its own packs the weight into those
  blocks, zero-padded, in the same call (:func:`pack_weights_any` is its
  plain version; for dx it rotates the weight as it packs it), and
  :func:`conv3x3_from_padded_blocks` repeats the conv's arithmetic in plain
  PyTorch.
* ``csrc/conv3x3.cu``'s ``conv3x3_any_kernel``: float32 at every other (C,
  Cout): the f32 FMA design with the channel counts as runtime arguments.
  In bfloat16 it is launched only directly (:func:`launch_conv3x3_any`), as
  the yardstick of ``conv3x3_any_mma.cu``.

Images smaller than a row tile (:func:`conv_tiling`): bfloat16 at any (C,
Cout) runs ``conv3x3_any_mma.cu``'s image groups (built as a library of their
own from ``csrc/conv3x3_any_mma_groups.cu``), a tile of G whole images,
G = floor(256 / (H W)), staged without a halo; each pixel's taps are rows of
the staged group or a zero row (:func:`group_tap_rows`), and
:func:`conv3x3_from_image_groups` repeats that arithmetic in plain PyTorch.

Any H and W: the FMA kernels' pixel tiles lie on the grid's x dimension.
Any N: their grid holds 65535 images in its y dimension, so they
launch runs of at most that many (:func:`conv_batch_chunks`); the
tensor-core kernels walk their tiles in a loop and take any N in one launch.

For a CUDA tensor the wrapper launches the kernel it names here or raises.
The kernels are on no model path: the port's ``CNNFrontEnd`` keeps
``F.conv2d``, as the JAX front end keeps the XLA conv.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import GRID_YZ, check_cuda_status, launches, load_library

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
    ``conv3x3.cu``'s instances, everything else its runtime-channel kernel
    (:func:`conv_kernel`)."""
    return dtype == torch.bfloat16 and (C, Cout) in CHANNELS


GROUP_PIXELS = 256  # output pixels of an image-group tile (conv3x3_any_mma.cu's GM)


def conv_tiling(dtype: torch.dtype, H: int, W: int, C: int, Cout: int) -> int:
    """How many images a tile of the tensor-core kernels holds for CUDA
    tensors of this dtype and shape: G = floor(256 / (H W)) whole images
    (``conv3x3_any_mma.cu``'s image groups), or 0 for row tiles (of 16 x 32
    pixels at ``conv3x3_mma.cu``'s C = 64 instance, else 16 x 16).

    The rule: image groups wherever the share of a group tile's 256 outputs
    inside an image, G H W / 256, exceeds the row tiles' share, H W over the
    pixels of the tiles that cover one image; row tiles at a tie, where their
    fragments serve three output rows each. So (4, 8) takes groups of 8
    (1/8 of a 16 x 16 tile inside, 1/16 of a 16 x 32 one), (1, 1) groups of
    256, and (16, 16) or anything past 256 pixels row tiles (at C = 64 (16,
    16) fills half of a 16 x 32 tile: groups of one). float32 runs the FMA
    kernels: 0."""
    if dtype != torch.bfloat16 or H * W > GROUP_PIXELS:
        return 0
    th, tw = (16, 32) if takes_tensor_cores(dtype, C, Cout) and C == BLOCK else (16, 16)
    rows_share = H * W / (-(-H // th) * th * -(-W // tw) * tw)
    G = GROUP_PIXELS // (H * W)
    return G if G * H * W / GROUP_PIXELS > rows_share else 0


def conv_kernel(dtype: torch.dtype, C: int, Cout: int, H: int | None = None,
                W: int | None = None) -> str:
    """The kernel the conv wrappers run for CUDA tensors of this dtype and
    these channels: ``"tc"`` (``conv3x3_mma.cu``), ``"tc_any"``
    (``conv3x3_any_mma.cu``'s row tiles, bfloat16 at every other pair),
    ``"fma"`` (``conv3x3.cu``'s instances, float32 at ``CHANNELS``) or
    ``"any"`` (its runtime-channel kernel, float32 at every other pair). Given
    H and W, ``"tc_groups"`` (``conv3x3_any_mma.cu``'s image groups, bfloat16
    at any pair) where :func:`conv_tiling` names groups."""
    if H is not None and conv_tiling(dtype, H, W, C, Cout):
        return "tc_groups"
    if takes_tensor_cores(dtype, C, Cout):
        return "tc"
    if dtype == torch.bfloat16:
        return "tc_any"
    if (C, Cout) in CHANNELS:
        return "fma"
    return "any"


def conv_batch_chunks(N: int) -> list:
    """``(n0, nn)`` launches of an FMA conv kernel that cover N images: at
    most :data:`GRID_YZ` a launch (the grid's y dimension)."""
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
    ``pack_weights_kernel``."""
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
    for p in range(passes):
        for k in range(kc):
            for tap in range(9):
                a = staged[:, rows[:, tap], k * blk:(k + 1) * blk]
                out[..., p * nb:(p + 1) * nb] += a @ packed[p, k, tap].float().T
    y = torch.empty((N * H * W, Cout), dtype=torch.float32, device=x.device)
    y[pixels[real]] = out[real][:, :Cout]
    return y.reshape(N, H, W, Cout).to(x.dtype)


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
    lib.conv3x3_any_mma.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.conv3x3_any_mma.restype = _I
    lib.conv3x3_any_mma_smem_bytes.argtypes = [_I, _I]
    lib.conv3x3_any_mma_smem_bytes.restype = _I
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


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
    (3, 3, C, Cout), cast to ``x``'s dtype; count one launch of ``name``. It
    takes bfloat16 too: the tensor-core kernel is timed against it."""
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
    The conv wrappers take it for float32; in bfloat16 it is the yardstick
    of ``conv3x3_any_mma.cu``, launched directly."""
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


def launch_conv3x3_any_mma(x: torch.Tensor, w: torch.Tensor, name: str,
                           rot: bool = False, groups: int = 0) -> torch.Tensor:
    """Run the runtime-channel tensor-core kernel (``conv3x3_any_mma.cu``) on
    ``x`` (N, H, W, C) bfloat16 contiguous with ``w`` (3, 3, C, Cout), or
    with ``rot`` ``rot180_io(w)`` of ``w`` (3, 3, Cout, C), cast to bfloat16:
    one call that packs the weight (as :func:`pack_weights_any` does) and
    runs the conv in row tiles, or with ``groups`` = G > 0 in tiles of G
    whole images (G H W <= 256); count one launch of ``name`` and one of
    ``name + "_tc_any"`` (row tiles) or ``name + "_tc_groups"``."""
    wk = w.to(torch.bfloat16).contiguous()
    if not (x.is_cuda and wk.device == x.device and x.dtype == torch.bfloat16
            and x.is_contiguous()):
        raise ValueError(f"{name}: the tensor-core kernel takes contiguous bfloat16 CUDA "
                         f"tensors on one device")
    N, H, W, C = x.shape
    if wk.ndim != 4 or tuple(wk.shape[:2]) != (3, 3) or wk.shape[3 if rot else 2] != C:
        raise ValueError(f"{name}: {tuple(w.shape)} is not the weight of C = {C}")
    if groups < 0 or groups * H * W > GROUP_PIXELS:
        raise ValueError(f"{name}: a tile holds at most {GROUP_PIXELS} pixels, got {groups} "
                         f"images of {H} x {W}")
    cout = wk.shape[2] if rot else wk.shape[3]
    if C % 8 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core kernel takes x 16-byte aligned where "
                         f"C % 8 == 0")
    passes, nb = any_mma_passes(cout)
    lib = _library_any_mma(groups > 0)
    packed = torch.empty((passes, -(-C // BLOCK), 9, nb, BLOCK), dtype=x.dtype, device=x.device)
    y = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    code = lib.conv3x3_any_mma(x.data_ptr(), wk.data_ptr(), packed.data_ptr(), y.data_ptr(), N,
                               H, W, C, cout, nb, int(rot), groups,
                               torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_status(lib, code, name)
    launches[name] += 1
    launches[name + ("_tc_groups" if groups else "_tc_any")] += 1
    return y


def launch_conv3x3(x: torch.Tensor, w: torch.Tensor, name: str,
                   rot: bool = False) -> torch.Tensor:
    """Run the kernel that :func:`conv_kernel` names on CUDA tensors, ``x``
    (N, H, W, C) contiguous and ``w`` (3, 3, C, Cout), or with ``rot``
    ``rot180_io(w)`` of ``w`` (3, 3, Cout, C), cast to ``x``'s dtype (the
    runtime-channel tensor-core kernel rotates ``w`` as it packs it)."""
    _check(x, w.transpose(2, 3) if rot else w, name)  # rot180_io(w)'s shape, no copy
    _, H, W, C = x.shape
    cout = w.shape[2] if rot else w.shape[3]
    kernel = conv_kernel(x.dtype, C, cout, H, W)
    if kernel == "tc_groups":
        return launch_conv3x3_any_mma(x, w, name, rot=rot,
                                      groups=conv_tiling(x.dtype, H, W, C, cout))
    if kernel == "tc_any":
        return launch_conv3x3_any_mma(x, w, name, rot=rot)
    if rot:
        w = rot180_io(w)
    if kernel == "tc":
        return launch_conv3x3_mma(x, pack_weights(w.to(x.dtype)), name)
    if kernel == "fma":
        return launch_conv3x3_fma(x, w, name)
    return launch_conv3x3_any(x, w, name)


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
