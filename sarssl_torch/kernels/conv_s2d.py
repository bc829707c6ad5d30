"""SAME 3x3 convolution over the W-space-to-depth view: the wrappers around
the conv kernels, the plain version and the ``autograd.Function``.

Replaces ``sarssl_tpu/kernels/conv_s2d.py::conv3x3_s2d`` (the Pallas kernel
``_conv_s2d``, its weights ``expand_weights_s2d2`` and its VJP). For x
(B, H, W, C) with W even and C == Cout, ``(B, H, W, C) -> (B, H, W/2, 2C)``
is a free row-major view, and the conv of x with w equals the SAME 3x3 conv
of that view with ``expand_weights_s2d2(w)`` (3, 3, 2C, 2C): the view's zero
padding is exactly the original's. Of the twelve C x C blocks of each kernel
row of the expanded weight six are zero by construction, and the six others
are the three blocks ``w[dh, dw]``, each used by both output parities.

  * :data:`S2D_SLOTS` is the table of the blocks that exist;
    :func:`s2d_chunk_taps` reads off it that output block q of view pixel p
    takes ``w[dh, 0..2]`` on the C-channel blocks 2p + q - 1 .. 2p + q + 1 of
    the view's row, whatever q and whatever C. Block for block that is the
    C-channel conv of x over the same memory (held once, below). So the
    launch is ``conv3x3``'s on x itself with w, at every C and dtype: it
    takes every route ``conv3x3.conv_kernel`` names (the tensor-core
    instances, the runtime-channel kernels, the FMA kernels, the image
    groups) and multiplies no zero block;
  * dx: the same on dy with ``rot180_io(w)``;
  * dW: the library filter gradient on the original layout, as in JAX.

:func:`expand_weights_s2d2` and :func:`conv3x3_s2d_plain` (the conv of the
view with the expanded weight) stay for the CPU and the tests; no launch on
the card takes them.

On no model path, like ``conv3x3``.
"""
from __future__ import annotations

import torch

from .conv3x3 import Conv3x3Function, conv3x3_plain, launch_conv3x3


def s2d_slots() -> list:
    """``[dh][j][r][q]`` -> ``dh * 3 + dw`` where block (view tap ``j``, input
    parity ``r``, output parity ``q``) of the expanded weight is ``w[dh, dw]``,
    -1 where it is zero by construction. The index rule of
    :func:`expand_weights_s2d2`, not a look at any weight's values."""
    slots = [[[[-1, -1], [-1, -1]] for _ in range(3)] for _ in range(3)]
    for dh in range(3):
        for q in range(2):
            for dw in range(3):
                s = q + dw - 1
                slots[dh][s // 2 + 1][s % 2][q] = dh * 3 + dw
    return slots


S2D_SLOTS = s2d_slots()


def s2d_chunk_taps(slots) -> list:
    """What a table of the view's C x C blocks means block by block: for each
    kernel row ``dh`` the ``(shift, slot)`` pairs such that output block ``c
    = 2p + q`` of a view row takes weight block ``slot`` on input block ``c +
    shift``. Raises if the two output parities disagree, i.e. if the table is
    not that of a conv over the blocks. Nothing here depends on C."""
    rows = []
    for dh in range(3):
        per_q = [sorted((2 * (j - 1) + r - q, slots[dh][j][r][q]) for j in range(3)
                        for r in range(2) if slots[dh][j][r][q] >= 0) for q in range(2)]
        if per_q[0] != per_q[1]:
            raise ValueError("the block table is not a conv over the view's C-channel chunks")
        rows.append(per_q[0])
    return rows


# The launches below run the conv of x itself with w. That is right only while
# the view's existing blocks are the taps of the C-channel blocks' own 3x3 conv
# with w's nine blocks in their order, at any C: held here, once.
if s2d_chunk_taps(S2D_SLOTS) != [[(dw - 1, dh * 3 + dw) for dw in range(3)] for dh in range(3)]:
    raise RuntimeError("S2D_SLOTS is not the table of the C-channel blocks' 3x3 conv")


def expand_weights_s2d2(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, C) HWIO -> (3, 3, 2C, 2C) acting on W-s2d-by-2 tensors.

    Output parity q and original tap dw map to (position delta, input
    parity): s = q + dw - 1, delta = s // 2, r = s % 2. Differentiable."""
    c = w.shape[2]
    w2 = w.new_zeros((3, 3, 2 * c, 2 * c))
    for q in range(2):
        for dw in range(3):
            s = q + dw - 1
            dpos, r = s // 2, s % 2
            w2[:, dpos + 1, r * c:(r + 1) * c, q * c:(q + 1) * c] = w[:, dw]
    return w2


def _check_shape(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_s2d: x must be (B, H, W, C) and w (3, 3, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[2] % 2:
        raise ValueError(f"conv3x3_s2d needs an even width W for its (B, H, W/2, 2C) "
                         f"view, got W={x.shape[2]}")
    if not w.shape[2] == w.shape[3] == x.shape[3]:
        raise ValueError(f"conv3x3_s2d needs C == Cout == x's channels, got w "
                         f"{tuple(w.shape)} for x {tuple(x.shape)}")


def conv3x3_s2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`conv3x3_plain` on the view with the expanded
    weights."""
    _check_shape(x, w)
    B, H, W, C = x.shape
    return conv3x3_plain(x.reshape(B, H, W // 2, 2 * C),
                         expand_weights_s2d2(w)).reshape(x.shape)


def _launch(x, w, name, rot=False):
    _check_shape(x, w)
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    # the conv of x with w (module note): x's own memory and shape
    return launch_conv3x3(x, w, name, rot=rot)


def conv3x3_s2d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _launch(x, w, "conv3x3_s2d_fwd")


def conv3x3_s2d_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv3x3_s2d(x, w)``: the forward launch on dy with
    ``rot180_io(w)``."""
    return _launch(dy, w, "conv3x3_s2d_dx", rot=True)


def conv3x3_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of ``x`` (B, H, W, C), W even, with ``w`` (3, 3, C, C),
    through the s2d view.

    CUDA tensors run the hand-written kernel (forward and dx); CPU tensors
    run :func:`conv3x3_s2d_plain`."""
    _check_shape(x, w)
    if x.device.type == "cpu":
        return conv3x3_s2d_plain(x, w)
    return Conv3x3Function.apply(x, w, conv3x3_s2d_fwd, conv3x3_s2d_dx)
