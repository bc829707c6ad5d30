"""SAME 3x3 convolution over the W-space-to-depth view: the wrappers around
``csrc/conv3x3.cu``, the plain version and the ``autograd.Function``.

Replaces ``sarssl_tpu/kernels/conv_s2d.py::conv3x3_s2d`` (the Pallas kernel
``_conv_s2d``, its weights ``expand_weights_s2d2`` and its VJP). For x
(B, H, W, C) with W even and C == Cout, ``(B, H, W, C) -> (B, H, W/2, 2C)``
is a free row-major view, and the conv of x with w equals the SAME 3x3 conv
of that view with ``expand_weights_s2d2(w)`` (3, 3, 2C, 2C), half of whose
entries are zero: the view's zero padding is exactly the original's. So the
kernel is ``csrc/conv3x3.cu`` at 2C channels, doing twice the raw FLOPs.

  * forward: the kernel on the view with the expanded weights;
  * dx: the kernel on dy's view with ``expand_weights_s2d2(rot180_io(w))``;
  * dW: the library filter gradient on the original layout, as in JAX.

On no model path, like ``conv3x3``.
"""
from __future__ import annotations

import torch

from .conv3x3 import Conv3x3Function, conv3x3_plain, launch_conv3x3, rot180_io


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


def _view(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.view(B, H, W // 2, 2 * C)


def conv3x3_s2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`conv3x3_plain` on the view with the expanded
    weights."""
    _check_shape(x, w)
    B, H, W, C = x.shape
    return conv3x3_plain(x.reshape(B, H, W // 2, 2 * C),
                         expand_weights_s2d2(w)).reshape(x.shape)


def _launch(x, w, name):
    _check_shape(x, w)
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    return launch_conv3x3(_view(x), expand_weights_s2d2(w), name).view(x.shape)


def conv3x3_s2d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _launch(x, w, "conv3x3_s2d_fwd")


def conv3x3_s2d_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv3x3_s2d(x, w)``: the kernel on dy's view with
    ``expand_weights_s2d2(rot180_io(w))``."""
    return _launch(dy, rot180_io(w), "conv3x3_s2d_dx")


def conv3x3_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of ``x`` (B, H, W, C), W even, with ``w`` (3, 3, C, C),
    through the s2d view.

    CUDA tensors run the hand-written kernel (forward and dx); CPU tensors
    run :func:`conv3x3_s2d_plain`."""
    _check_shape(x, w)
    if x.device.type == "cpu":
        return conv3x3_s2d_plain(x, w)
    return Conv3x3Function.apply(x, w, conv3x3_s2d_fwd, conv3x3_s2d_dx)
