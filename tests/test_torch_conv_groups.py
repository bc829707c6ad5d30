"""The tensor-core convs' image groups and ``conv3x3_s2d``'s route, on the
CPU: the image-group mode's arithmetic in plain PyTorch against the Pallas
conv in interpret mode, the groups' cover of the output pixels, the routing
rule, and the s2d form's launch on x's own channels.

On the card the mode runs in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
phase ``edges``. Tolerance against the Pallas kernel: rtol 1e-4 / atol 1e-5
(f32 on both sides, the taps summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.conv3x3 import conv3x3 as jax_conv3x3  # noqa: E402
from sarssl_torch.kernels import conv_s2d  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (GROUP_PIXELS, conv3x3_from_image_groups,  # noqa: E402
                                          conv_kernel, conv_tiling, group_tap_rows,
                                          image_group_pixels, pack_weights_any)

META = torch.device("meta")


@pytest.mark.parametrize("N, H, W, C, Cout, G", [
    (7, 1, 1, 3, 64, 256),     # one group, 7 of its 256 images real
    (5, 2, 4, 13, 24, 32),
    (5, 3, 5, 64, 64, 17),
    (5, 2, 4, 3, 64, 2),       # three groups, the last with one image
    (7, 3, 5, 13, 24, 3)])     # the last group ragged
def test_image_group_conv_matches_pallas_interpret(N, H, W, C, Cout, G):
    """The image-group arithmetic (staged rows, a zero row for the taps
    outside an image, ``pack_weights_any``'s blocks, f32 sums) against
    ``sarssl_tpu``'s Pallas conv in interpret mode, f32 on both sides."""
    rng = np.random.default_rng(N * 1000 + H * 100 + C)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    ref = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(w), 8, True))
    out = conv3x3_from_image_groups(torch.from_numpy(x), pack_weights_any(torch.from_numpy(w)),
                                    Cout, G)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("N, H, W", [(1, 1, 1), (5, 1, 1), (300, 1, 1), (65600, 4, 8),
                                     (33, 3, 5), (9, 5, 17), (4099, 3, 5), (3, 16, 16)])
def test_image_groups_cover_every_output_pixel_once(N, H, W):
    """Every output pixel is written by exactly one row of one group tile at
    the routed G, and each tap of a row reads its own image's pixel or the
    zero row."""
    G = max(conv_tiling(torch.bfloat16, H, W, 64, 64), 1)
    pixels = image_group_pixels(N, H, W, G)
    assert pixels.shape == (-(-N // G), GROUP_PIXELS)
    written = pixels[pixels >= 0]
    assert torch.equal(written.sort().values, torch.arange(N * H * W))
    rows = group_tap_rows(H, W, G)
    p = torch.arange(GROUP_PIXELS)
    for tap in range(9):
        dh, dw = divmod(tap, 3)
        read = rows[:, tap] > 0
        q = rows[read, tap] - 1  # the staged pixel the tap reads
        assert torch.equal(q // (H * W), p[read] // (H * W))  # the same image
        assert torch.equal(q - p[read], torch.full_like(q, (dh - 1) * W + dw - 1))
    assert not rows[G * H * W:].any()


@pytest.mark.parametrize("H, W, G", [(4, 8, 8), (2, 4, 32), (1, 1, 256), (64, 64, 0),
                                     (256, 256, 0), (3, 5, 17), (16, 16, 0), (9, 21, 1)])
def test_conv_tiling_groups_small_images_only(H, W, G):
    """Image groups where a group tile holds more in-image outputs than the
    row tiles (3 -> 64 and 128 -> 128: 16 x 16 row tiles), row tiles from 16
    x 16 pixels on; float32 never (the FMA kernels)."""
    for C, Cout in ((3, 64), (128, 128), (13, 24)):
        assert conv_tiling(torch.bfloat16, H, W, C, Cout) == G
        assert conv_kernel(torch.bfloat16, C, Cout, H, W) == ("tc_groups" if G else
                                                              conv_kernel(torch.bfloat16, C, Cout))
        assert conv_tiling(torch.float32, H, W, C, Cout) == 0
    # C = 64 runs conv3x3_mma.cu's 16 x 32 row tiles: (16, 16) fills half of one
    assert conv_tiling(torch.bfloat16, 16, 16, 64, 64) == 1
    assert conv_tiling(torch.bfloat16, 16, 32, 64, 64) == 0


@pytest.mark.parametrize("C", [32, 64, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H, W", [(64, 64), (4, 8)])
def test_s2d_launch_is_the_conv_of_x(monkeypatch, C, dtype, H, W):
    """``conv3x3_s2d`` hands ``conv3x3``'s launcher x itself (C channels, not
    the 2C view) and w itself (not the expanded weight), dx with ``rot``: so
    it takes conv3x3's route at every C and dtype."""
    seen = []

    def launcher(x, w, name, rot=False):
        seen.append((tuple(x.shape), tuple(w.shape), name, rot))
        return torch.empty(x.shape[:3] + (w.shape[2] if rot else w.shape[3],), device=META)

    monkeypatch.setattr(conv_s2d, "launch_conv3x3", launcher)
    x = torch.empty((2, H, W, C), dtype=dtype, device=META)
    w = torch.empty((3, 3, C, C), dtype=dtype, device=META)
    assert conv_s2d.conv3x3_s2d_fwd(x, w).shape == x.shape
    assert conv_s2d.conv3x3_s2d_dx(x, w).shape == x.shape
    assert seen == [((2, H, W, C), (3, 3, C, C), "conv3x3_s2d_fwd", False),
                    ((2, H, W, C), (3, 3, C, C), "conv3x3_s2d_dx", True)]
