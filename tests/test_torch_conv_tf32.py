"""The float32 conv on the tensor cores as 3xTF32 (``csrc/conv3x3_tf32.cu``),
on the CPU: the TF32 split by bit operations, the packed weight's hi and lo
blocks, the kernel's arithmetic in plain PyTorch (row tiles and image groups,
forward and dx) against ``sarssl_tpu``'s Pallas conv in interpret mode, and
the float32 routing.

The kernel itself runs only on the card: ``tests/test_torch_gpu.py``,
``scripts/check_conv_tf32.py`` and ``chip_smoke.py`` hold it against these
plain versions. Tolerance against the Pallas kernel: rtol 1e-4 / atol 1e-5,
as ``tests/test_torch_conv.py`` (f32 on both sides; each product is three
TF32 products, about 2^-22 of it left out, and the sums run in another order).
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.conv3x3 import conv3x3 as jax_conv3x3  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (GROUP_PIXELS, TF32_BLOCK,  # noqa: E402
                                          conv3x3_tf32x3, conv_kernel, conv_tiling,
                                          launch_conv3x3, launch_conv3x3_tf32,
                                          pack_weights_tf32, rot180_io, split_tf32,
                                          tf32_passes, tf32_rna)

# the module (the package exports the function of the same name)
conv_mod = importlib.import_module("sarssl_torch.kernels.conv3x3")
TOL = dict(rtol=1e-4, atol=1e-5)
META = torch.device("meta")


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_tf32_split_clears_the_low_bits_and_recovers_x():
    """hi and lo carry 10 mantissa bits (the 13 low bits zero), and hi + lo
    is within 2^-22 of x, over magnitudes from 2^-60 to 2^60."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000) * 2.0 ** rng.integers(-60, 60, 20000))
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())


def test_tf32_rounding_ties_away_from_zero():
    """``cvt.rna``: a value halfway between two TF32 values goes to the one
    farther from zero (not to the even one), either sign; below halfway it
    goes down, above it up."""
    one, ulp = 1.0, 2.0 ** -10
    cases = [(one + ulp / 2, one + ulp),                     # tie: 1 is even, away wins
             (one + 3 * ulp / 2, one + 2 * ulp),             # tie next to an odd value
             (one + ulp / 2 - 2.0 ** -23, one),              # just below the tie
             (one + ulp / 2 + 2.0 ** -23, one + ulp),        # just above
             (2.0 ** 100 * (one + ulp / 2), 2.0 ** 100 * (one + ulp)),
             (0.0, 0.0)]
    for x, want in cases:
        for sign in (1.0, -1.0):
            got = tf32_rna(torch.tensor([sign * x], dtype=torch.float32))
            assert got.item() == sign * want, (sign * x, got.item())


@pytest.mark.parametrize("C, Cout, passes, nb", [
    (64, 3, 1, 8), (64, 24, 1, 24), (33, 32, 1, 32), (64, 33, 2, 24), (40, 48, 2, 24),
    (64, 64, 2, 32), (96, 160, 5, 32), (256, 256, 8, 32), (2048, 7, 1, 8),
    (3, 64, 1, 64), (32, 64, 1, 64), (13, 24, 1, 24), (3, 65, 2, 40), (32, 160, 3, 56),
    (1, 3, 1, 8)])
def test_tf32_passes_cover_cout(C, Cout, passes, nb):
    """ceil(Cout / 32) passes of NB channels, NB a multiple of 8 up to 32,
    at most 7 past Cout a pass; where C <= 32 (one K chunk) ceil(Cout / 64)
    passes of NB up to 64."""
    assert tf32_passes(Cout, C) == (passes, nb)
    top = 64 if C <= TF32_BLOCK else 32
    assert nb % 8 == 0 and nb <= top and 0 <= passes * nb - Cout < 8 * passes


@pytest.mark.parametrize("C, Cout", [(3, 64), (13, 24), (64, 48), (70, 33), (32, 160)])
def test_pack_weights_tf32_holds_the_split_blocks(C, Cout):
    """(passes, ceil(C / 32), 2, 9, NB, 32): [.., 0, ..] the TF32 hi of the
    weight's [co][ci] blocks, [.., 1, ..] their lo; hi + lo within 2^-22 of
    w; zero past C and Cout."""
    w = torch.randn((3, 3, C, Cout), generator=torch.Generator().manual_seed(C))
    passes, nb = tf32_passes(Cout, C)
    kc = -(-C // TF32_BLOCK)
    packed = pack_weights_tf32(w)
    assert tuple(packed.shape) == (passes, kc, 2, 9, nb, TF32_BLOCK)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    flat = packed.permute(2, 3, 1, 5, 0, 4).reshape(2, 9, kc * TF32_BLOCK, passes * nb)
    hi, lo = flat[0], flat[1]
    assert torch.equal(hi[:, :C, :Cout], tf32_rna(w.reshape(9, C, Cout)))
    assert bool(((hi[:, :C, :Cout].double() + lo[:, :C, :Cout].double()
                  - w.reshape(9, C, Cout).double()).abs()
                 <= 2.0 ** -22 * w.reshape(9, C, Cout).double().abs()).all())
    assert not flat[:, :, C:].any() and not flat[:, :, :, Cout:].any()


# one input shape for both layouts: 3 images of 3 x 5, in row tiles (one 16 x
# 16 tile an image) or in image groups of 2 (the last group ragged: one image
# of two)
SHAPE = (3, 3, 5)
LAYOUTS = {"rows": 0, "groups": 2}


@functools.lru_cache(maxsize=None)
def _pallas_case(C, Cout):
    """Seeded x, w, dy and the Pallas conv's forward and dx (its VJP) in
    interpret mode, once a channel pair for both layouts."""
    rng = np.random.default_rng(C * 1000 + Cout)
    x = rng.standard_normal(SHAPE + (C,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    dy = rng.standard_normal(SHAPE + (Cout,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_conv3x3(a, jnp.asarray(w), 8, True), jnp.asarray(x))
    return x, w, dy, np.asarray(ref), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("C, Cout", [(3, 64), (64, 64), (13, 24), (256, 256)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tf32x3_conv_matches_pallas_interpret(C, Cout, layout):
    """The 3xTF32 arithmetic (split operands, the three products summed in
    f32, through the row-tile or the image-group layout) against the Pallas
    conv in interpret mode, forward and dx (the conv of dy with the rotated
    weights, as the JAX VJP takes it)."""
    G = LAYOUTS[layout]
    x, w, dy, ref, ref_dx = _pallas_case(C, Cout)
    wt = torch.from_numpy(w)
    out = conv3x3_tf32x3(torch.from_numpy(x), wt, G)
    dx = conv3x3_tf32x3(torch.from_numpy(dy), rot180_io(wt), G)
    assert out.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)


def test_tf32x3_conv_differs_from_one_tf32_product():
    """The lo terms matter: one TF32 product (hi hi) misses the f32
    tolerance where the three hold it, so the test above tells them apart."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 8, 12, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 64, 64)) / 24).astype(np.float32))
    ref = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                     w.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    packed = pack_weights_tf32(w)
    one = conv_mod.conv3x3_from_padded_blocks(tf32_rna(x), packed[:, :, 0], 64)
    peak = ref.abs().max()
    assert float((conv3x3_tf32x3(x, w).double() - ref).abs().max() / peak) < 1e-6
    assert float((one.double() - ref).abs().max() / peak) > 1e-4


@pytest.mark.parametrize("H, W, G", [(4, 8, 8), (2, 4, 32), (1, 1, 256), (3, 5, 17), (9, 21, 1),
                                     (16, 16, 0), (64, 64, 0)])
def test_float32_routing_takes_the_tf32_kernel(H, W, G):
    """float32 runs ``conv3x3_tf32.cu`` at every channel pair: its image
    groups where a group tile holds more in-image outputs than a 16 x 16 row
    tile (the bfloat16 rule), else its row tiles; never conv3x3.cu's FMA
    kernels."""
    for C, Cout in ((3, 64), (64, 64), (13, 24), (128, 128), (256, 256)):
        assert conv_tiling(torch.float32, H, W, C, Cout) == G
        assert conv_kernel(torch.float32, C, Cout, H, W) == ("tf32_groups" if G else "tf32")
        assert conv_kernel(torch.float32, C, Cout) == "tf32"
        assert G * H * W <= GROUP_PIXELS


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("hw", [(4, 8), (64, 64)])
def test_launcher_hands_float32_to_the_tf32_kernel(monkeypatch, rot, hw):
    """``launch_conv3x3`` hands float32 to the 3xTF32 kernel's launch with the
    routed G and ``rot`` (the kernel rotates the weight as it packs it): the
    plan it launches names ``conv3x3_tf32.cu``'s row tiles or groups, and its
    C call carries (N, H, W, C, Cout, NB, rot, G)."""
    seen = []

    def tf32(x, w, name, plan):
        seen.append((name, plan.kernel, tuple(plan.call), plan.suffix))
        return x

    monkeypatch.setattr(conv_mod, "_launch_runtime_channels", tf32)
    x = torch.empty((3, *hw, 13), device=META)
    w = torch.empty((3, 3, 24, 13) if rot else (3, 3, 13, 24), device=META)
    launch_conv3x3(x, w, "conv3x3_dx" if rot else "conv3x3_fwd", rot=rot)
    G = conv_tiling(torch.float32, *hw, 13, 24)
    assert seen == [("conv3x3_dx" if rot else "conv3x3_fwd", "tf32_groups" if G else "tf32",
                     (3, *hw, 13, 24, tf32_passes(24, 13)[1], int(rot), G),
                     "_tf32_groups" if G else "_tf32")]


def test_tf32_launcher_refuses_what_the_kernel_does_not_take():
    """CPU tensors (the wrapper takes the plain version for those, never the
    launcher) and bfloat16 raise."""
    x, w = torch.zeros((1, 4, 8, 13)), torch.zeros((3, 3, 13, 24))
    with pytest.raises(ValueError, match="CUDA"):
        launch_conv3x3_tf32(x, w, "conv3x3_fwd")
    with pytest.raises(ValueError, match="CUDA"):
        launch_conv3x3_tf32(x.to(META).bfloat16(), w.to(META), "conv3x3_fwd")
