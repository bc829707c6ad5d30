"""The runtime-channel tensor-core convs' calls, on the CPU: the arithmetic of
one launch (the weight packed by the kernel's blocks as ``pack_weights_any``
/ ``pack_weights_tf32`` lay it out, then the conv in row tiles or image
groups) against ``sarssl_tpu``'s Pallas conv in interpret mode, and the
call's plan (``kernels/conv3x3.py::_conv_plan``: the route, G, the passes
and the C entry's arguments, worked out once a shape) against the rules it
caches.

On the card each call is one kernel launch (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase ``edges``). Tolerance against the Pallas kernel:
rtol 1e-4 / atol 1e-5 (``tests/test_torch_conv.py``: f32 on both sides, the
taps summed in another order).
"""
import functools
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.conv3x3 import conv3x3 as jax_conv3x3  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (GROUP_PIXELS, TF32_BLOCK, any_mma_passes,  # noqa: E402
                                          conv3x3_from_image_groups,
                                          conv3x3_from_padded_blocks, conv3x3_tf32x3,
                                          conv_kernel, conv_tiling, pack_weights_any,
                                          rot180_io, tf32_passes)

conv_mod = importlib.import_module("sarssl_torch.kernels.conv3x3")
TOL = dict(rtol=1e-4, atol=1e-5)
PAIRS = ((3, 64), (64, 48), (13, 24), (96, 160))
SHAPE = (5, 3, 5)  # small images: row tiles, and groups of up to 17 (the last one ragged)


@functools.lru_cache(maxsize=None)
def _case(C, Cout, kind):
    """(x, the weight the kernel packs, the Pallas conv in interpret mode):
    forward, x (N, H, W, C) with w; dx, dy (N, H, W, Cout) with
    ``rot180_io(w)``, which the dx kernel packs from w (its rot mode), as
    the JAX VJP convolves dy."""
    rng = np.random.default_rng(C * 1000 + Cout)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    wt = torch.from_numpy(w)
    if kind == "dx":
        wt = rot180_io(wt).contiguous()
    x = rng.standard_normal((*SHAPE, wt.shape[2])).astype(np.float32)
    ref = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wt.numpy()), SHAPE[1], True))
    return torch.from_numpy(x), wt, ref


@pytest.mark.parametrize("mode", ["rows", "groups"])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("C,Cout", PAIRS)
def test_one_launch_arithmetic_matches_pallas_interpret(C, Cout, kind, mode):
    """bfloat16's arithmetic (``pack_weights_any``'s blocks, row tiles or
    tiles of G whole images) and float32's (3xTF32 on ``pack_weights_tf32``'s
    hi / lo blocks), forward and dx, at the edges' channel pairs."""
    x, wt, ref = _case(C, Cout, kind)
    cout = wt.shape[3]
    G = GROUP_PIXELS // (SHAPE[1] * SHAPE[2]) if mode == "groups" else 0
    if G:
        bf16 = conv3x3_from_image_groups(x, pack_weights_any(wt), cout, G)
    else:
        bf16 = conv3x3_from_padded_blocks(x, pack_weights_any(wt), cout)
    np.testing.assert_allclose(bf16.numpy(), ref, **TOL)
    np.testing.assert_allclose(conv3x3_tf32x3(x, wt, G).numpy(), ref, **TOL)


META = torch.device("meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_is_the_rules_it_caches(dtype):
    """For a grid of shapes, both passes: the plan names ``conv_kernel``'s
    kernel and ``conv_tiling``'s G, Cout, the scratch the packed weight
    fills (``pack_weights_any`` / ``pack_weights_tf32``'s shape), the counter
    suffix and the C entry's (N, H, W, C, Cout, NB, rot, G); a second call is
    the cache's."""
    conv_mod._conv_plan.cache_clear()
    shapes = ((1, 1, 1), (5, 3, 5), (4099, 3, 5), (65600, 4, 8), (2, 19, 38), (16, 64, 64),
              (1, 17, 19), (3, 16, 16))
    for (N, H, W), (C, Cout), rot in itertools.product(shapes, PAIRS + ((64, 64), (256, 256)),
                                                       (False, True)):
        cin, cout = (Cout, C) if rot else (C, Cout)  # dx: dy's Cout channels -> C
        wshape = torch.Size((3, 3, C, Cout))  # the weight as it is: dx rotates it as it packs
        plan = conv_mod._conv_plan(dtype, N, H, W, cin, wshape, rot, None)
        assert conv_mod._conv_plan(dtype, N, H, W, cin, wshape, rot, None) is plan
        G = conv_tiling(dtype, H, W, cin, cout)
        assert plan.kernel == conv_kernel(dtype, cin, cout, H, W) and plan.groups == G
        assert plan.cout == cout
        if plan.kernel == "tc":  # conv3x3_mma.cu: the weight packed by torch, no plan
            continue
        if dtype == torch.float32:
            passes, nb = tf32_passes(cout, cin)
            scratch = (passes, -(-cin // TF32_BLOCK), 2, 9, nb, TF32_BLOCK)
            suffix = "_tf32_groups" if G else "_tf32"
        else:
            passes, nb = any_mma_passes(cout)
            scratch = tuple(pack_weights_any(torch.empty((3, 3, cin, cout), device=META)).shape)
            suffix = "_tc_groups" if G else "_tc_any"
        assert plan.scratch == scratch and plan.suffix == suffix
        assert plan.scratch_bytes == int(np.prod(scratch)) * (4 if dtype == torch.float32 else 2)
        assert tuple(plan.call) == (N, H, W, cin, cout, nb, int(rot), G)
    info = conv_mod._conv_plan.cache_info()
    assert info.hits == info.misses


def test_plan_refuses_what_the_kernels_do_not_take():
    """Shapes the kernels do not take raise ``ValueError`` from the plan, and
    are not cached: a wrong weight, an empty dimension, a group too large for
    a tile, a dtype the kernels have no instance of."""
    plan = conv_mod._conv_plan
    with pytest.raises(ValueError, match="w"):
        plan(torch.float32, 1, 4, 8, 13, torch.Size((3, 3, 12, 24)), False, None)
    with pytest.raises(ValueError, match="w"):
        plan(torch.float32, 1, 4, 8, 13, torch.Size((3, 3, 13, 24)), True, None)
    with pytest.raises(ValueError, match="positive"):
        plan(torch.bfloat16, 0, 4, 8, 13, torch.Size((3, 3, 13, 24)), False, None)
    with pytest.raises(ValueError, match="tile"):
        plan(torch.bfloat16, 9, 4, 8, 13, torch.Size((3, 3, 13, 24)), False, 9)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        plan(torch.float16, 1, 4, 8, 13, torch.Size((3, 3, 13, 24)), False, None)


def test_workspace_keeps_small_scratch_per_stream_only():
    """The packed weight's scratch: one a (device, stream), grown as a call
    needs and kept up to ``_WORKSPACE_KEPT`` bytes; a larger one is the
    call's own (never kept)."""
    x = torch.empty(1)
    conv_mod._WORKSPACES.clear()
    a = conv_mod._workspace(x, 7, 1000)
    assert conv_mod._workspace(x, 7, 500) is a and a.numel() >= 1000
    b = conv_mod._workspace(x, 7, 4000)
    assert b.numel() >= 4000 and conv_mod._workspace(x, 7, 1000) is b
    assert conv_mod._workspace(x, 8, 1000) is not b  # another stream's own
    big = conv_mod._WORKSPACE_KEPT + 1
    c = conv_mod._workspace(x, 7, big)
    assert c.numel() == big and conv_mod._workspace(x, 7, 1000) is b
    assert all(w.numel() <= conv_mod._WORKSPACE_KEPT for w in conv_mod._WORKSPACES.values())
    conv_mod._WORKSPACES.clear()
