"""The port's 3x3 conv plain versions against the JAX package's Pallas conv
kernels, run in interpret mode on the CPU.

The CUDA kernel itself runs only on the card; there ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold it against these plain versions. Here each
public function takes its plain version because its tensors lie on the CPU.

Tolerance: rtol 1e-4 / atol 1e-5 (f32 on both sides; the nine tap products
are summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.conv3x3 import conv3x3 as jax_conv3x3  # noqa: E402
from sarssl_tpu.kernels.conv_s2d import conv3x3_s2d as jax_conv3x3_s2d  # noqa: E402
from sarssl_tpu.kernels.conv_s2d import expand_weights_s2d2 as jax_expand  # noqa: E402
from sarssl_torch.kernels import (conv3x3, conv3x3_plain, conv3x3_s2d,  # noqa: E402
                                  conv3x3_s2d_plain, expand_weights_s2d2)
from sarssl_torch.kernels.conv3x3 import (CHANNELS, Conv3x3Function,  # noqa: E402
                                          conv3x3_from_blocks, conv_kernel, dense_slots,
                                          launch_conv3x3, pack_weights, rot180_io,
                                          takes_tensor_cores)
from sarssl_torch.kernels import conv_s2d  # noqa: E402
from sarssl_torch.kernels.conv_s2d import S2D_SLOTS, s2d_chunk_taps  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)

# (name, JAX kernel in interpret mode, port's plain version, x shape)
CASES = {
    "conv3x3": (lambda x, w: jax_conv3x3(x, w, 8, True), conv3x3_plain, (2, 16, 16, 4)),
    "s2d": (lambda x, w: jax_conv3x3_s2d(x, w, 8, True), conv3x3_s2d_plain, (2, 8, 16, 4)),
}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], shape[-1])) * 0.2).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_pallas_interpret(case):
    jfn, plain, shape = CASES[case]
    x, w, _ = _inputs(shape, 0)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w)))
    out = plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_vjps_match_pallas_interpret(case):
    jfn, plain, shape = CASES[case]
    x, w, dy = _inputs(shape, 1)
    gx_ref, gw_ref = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * dy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (plain(xt, wt) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_formulas_match_pallas_interpret(case):
    """The kernels' ``autograd.Function`` with the plain version in place of
    the launchers: dx as the forward conv of dy with ``rot180_io(w)``, dW as
    ``weight_grad``."""
    jfn, plain, shape = CASES[case]
    x, w, dy = _inputs(shape, 2)
    gx_ref, gw_ref = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * dy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = Conv3x3Function.apply(xt, wt, plain, lambda d, k: plain(d, rot180_io(k)))
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), **TOL)


@pytest.mark.parametrize("c", [1, 4, 64])
def test_expand_weights_s2d2_equals_jax(c):
    w = np.random.default_rng(c).standard_normal((3, 3, c, c)).astype(np.float32)
    np.testing.assert_array_equal(expand_weights_s2d2(torch.from_numpy(w)).numpy(),
                                  np.asarray(jax_expand(jnp.asarray(w))))


def test_expand_weights_s2d2_passes_gradients_back():
    w = torch.randn(3, 3, 4, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    expand_weights_s2d2(w).sum().backward()
    # each original tap lands in the expanded kernel exactly twice (q = 0, 1)
    assert torch.equal(w.grad, torch.full_like(w, 2.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_take_plain_version_on_cpu(case):
    _, plain, shape = CASES[case]
    public = conv3x3 if case == "conv3x3" else conv3x3_s2d
    x, w, _ = _inputs(shape, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(public(xt, wt), plain(xt, wt))


def test_plain_takes_other_channel_counts_and_ragged_shapes():
    """C != Cout and odd H, W, against XLA's conv (the JAX reference)."""
    from sarssl_tpu.kernels.conv3x3 import reference_conv3x3

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    ref = np.asarray(reference_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               ref, **TOL)


def test_s2d_shape_gate_raises():
    w = torch.zeros(3, 3, 4, 4)
    with pytest.raises(ValueError, match="even width"):
        conv3x3_s2d(torch.zeros(1, 4, 5, 4), w)
    with pytest.raises(ValueError, match="C == Cout"):
        conv3x3_s2d(torch.zeros(1, 4, 6, 4), torch.zeros(3, 3, 4, 8))


# --- the tensor-core kernel's host side: block table, packing, routing ---

def _exists(slots):
    return [[[[v >= 0 for v in k] for k in j] for j in dh] for dh in slots]


@pytest.mark.parametrize("c", [1, 4, 64])
def test_s2d_block_table_equals_nonzero_pattern_of_expanded_weights(c):
    """The table is derived from the index rule; here it is held against the
    expanded weight of a random ``w`` (no entry of which is zero), block by
    block, and each existing block against the ``w[dh, dw]`` it names."""
    w = torch.from_numpy(np.random.default_rng(c).standard_normal((3, 3, c, c))
                         .astype(np.float32))
    assert bool((w != 0).all())
    w2 = expand_weights_s2d2(w)
    blocks = [[[[w2[dh, j, r * c:(r + 1) * c, q * c:(q + 1) * c] for q in range(2)]
                for r in range(2)] for j in range(3)] for dh in range(3)]
    nonzero = [[[[bool((b != 0).any()) for b in r] for r in j] for j in dh] for dh in blocks]
    assert nonzero == _exists(S2D_SLOTS)
    assert sum(v for dh in nonzero for j in dh for r in j for v in r) == 18
    flat = w.reshape(9, c, c)
    for dh in range(3):
        for j in range(3):
            for r in range(2):
                for q in range(2):
                    if S2D_SLOTS[dh][j][r][q] >= 0:
                        assert torch.equal(blocks[dh][j][r][q], flat[S2D_SLOTS[dh][j][r][q]])


def test_s2d_block_table_is_the_conv_of_the_views_chunks():
    """Output chunk 2p + q takes ``w[dh, dw]`` on chunk 2p + q + dw - 1, for
    both q: what lets the s2d launch walk the view's chunks as 64-channel
    pixels. A table whose parities disagree is refused."""
    assert s2d_chunk_taps(S2D_SLOTS) == [[(dw - 1, dh * 3 + dw) for dw in range(3)]
                                         for dh in range(3)]
    broken = [[[list(r) for r in j] for j in dh] for dh in S2D_SLOTS]
    broken[1][2][0][1] = -1
    with pytest.raises(ValueError, match="chunks"):
        s2d_chunk_taps(broken)


def test_s2d_chunk_walk_equals_masked_block_arithmetic():
    """The conv of the view's chunks taken as pixels (what the s2d launch
    hands the kernel) against the view's masked block arithmetic, bit for bit
    in f32: the same products in the same order."""
    x, w, _ = _inputs((2, 8, 16, 4), 8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    walked = conv3x3_from_blocks(xt, pack_weights(wt, 4), dense_slots(1), False)
    assert torch.equal(walked, _s2d_from_blocks(xt, wt))


def _s2d_from_blocks(x, w):
    B, H, W, C = x.shape
    return conv3x3_from_blocks(x.reshape(B, H, W // 2, 2 * C), w.reshape(1, 9, C, C),
                               S2D_SLOTS, True).reshape(x.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_masked_block_arithmetic_matches_plain_and_pallas_interpret(dtype):
    """The kernel's arithmetic, assembled tap by tap from the existing blocks
    only: f32 at rtol 1e-4 / atol 1e-5; bf16 operands (f32 sums, bf16 output
    rounding on both sides) at 1e-2 of the largest magnitude."""
    x, w, _ = _inputs((2, 8, 16, 4), 5)
    ref = np.asarray(jax_conv3x3_s2d(jnp.asarray(x, dtype=dtype), jnp.asarray(w, dtype=dtype),
                                     8, True)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdtype), torch.from_numpy(w).to(tdtype)
    out = _s2d_from_blocks(xt, wt)
    plain = conv3x3_s2d_plain(xt, wt)
    assert out.dtype == tdtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    else:
        scale = float(np.abs(ref).max())
        assert float((out.float() - plain.float()).abs().max()) <= 1e-2 * scale
        assert float(np.abs(out.float().numpy() - ref).max()) <= 1e-2 * scale


@pytest.mark.parametrize("channels", CHANNELS)
def test_dense_block_arithmetic_matches_plain(channels):
    C, Cout = channels
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, Cout)) * 0.1).astype(np.float32))
    out = conv3x3_from_blocks(x, pack_weights(w), dense_slots(C // 64), False)
    np.testing.assert_allclose(out.numpy(), conv3x3_plain(x, w).numpy(), **TOL)


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("flip", [False, True])
def test_pack_weights_holds_every_block_of_the_unpacked_weight(channels, flip):
    """``pack_weights`` (for dx: of ``rot180_io(w)``) against slices of the
    unpacked weight, block by block through ``dense_slots``."""
    C, Cout = channels
    w = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 3, C, Cout))
                         .astype(np.float32))
    if flip:
        w, (C, Cout) = rot180_io(w), (Cout, C)
    packed, slots = pack_weights(w), dense_slots(C // 64)
    assert packed.shape == (Cout // 64, 9 * (C // 64), 64, 64) and packed.is_contiguous()
    seen = set()
    for n in range(Cout // 64):
        for dh in range(3):
            for j in range(3):
                for k in range(C // 64):
                    slot = slots[dh][j][k][0]
                    seen.add(slot)
                    assert torch.equal(packed[n, slot],
                                       w[dh, j, k * 64:(k + 1) * 64, n * 64:(n + 1) * 64])
    assert seen == set(range(9 * (C // 64)))
    if C == 64:  # no second k-chunk: the kernel must find no block there
        assert all(slots[dh][j][1][0] < 0 for dh in range(3) for j in range(3))


def test_pack_weights_of_one_block_is_a_view():
    w = torch.zeros(3, 3, 64, 64)
    assert pack_weights(w).data_ptr() == w.data_ptr()


@pytest.mark.parametrize("channels", CHANNELS)
def test_routing_bf16_to_tensor_cores_f32_to_fma(channels):
    # bfloat16 at these pairs runs conv3x3_mma.cu; float32 no longer the FMA
    # kernels but conv3x3_tf32.cu, the 3xTF32 tensor-core kernel (the test
    # keeps the name it had when float32 went to the FMA kernels)
    assert takes_tensor_cores(torch.bfloat16, *channels)
    assert not takes_tensor_cores(torch.float32, *channels)
    assert not takes_tensor_cores(torch.float16, *channels)
    assert conv_kernel(torch.float32, *channels) == "tf32"
    assert conv_kernel(torch.bfloat16, *channels) == "tc"


@pytest.mark.parametrize("channels", [(32, 32), (64, 32), (256, 256), (64, 96)])
def test_routing_takes_no_other_channels(channels):
    assert not takes_tensor_cores(torch.bfloat16, *channels)


def test_routing_of_the_s2d_form(monkeypatch):
    """The s2d form runs conv3x3's kernel on x's own C channels: at C = 64
    bfloat16 the C = 64 tensor-core instance (as it walked the view's chunks
    before), C = 32 and 128 too now take conv3x3's routes at C (no longer the
    dense kernels on the 2C view); float32 the 3xTF32 tensor-core kernel at
    C; small images the image groups, in either dtype."""
    def route(x, w, name, rot=False):  # the kernel conv3x3's launcher would run
        routes.append(conv_kernel(x.dtype, x.shape[3], w.shape[2 if rot else 3], *x.shape[1:3]))
        return x

    monkeypatch.setattr(conv_s2d, "launch_conv3x3", route)
    for dtype, C, hw, kernel in ((torch.bfloat16, 64, (64, 64), "tc"),
                                 (torch.float32, 64, (64, 64), "tf32"),
                                 (torch.bfloat16, 32, (64, 64), "tc_any"),
                                 (torch.bfloat16, 128, (64, 64), "tc"),
                                 (torch.float32, 256, (64, 64), "tf32"),
                                 (torch.bfloat16, 64, (4, 8), "tc_groups")):
        routes = []
        x = torch.empty((2, *hw, C), dtype=dtype, device="meta")
        w = torch.empty((3, 3, C, C), dtype=dtype, device="meta")
        conv_s2d.conv3x3_s2d_fwd(x, w)
        conv_s2d.conv3x3_s2d_dx(x, w)
        assert routes == [kernel, kernel], (dtype, C, hw)


def test_launcher_raises_on_cpu_tensors():
    """A launcher never takes the plain version: it raises on what no kernel
    takes, a CPU tensor included."""
    with pytest.raises(ValueError, match="CUDA"):
        launch_conv3x3(torch.zeros(1, 4, 4, 64), torch.zeros(3, 3, 64, 64), "conv3x3_fwd")
