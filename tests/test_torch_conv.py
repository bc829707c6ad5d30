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
from sarssl_torch.kernels.conv3x3 import Conv3x3Function, rot180_io  # noqa: E402

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
