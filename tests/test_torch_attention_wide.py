"""Head dims above 256 on the tensor-core attention, on the CPU.

Past 256 ``fused_attention`` runs the wide instance of either set of kernels
(``kernels/attention.py``): its head dims are the multiples of
``WIDE_CHUNK`` (64) from 256 on, and every other D pads to the next of them,
as smaller head dims pad to the next instance. The kernels run only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here the routing, the
padding and the slicing are driven with ``attention_plain`` as the launcher
and held against the JAX package's Pallas kernel in interpret mode, output
and all four gradients, and the port's ``RelPosSelfAttention`` at a head dim
of 512 against the JAX module.

Tolerances: 1e-4 of the largest magnitude of the Pallas result, and rtol 1e-4
for the module (atol 1e-5 of the largest output, of the largest gradient):
f32 on both sides, the sums run in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_tpu.models.conformer import RelPosSelfAttention as JAttn  # noqa: E402
from sarssl_torch.kernels import attention as att  # noqa: E402
from sarssl_torch.kernels import attention_plain  # noqa: E402
from sarssl_torch.models import RelPosSelfAttention  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402

TOL = 1e-4
SEED = 0x9E3779B9


@pytest.mark.parametrize("D,Dp", [(257, 320), (320, 320), (512, 512), (1000, 1024)])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_route_names_the_tensor_cores_past_head_dim_256(D, Dp, dtype, route):
    """Past 256 both sets run their wide instance at the next multiple of
    its chunk, at any L."""
    for L in (1, 33, 256, 257):
        assert att.attention_route(dtype, L, D) == route
    assert att.padded_head_dim(D) == Dp
    assert Dp % att.WIDE_CHUNK == 0


def test_no_head_dim_raises():
    """Every head dim from 1 to 4096 has a route and an instance at or above
    it; the instances up to 256 keep theirs."""
    for D in range(1, 4097):
        Dp = att.padded_head_dim(D)
        assert D <= Dp and att.attention_route(torch.float32, 64, D) == "tf32x3"
        assert att.attention_route(torch.bfloat16, 64, D) == "tc"
        assert (Dp in att.HEAD_DIMS) == (D <= 256)
        if D > 256:
            assert Dp - D < att.WIDE_CHUNK
        else:
            assert all(h < D for h in att.HEAD_DIMS if h < Dp)


def _plain_fwd(qu, k, v, bias, *args):
    return attention_plain(qu, k, v, bias, *args), None


def _inputs(seed, shape):
    B, H, L, D = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]


@pytest.mark.parametrize("D", [300, 320, 512])
def test_wide_padded_route_matches_pallas_interpret(D):
    """The pad and slice around a launch at ``padded_head_dim(D)`` (the wide
    instance's 320, 320 and 512; here ``attention_plain`` stands in for it), rate
    0, B = 1, H = 2, L = 33, against the Pallas kernel in interpret mode and
    its ``_fa_bwd`` at D itself; the launch's padded columns of out, dqu, dk
    and dv are exactly 0."""
    qu, k, v, g, bias = _inputs(D, (1, 2, 33, D))
    scale = 1.0 / np.sqrt(2 * D)  # the model's 1 / sqrt(d_model)
    args = (SEED, scale, 0.0)
    out, lse, padded = att.attention_fwd_padded(_plain_fwd, qu, k, v, bias, *args)
    Dp = att.padded_head_dim(D)
    assert all(t.shape[-1] == Dp for t in padded) and out.shape == qu.shape
    full = []

    def bwd(qu, k, v, bias, g, out, lse, *a):
        xs = [t.detach().clone().requires_grad_() for t in (qu, k, v, bias)]
        with torch.enable_grad():
            full.extend(torch.autograd.grad(attention_plain(*xs, *a), xs, g))
        return full[:4]

    grads = att.attention_bwd_padded(bwd, padded, bias, g, lse, *args)
    for t in (padded[3], *full[:3]):  # out, dqu, dk, dv at Dp
        assert torch.count_nonzero(t[..., D:]) == 0
    xs = tuple(jnp.asarray(t.numpy()) for t in (qu, k, v, bias))
    seed0 = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, seed0, scale, 0.0, True), *xs)
    ref = [np.asarray(t) for t in (ref, *vjp(jnp.asarray(g.numpy())))]
    for name, got, want in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads), ref):
        assert got.shape == want.shape, name
        err = float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())
        assert err <= TOL, f"D={D} {name}: {err:.3e} of the largest value against Pallas"


def test_attention_module_at_head_dim_512_matches_jax():
    """``RelPosSelfAttention(2048, 4)``, the spec encoder's module at
    ``spec_dembed=2048`` (head dim 512), fused (on the CPU its plain version),
    from the JAX init's weights carried across by ``from_jax_params``, against
    the JAX module (its unfused attention), batch 2, L = 16: the output and
    every parameter's gradient of sum(out * g)."""
    x = np.random.default_rng(5).standard_normal((2, 16, 2048)).astype(np.float32)
    g = np.random.default_rng(6).standard_normal((2, 16, 2048)).astype(np.float32)
    jm = JAttn(d_model=2048, num_heads=4, dropout=0.1)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    tm = RelPosSelfAttention(2048, 4, 0.1, fused=True)
    assert tm.fused and att.padded_head_dim(2048 // 4) == 512
    params, buffers = from_jax_params(jax.tree.map(np.asarray, variables))
    tm.load_state_dict({**params, **buffers}, strict=True)
    out = tm(torch.from_numpy(x))
    out.backward(torch.from_numpy(g))
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref).max()))
    ref_grads, _ = from_jax_params({"params": jax.tree.map(np.asarray, jgrads)})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(ref_grads) == set(got)
    # the key bias's exact gradient is 0 (a shift of every score of a row):
    # both sides' values are rounding, measured against the largest gradient
    atol = 1e-5 * max(float(r.abs().max()) for r in ref_grads.values())
    for name, r in ref_grads.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)
