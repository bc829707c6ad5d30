"""The port's kernels' plain versions against the JAX package.

The CUDA and Triton kernels themselves run only on the card; there they are
held against these plain versions by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``. Here each wrapper takes its plain version
because its tensors lie on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_tpu.kernels.dropout import _hash_mask, fused_dropout  # noqa: E402
from sarssl_torch.kernels import (attention_plain, dropout_plain, fused_attention,  # noqa: E402
                                  hash_dropout, hash_keep_mask)

B, H, L, D = 2, 2, 32, 16  # as tests/test_fused_attention.py
SCALE = 0.125


def _seed_of(key) -> int:
    """The uint32 seed ``_hash_mask`` derives from a key (dropout.py:114-115)."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ np.uint32((int(kd[-1]) * 0x9E3779B9) & 0xFFFFFFFF))


@pytest.mark.parametrize("key_seed,rate,shape", [
    (0, 0.1, (4, 33, 7)), (1, 0.3, (2, 2, 32, 32)), (12345, 0.5, (1000,)),
    (7, 0.9, (3, 256, 64)), (99, 1e-3, (5, 17)),
])
def test_plain_dropout_mask_equals_jax_hash_mask(key_seed, rate, shape):
    key = jax.random.key(key_seed)
    ref = np.asarray(_hash_mask(key, shape, rate))
    n = int(np.prod(shape))
    out = hash_keep_mask(n, _seed_of(key), rate).reshape(shape).numpy()
    np.testing.assert_array_equal(out, ref)


def test_plain_dropout_equals_fused_dropout_values():
    key = jax.random.key(3)
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    ref = np.asarray(fused_dropout(jnp.asarray(x), key, 0.25))
    out = hash_dropout(torch.from_numpy(x), _seed_of(key), 0.25).numpy()
    np.testing.assert_array_equal(out, ref)


def test_dropout_gradient_is_mask_over_keep_prob():
    rate, seed = 0.3, 0xDEADBEEF
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 40)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 40)).astype(np.float32))
    xr = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(hash_dropout(xr, seed, rate), xr, g)
    keep = hash_keep_mask(x.numel(), seed, rate).reshape(x.shape)
    np.testing.assert_allclose(grad.numpy(), (g * keep / (1 - rate)).numpy(), rtol=1e-6)
    assert hash_dropout(x, seed, 0.0) is x


def test_dropout_wrapper_uses_plain_version_on_cpu():
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(hash_dropout(x, 11, 0.2), dropout_plain(x, 11, 0.2))


def _attention_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, H, L, D)] * 3 + [(B, H, L, L)]]


def test_plain_attention_forward_matches_pallas_interpret():
    xs = _attention_inputs(0)
    ref = jax_fused_attention(*map(jnp.asarray, xs), jnp.zeros((1,), jnp.int32),
                              SCALE, 0.0, True)
    out = attention_plain(*map(torch.from_numpy, xs), 0, SCALE, 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    same = fused_attention(*map(torch.from_numpy, xs), 0, SCALE, 0.0)
    assert torch.equal(same, out)


def test_plain_attention_gradients_match_pallas_interpret():
    xs = _attention_inputs(1)
    seed0 = jnp.zeros((1,), jnp.int32)
    grads_ref = jax.grad(lambda a: jnp.sum(jax_fused_attention(*a, seed0, SCALE, 0.0,
                                                               True) ** 2))(
        tuple(map(jnp.asarray, xs)))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    (attention_plain(*ts, 0, SCALE, 0.0) ** 2).sum().backward()
    for t, r, name in zip(ts, grads_ref, ["dqu", "dk", "dv", "dbias"]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_plain_attention_dropout_matches_jnp_softmax_fused_dropout():
    """Rate 0.3: softmax -> fused_dropout (the same counter hash over the flat
    (b, h, i, j) index) -> PV, as the JAX unfused path computes it."""
    qu, k, v, bias = _attention_inputs(2)
    key, rate = jax.random.key(42), 0.3
    s = (jnp.einsum("bhid,bhjd->bhij", qu, k) + bias) * SCALE
    p = fused_dropout(jax.nn.softmax(s, axis=-1), key, rate)
    ref = jnp.einsum("bhij,bhjd->bhid", p, v)
    out = attention_plain(*map(torch.from_numpy, (qu, k, v, bias)), _seed_of(key),
                          SCALE, rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The formulas the tensor-core kernels (csrc/attention_mma.cu) rest on, in
# plain f32 PyTorch: saved row statistics, delta from out, a tiled forward
# with a running max, and the backward assembled from them.
# ---------------------------------------------------------------------------
TILED_SHAPE = (2, 2, 192, 16)  # three key tiles of 64
TILED_SCALE = 0.25


def _tiled_inputs(seed):
    rng = np.random.default_rng(seed)
    b, h, l, d = TILED_SHAPE
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [TILED_SHAPE] * 4 + [(b, h, l, l)]]


def _keep_and_scale(shape, seed, rate):
    """The dropout factor on p: 0 where dropped, 1/(1-rate) where kept."""
    if rate == 0.0:
        return torch.ones(shape)
    keep = hash_keep_mask(int(np.prod(shape)), seed, rate).reshape(shape)
    return keep.float() / (1.0 - rate)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_p_rebuilt_from_saved_lse_equals_softmax(rate):
    qu, k, _, _, bias = _tiled_inputs(10)
    s = (qu @ k.transpose(-1, -2) + bias) * TILED_SCALE
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    factor = _keep_and_scale(s.shape, 77, rate)
    np.testing.assert_allclose((torch.exp(s - lse) * factor).numpy(),
                               (torch.softmax(s, dim=-1) * factor).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_delta_from_out_equals_row_sum_of_dp_times_p(rate):
    qu, k, v, g, bias = _tiled_inputs(11)
    p = torch.softmax((qu @ k.transpose(-1, -2) + bias) * TILED_SCALE, dim=-1)
    factor = _keep_and_scale(p.shape, 78, rate)
    out = (p * factor) @ v
    dp = (g @ v.transpose(-1, -2)) * factor  # through the same mask
    np.testing.assert_allclose((g * out).sum(-1).numpy(), (dp * p).sum(-1).numpy(),
                               atol=1e-5, rtol=1e-5)


def _tiled_forward(qu, k, v, bias, seed, scale, rate, tile=64):
    """Keys in tiles with a running row max and sum; the output accumulator
    is rescaled when the max moves and divided by the sum at the end. Returns
    (out, lse)."""
    b, h, l, d = qu.shape
    factor = _keep_and_scale((b, h, l, l), seed, rate)
    m = torch.full((b, h, l, 1), -float("inf"))
    total = torch.zeros((b, h, l, 1))
    acc = torch.zeros_like(qu)
    for j0 in range(0, l, tile):
        js = slice(j0, j0 + tile)
        s = (qu @ k[:, :, js].transpose(-1, -2) + bias[..., js]) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        total = total * corr + e.sum(-1, keepdim=True)
        acc = acc * corr + (e * factor[..., js]) @ v[:, :, js]
        m = m_new
    return acc / total, (m + torch.log(total)).squeeze(-1)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_tiled_running_max_forward_equals_plain(rate):
    qu, k, v, _, bias = _tiled_inputs(12)
    seed = 0xC0FFEE11
    out, lse = _tiled_forward(qu, k, v, bias, seed, TILED_SCALE, rate)
    ref = attention_plain(qu, k, v, bias, seed, TILED_SCALE, rate)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    s = (qu @ k.transpose(-1, -2) + bias) * TILED_SCALE
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_backward_from_lse_and_delta_equals_autograd_of_plain(rate):
    """Per key tile, transposed as the kernel holds them: p^T from the saved
    lse, dv and dk summed over the queries, dbias written once; then
    dqu = dbias k over all keys."""
    qu, k, v, g, bias = _tiled_inputs(13)
    seed, scale, tile = 0x0BADF00D, TILED_SCALE, 64
    out, lse = _tiled_forward(qu, k, v, bias, seed, scale, rate)
    delta = (g * out).sum(-1)
    factor = _keep_and_scale(bias.shape, seed, rate)
    dbias = torch.empty_like(bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j0 in range(0, qu.shape[2], tile):
        js = slice(j0, j0 + tile)
        st = (k[:, :, js] @ qu.transpose(-1, -2) + bias[..., js].transpose(-1, -2)) * scale
        pt = torch.exp(st - lse[:, :, None, :])  # (keys, queries)
        ft = factor[..., js].transpose(-1, -2)
        dv[:, :, js] = (pt * ft) @ g
        dpt = (v[:, :, js] @ g.transpose(-1, -2)) * ft
        dst = pt * (dpt - delta[:, :, None, :]) * scale
        dbias[..., js] = dst.transpose(-1, -2)
        dk[:, :, js] = dst @ qu
    dqu = dbias @ k
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = torch.autograd.grad(attention_plain(*xs, seed, scale, rate), xs, g)
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), (dqu, dk, dv, dbias), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype,L,D,want", [
    (torch.bfloat16, 256, 128, "tc"), (torch.bfloat16, 64, 64, "tc"),
    (torch.float32, 256, 128, "tf32x3"), (torch.bfloat16, 256, 32, "tc"),
    (torch.bfloat16, 100, 64, "tc"), (torch.bfloat16, 256, 16, "tc"),
    (torch.bfloat16, 1, 32, "tc"), (torch.bfloat16, 257, 128, "tc"),
    (torch.float32, 257, 32, "tf32x3"), (torch.float32, 33, 16, "tf32x3"),
])
def test_dispatch_names_the_tensor_core_kernels_for_flagship_shapes_only(dtype, L, D, want):
    """The tensor-core kernels take every input at head dim 16, 32, 64 or 128,
    at any L: bfloat16 those of attention_mma.cu ("tc"), float32 the 3xTF32
    ones of attention_f32_mma.cu ("tf32x3")."""
    from sarssl_torch.kernels.attention import attention_route

    assert attention_route(dtype, L, D) == want
