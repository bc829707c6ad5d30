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
