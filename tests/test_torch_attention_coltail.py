"""The wide attention at a head dim no multiple of its chunk, unpadded, on the
CPU: the wide instance's column tail reads qu, k, v and g at their own head
dim D, in chunks of 64 columns whose last one is zero past D, and writes out,
dqu, dk and dv only up to D (``kernels/attention.py::attention_wide_plain``
is that arithmetic on plain tensors), held against ``sarssl_tpu``'s Pallas
kernel in interpret mode at rate 0 (its dropout draws on the TPU's
generator); and the wrapper's choice, pass by pass, of the unpadded wide
instance or the padding (``attention_pass_head_dim``), which
``_FusedAttention`` follows and counts.

The kernels run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Tolerance: 1e-4 of the largest magnitude of the Pallas
result (f32 on both sides, the sums run in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_torch.kernels import attention as att  # noqa: E402
from sarssl_torch.kernels import attention_plain, launches  # noqa: E402

B, H, L = 1, 2, 33
TOL = 1e-4
SEED = 0x9E3779B9


def _inputs(D):
    rng = np.random.default_rng(D)
    return [rng.standard_normal(s).astype(np.float32) for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]


@pytest.mark.parametrize("D", [72, 131, 200, 300])
def test_unpadded_wide_arithmetic_matches_pallas_interpret(D):
    """Out and the four gradients of ``attention_wide_plain`` at D (its last
    chunk of 8, 3, 8 and 44 columns; 131 odd) against the Pallas kernel and
    its ``_fa_bwd``, rate 0."""
    qu, k, v, g, bias = _inputs(D)
    scale = 1.0 / np.sqrt(H * D)
    got = att.attention_wide_plain(*(torch.from_numpy(t) for t in (qu, k, v, bias, g)), SEED,
                                   scale, 0.0)
    xs = tuple(jnp.asarray(t) for t in (qu, k, v, bias))
    ref, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, jnp.zeros((1,), jnp.int32), scale,
                                                      0.0, True), *xs)
    ref = [np.asarray(t) for t in (ref, *vjp(jnp.asarray(g)))]
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (got[0], *got[2:]), ref):
        assert a.shape == b.shape, name
        err = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
        assert err <= TOL, f"D={D} {name}: {err:.3e} of the largest value against Pallas"
    lse = torch.logsumexp((torch.from_numpy(qu) @ torch.from_numpy(k).transpose(-1, -2)
                           + torch.from_numpy(bias)) * scale, -1)
    torch.testing.assert_close(got[1], lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_wrapper_pads_only_where_an_instance_needs_it(dtype, route):
    """Each (dtype, pass, D) from 1 to 1100: an instance's head dim as it is;
    up to 128 the next instance, padded; past 128 D itself on the wide
    instance (the bf16 forward's D = 256 instance at 256 alone), but for an
    odd bf16 D (padded to ``padded_head_dim``); the instance named at the
    head dim each pass runs at."""
    for D in range(1, 1101):
        Dp = att.padded_head_dim(D)
        for kind in ("fwd", "bwd"):
            got = att.attention_pass_head_dim(dtype, kind, D)
            own = D in att.INSTANCE_HEAD_DIMS[(route, kind)]
            bf16 = route == "tc"
            pads = not own and (D <= 128 or (bf16 and D % 2 == 1))
            assert got == (Dp if pads else D), (D, kind, got)
            wide = att.attention_instance_at(dtype, kind, got) == "wide"
            assert wide == (got not in att.INSTANCE_HEAD_DIMS[(route, kind)])
            assert not wide or got > 128
        # the forward saves what the backward reads: both pad, or neither
        assert ((att.attention_pass_head_dim(dtype, "fwd", D) == D)
                == (att.attention_pass_head_dim(dtype, "bwd", D) == D))


@pytest.mark.parametrize("D", [130, 255, 300, 301])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_fused_function_pads_only_where_due(monkeypatch, D, dtype, route):
    """``_FusedAttention`` on CPU tensors with the plain version standing in
    for the C entries: each pass launches at ``attention_pass_head_dim`` (the
    backward on the forward's saved tensors), the padding counted only where
    a pass pads (an odd bf16 D), out and the gradients at D equal to the
    plain version's, with dropout."""
    seen = []

    def run_fwd(route_, wide, qu, k, v, bias, out, lse, scale, drop, splits):
        seen.append(("fwd", wide, qu.shape[-1]))
        rate, seed, _, _, heads_total, head_offset = drop
        out.copy_(attention_plain(qu, k, v, bias, seed, scale, rate, heads_total, head_offset))
        lse.copy_(torch.logsumexp((qu.float() @ k.float().transpose(-1, -2) + bias.float())
                                  * scale, -1))
        return 1

    def run_bwd(route_, wide, qu, k, v, bias, g, out, lse, dqu, dk, dv, dbias, scale, drop):
        seen.append(("bwd", wide, qu.shape[-1]))
        assert out.shape == qu.shape and g.shape == qu.shape
        rate, seed, _, _, heads_total, head_offset = drop
        xs = [t.detach().clone().requires_grad_() for t in (qu, k, v, bias)]
        with torch.enable_grad():  # a backward runs under no_grad
            grads = torch.autograd.grad(attention_plain(*xs, seed, scale, rate, heads_total,
                                                        head_offset), xs, g)
        for buf, grad in zip((dqu, dk, dv, dbias), grads):
            buf.copy_(grad)

    monkeypatch.setattr(att, "_check", lambda *a: None)
    monkeypatch.setattr(att, "_run_fwd", run_fwd)
    monkeypatch.setattr(att, "_run_bwd", run_bwd)
    qu, k, v, g, bias = (torch.from_numpy(t).to(dtype) for t in _inputs(D))
    args = (SEED, 1.0 / np.sqrt(H * D), 0.3, None, 0)
    runs = [att.attention_pass_head_dim(dtype, kind, D) for kind in ("fwd", "bwd")]
    names = [f"attention_{kind}_{route}_padded_d{att.padded_head_dim(D)}"
             for kind in ("fwd", "bwd")]
    before = [launches[n] for n in names]
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = att._FusedAttention.apply(*xs, *args)
    grads = torch.autograd.grad(out, xs, g)
    assert [s[2] for s in seen] == runs
    assert [launches[n] - b for n, b in zip(names, before)] == [int(r != D) for r in runs]
    ys = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g)
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads), (ref, *ref_grads)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOL * float(b.detach().float().abs().max()))
