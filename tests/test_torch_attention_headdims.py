"""Every head dim up to 256 on the tensor-core attention, on the CPU (past
256: tests/test_torch_attention_wide.py).

``fused_attention`` runs head dims 16, 32, 64, 128 and 256 on instances of the
tensor-core kernels and every other D up to 256 on the instance of the next
of those widths, with qu, k, v (and g in the backward) zero-padded on their
last dim and out, dqu, dk, dv sliced back (``kernels/attention.py``). The
kernels run only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``);
here the padding and the slicing are driven with ``attention_plain`` as the
launcher and held against the JAX package's Pallas kernel in interpret mode at
the head dims that need them, output and all four gradients.

Tolerance: 1e-4 of the largest magnitude of the Pallas result (``chip_smoke.py``'s
``TOL_F32``): in f32 the two differ only in the order of their sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_torch.kernels import attention as att  # noqa: E402
from sarssl_torch.kernels import attention_plain  # noqa: E402

B, H, L = 2, 2, 32  # as tests/test_fused_attention.py
TOL = 1e-4
SEED = 0x9E3779B9


@pytest.mark.parametrize("D,Dp", [(4, 16), (8, 16), (12, 16), (16, 16), (48, 64), (96, 128),
                                  (128, 128)])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_route_names_the_tensor_cores_at_every_head_dim_up_to_128(D, Dp, dtype, route):
    assert att.attention_route(dtype, 257, D) == route
    assert att.padded_head_dim(D) == Dp


@pytest.mark.parametrize("D,Dp", [(129, 256), (200, 256), (256, 256)])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_route_names_the_tensor_cores_at_head_dims_129_to_256(D, Dp, dtype, route):
    assert att.attention_route(dtype, 257, D) == route
    assert att.padded_head_dim(D) == Dp


@pytest.mark.parametrize("D", [257, 512])
def test_head_dims_past_128_raise(D):
    """Past the largest instance, 256, both name the wide instance at the
    next multiple of its chunk, and only a head dim below 1 raises (the
    test's name keeps the limit of its first version, when head dims past it
    raised; tests/test_torch_attention_wide.py holds the wide route)."""
    assert att.attention_route(torch.bfloat16, 64, D) == "tc"
    assert att.padded_head_dim(D) == -(-D // att.WIDE_CHUNK) * att.WIDE_CHUNK
    for bad in (0, -D):
        with pytest.raises(ValueError, match="1 or more"):
            att.attention_route(torch.bfloat16, 64, bad)
        with pytest.raises(ValueError, match="1 or more"):
            att.padded_head_dim(bad)


def _plain_fwd(qu, k, v, bias, *args):
    return attention_plain(qu, k, v, bias, *args), None


def _plain_bwd(qu, k, v, bias, g, out, lse, *args):
    xs = [t.detach().clone().requires_grad_() for t in (qu, k, v, bias)]
    with torch.enable_grad():  # a launcher of a backward runs under no_grad
        return torch.autograd.grad(attention_plain(*xs, *args), xs, g)


def _inputs(seed, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]


@pytest.mark.parametrize("D", [4, 8, 12, 48, 96, 160, 256])
def test_padded_route_matches_pallas_interpret(D):
    """The pad and slice around a launch at ``padded_head_dim(D)`` (here
    ``attention_plain``), rate 0, against the Pallas kernel in interpret mode
    and its ``_fa_bwd`` at D itself; the launch's padded columns of out, dqu,
    dk and dv are exactly 0."""
    qu, k, v, g, bias = _inputs(D, D)
    scale = 1.0 / np.sqrt(H * D)  # the model's 1 / sqrt(d_model)
    args = (SEED, scale, 0.0)
    out, lse, padded = att.attention_fwd_padded(_plain_fwd, qu, k, v, bias, *args)
    Dp = att.padded_head_dim(D)
    assert all(t.shape[-1] == Dp for t in padded) and out.shape == qu.shape
    full = []

    def bwd(*a):
        full.extend(_plain_bwd(*a))
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


@pytest.mark.parametrize("D", [8, 16, 48, 200])
def test_fused_function_launches_the_padded_instance_and_slices(monkeypatch, D):
    """``_FusedAttention`` (the card's autograd path) with the plain version
    standing in for the tensor-core launchers on CPU tensors: each launch
    sees the head dim its pass runs at (the instance's, padded, up to 128;
    D itself past 128 in f32, the wide instance's column tail), out and the
    gradients come back at D and equal the plain version's, with dropout."""
    seen = []

    def fwd(qu, *a):
        seen.append(("fwd", qu.shape[-1]))
        return _plain_fwd(qu, *a)

    def bwd(qu, *a):
        seen.append(("bwd", qu.shape[-1]))
        return _plain_bwd(qu, *a)

    monkeypatch.setattr(att, "_check", lambda *a: None)
    monkeypatch.setitem(att._TC_LAUNCHES, "tf32x3", (fwd, bwd))
    qu, k, v, g, bias = _inputs(100 + D, D)
    args = (SEED, 1.0 / np.sqrt(H * D), 0.3, None, 0)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = att._FusedAttention.apply(*xs, *args)
    grads = torch.autograd.grad(out, xs, g)
    Dp = att.padded_head_dim(D) if D <= 128 else D
    assert seen == [("fwd", Dp), ("bwd", Dp)]
    ys = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g)
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads), (ref, *ref_grads)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.detach().abs().max()))


def test_spec_encoder_at_head_dim_256_matches_jax():
    """``SARSSLConfig.tiny(spec_dembed=1024)``: the spec encoder's 4 heads over
    d = 1024 give head dim 256 at L = 16. The port with fused attention (on
    the CPU its plain version), from the JAX init's weights carried across by
    ``from_jax_params``, against the JAX model (its unfused attention: the
    Pallas kernel runs on the CPU only in interpret mode, which the model does
    not ask for), dropout 0, train mode, one replayed mask: the pretext loss
    within rtol 1e-4 and each parameter's gradient within rtol 1e-4 and 1e-5
    of the largest gradient (f32 on both sides, sums in another order; the
    key biases' exact gradient is 0)."""
    from sarssl_tpu.models import SARSSL as JSARSSL
    from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig
    from sarssl_tpu.ops import gen_patch_mask
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import PatchMask
    from sarssl_torch.utils.weights import from_jax_params

    jcfg = JSARSSLConfig().tiny(spec_dembed=1024, dropout=0.0)
    nf, nt, nreim, nmic = jcfg.sig_shape
    x = np.random.default_rng(3).standard_normal((4, nmic, nf, nt, nreim)).astype(np.float32)
    mask = gen_patch_mask(jax.random.key(7), 4, jcfg.npatch, jcfg.effective_nmasked())
    jm = JSARSSL(jcfg)
    variables = jax.jit(lambda: jm.init({"params": jax.random.key(0)}, jnp.asarray(x), mask,
                                        False))()

    def jloss(params):
        (loss, _, _), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), mask, True, mutable=["batch_stats"])
        return loss

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    model = SARSSL(SARSSLConfig(**{**jcfg.__dict__, "fused_attention": True}), device="cpu")
    mhsa = model.spec_encoder.seq.blocks[0].mhsa
    assert mhsa.fused and mhsa.d_model // mhsa.num_heads == 256
    params, buffers = from_jax_params(jax.tree.map(np.asarray, variables))
    model.load_state_dict({**params, **buffers}, strict=True)
    tmask = PatchMask(*(torch.tensor(np.asarray(t)) if t.dtype == bool
                        else torch.tensor(np.asarray(t)).long() for t in mask))
    loss, _, _ = model.pretext(torch.from_numpy(x), tmask, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    ref, _ = from_jax_params({"params": jax.tree.map(np.asarray, jg)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(ref) == set(got)
    atol = 1e-5 * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)
