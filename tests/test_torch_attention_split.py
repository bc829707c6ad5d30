"""The wide attention forward split over key tiles, and the instance each
pass runs at head dim 256, on the CPU.

At a small batch the wide forward's scores pass has too few blocks for the
card, so the launcher splits each query tile's key tiles over S blocks
(``kernels/attention.py::wide_key_splits``): each writes its tiles' scaled
scores and its rows' partial (max, sum), and the p v pass merges the S
partials into the log-sum-exp. ``attention_split_plain`` is that algorithm on
plain tensors; here it is held, at S = 1, 2 and 4 and D = 300 (padded to 320,
as ``fused_attention`` pads it), against the Pallas kernel in interpret mode
(rate 0: the Pallas kernel draws its dropout from the TPU's generator) and,
with dropout, against ``attention_plain`` and the JAX package's unfused path
(softmax, then ``fused_dropout``'s counter hash, then p v). At L = 1 and 33 a
split of 2 or 4 holds no key tile; at L = 257 a split of 4 leaves the last
split none: its partial (-inf, 0) adds nothing. The kernels run only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

At D = 256 the bf16 forward keeps its D = 256 instance and the bf16 backward
and both f32 passes take the wide instance (``attention_instance``): the
route table is checked at every head dim, and ``_FusedAttention`` driven with
the plain version standing in for the kernels' C entries.

Tolerance: 1e-4 of the largest magnitude of the reference: f32 on both sides,
the sums run in another order.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_tpu.kernels.dropout import fused_dropout  # noqa: E402
from sarssl_torch.kernels import attention as att  # noqa: E402
from sarssl_torch.kernels import attention_plain, launches  # noqa: E402

TOL = 1e-4
B, H, D = 1, 2, 300
SCALE = 1.0 / np.sqrt(H * D)  # the model's 1 / sqrt(d_model)
RATE = 0.3
KEY = 5


def _seed_of(key) -> int:
    """The uint32 seed ``fused_dropout``'s hash derives from a key
    (``sarssl_tpu/kernels/dropout.py:114-115``)."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ np.uint32((int(kd[-1]) * 0x9E3779B9) & 0xFFFFFFFF))


def _inputs(L):
    rng = np.random.default_rng(L)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, H, L, D)] * 3 + [(B, H, L, L)]]


@functools.lru_cache(maxsize=None)
def _jax_references(L):
    """(Pallas in interpret mode at rate 0, the JAX unfused path at RATE)."""
    qu, k, v, bias = map(jnp.asarray, _inputs(L))
    pallas = jax_fused_attention(qu, k, v, bias, jnp.zeros((1,), jnp.int32), SCALE, 0.0, True)
    s = (jnp.einsum("bhid,bhjd->bhij", qu, k) + bias) * SCALE
    p = fused_dropout(jax.nn.softmax(s, axis=-1), jax.random.key(KEY), RATE)
    return np.asarray(pallas), np.asarray(jnp.einsum("bhij,bhjd->bhid", p, v))


def _split_forward(L, splits, seed, rate):
    """``attention_split_plain`` at the padded head dim, sliced back to D."""
    xs = [torch.from_numpy(x) for x in _inputs(L)]
    Dp = att.padded_head_dim(D)
    qu, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in xs[:3])
    out, lse = att.attention_split_plain(qu, k, v, xs[3], seed, SCALE, rate, splits)
    return out[..., :D].numpy(), lse, xs


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("L", [1, 33, 256, 257])
def test_split_forward_matches_pallas_interpret_and_plain(L, splits):
    """Rate 0 against the Pallas kernel in interpret mode; rate 0.3 against
    ``attention_plain`` and the JAX unfused path; lse against the scores'
    log-sum-exp."""
    pallas, unfused = _jax_references(L)
    out, lse, xs = _split_forward(L, splits, 0, 0.0)
    assert _err(out, pallas) <= TOL, f"L={L} S={splits}: {_err(out, pallas):.2e} against Pallas"
    s = (xs[0] @ xs[1].transpose(-1, -2) + xs[3]) * SCALE
    assert _err(lse.numpy(), torch.logsumexp(s, -1).numpy()) <= TOL
    seed = _seed_of(jax.random.key(KEY))
    out, _, xs = _split_forward(L, splits, seed, RATE)
    plain = attention_plain(*xs, seed, SCALE, RATE).numpy()
    assert _err(out, plain) <= TOL, f"L={L} S={splits}: {_err(out, plain):.2e} against plain"
    assert _err(out, unfused) <= TOL, f"L={L} S={splits}: {_err(out, unfused):.2e} against JAX"


def test_key_split_chooser():
    """S = 1 where the blocks of one split fill the card (the flagship batch
    at L = 256: B * H = 512), more where they do not (B * H = 32), never more
    than the key tiles, and always a number that gives each split the same
    ceil(nt / S) tiles."""
    for blocks in (2, 3, 4):
        assert att.wide_key_splits(256, 512, 132, blocks) == 1
        assert att.wide_key_splits(256, 32, 132, blocks) > 1
    assert att.wide_key_splits(256, 32, 132, 3) == 4
    for L in (1, 33, 64, 100, 256, 257, 512, 1000):
        nt = -(-L // 64)
        for bh in (1, 2, 8, 32, 128, 512, 4096):
            for sms, blocks in ((132, 2), (132, 3), (132, 4), (16, 1)):
                S = att.wide_key_splits(L, bh, sms, blocks)
                per = -(-nt // S)
                assert 1 <= S <= nt and -(-nt // per) == S, (L, bh, sms, blocks, S)
                if nt * bh >= sms * blocks:
                    assert S == 1, (L, bh, sms, blocks, S)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_route_table_names_each_pass_instance(dtype, route):
    """Every head dim from 1 to 4096: below 256 both passes run the padded
    head dim's instance, from 256 on the wide instance, except the bf16
    forward at 256, which runs its D = 256 instance."""
    for D in range(1, 4097):
        Dp = att.padded_head_dim(D)
        for kind in ("fwd", "bwd"):
            got = att.attention_instance(dtype, kind, Dp)
            own = Dp < 256 or (Dp == 256 and route == "tc" and kind == "fwd")
            assert got == (f"d{Dp}" if own else "wide"), (D, kind, got)
            assert (got == "wide") == (Dp not in att.INSTANCE_HEAD_DIMS[(route, kind)])
    with pytest.raises(ValueError):
        att.attention_instance(dtype, "fwd", 200)


def _stand_in(seen):
    """Stand-ins for ``_run_fwd`` / ``_run_bwd``: record (route, pass, wide,
    head dim) and fill the launch's buffers with the plain version."""
    def lse_of(qu, k, bias, scale):
        return torch.logsumexp((qu.float() @ k.float().transpose(-1, -2) + bias.float()) * scale,
                               -1)

    def run_fwd(route, wide, qu, k, v, bias, out, lse, scale, drop, splits):
        seen.append((route, "fwd", wide, qu.shape[-1]))
        rate, seed, _, _, heads_total, head_offset = drop
        out.copy_(attention_plain(qu, k, v, bias, seed, scale, rate, heads_total, head_offset))
        lse.copy_(lse_of(qu, k, bias, scale))
        return 1

    def run_bwd(route, wide, qu, k, v, bias, g, out, lse, dqu, dk, dv, dbias, scale, drop):
        seen.append((route, "bwd", wide, qu.shape[-1]))
        rate, seed, _, _, heads_total, head_offset = drop
        xs = [t.detach().clone().requires_grad_() for t in (qu, k, v, bias)]
        with torch.enable_grad():  # a backward runs under no_grad
            grads = torch.autograd.grad(attention_plain(*xs, seed, scale, rate, heads_total,
                                                        head_offset), xs, g)
        for buf, grad in zip((dqu, dk, dv, dbias), grads):
            buf.copy_(grad)

    return run_fwd, run_bwd


@pytest.mark.parametrize("D", [200, 256])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32x3")])
def test_fused_function_takes_each_pass_instance_at_256(monkeypatch, D, dtype, route):
    """``_FusedAttention`` on CPU tensors with the plain version standing in
    for the C entries: at D = 256 the bf16 forward runs the D = 256 instance
    and the other passes the wide one; at D = 200 every pass runs the wide
    one at D itself, unpadded (its column tail); the counts say so (no
    padding counted), and out and the gradients equal the plain version's,
    with dropout."""
    seen = []
    run_fwd, run_bwd = _stand_in(seen)
    monkeypatch.setattr(att, "_check", lambda *a: None)
    monkeypatch.setattr(att, "_run_fwd", run_fwd)
    monkeypatch.setattr(att, "_run_bwd", run_bwd)
    rng = np.random.default_rng(D)
    qu, k, v, g = (torch.from_numpy(rng.standard_normal((2, 2, 33, D)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((2, 2, 33, 33)).astype(np.float32)).to(dtype)
    args = (0x9E3779B9, 1.0 / np.sqrt(2 * D), 0.3, None, 0)
    bf16 = dtype == torch.bfloat16
    wide_fwd = not bf16 or D != 256  # the bf16 forward's D = 256 instance at 256 alone
    names = [f"attention_{kind}_{tag}d{D}" for kind in ("fwd", "bwd")
             for tag in ("", f"{route}_", f"{route}_wide_")] + [
        f"attention_{kind}_{route}_padded_d256" for kind in ("fwd", "bwd")]
    before = [launches[n] for n in names]
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = att._FusedAttention.apply(*xs, *args)
    grads = torch.autograd.grad(out, xs, g)
    assert seen == [(route, "fwd", wide_fwd, D), (route, "bwd", True, D)]
    assert [launches[n] - b for n, b in zip(names, before)] == [
        1, 1, int(wide_fwd), 1, 1, 1, 0, 0]
    ys = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g)
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads), (ref, *ref_grads)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=TOL * float(b.detach().float().abs().max()))
