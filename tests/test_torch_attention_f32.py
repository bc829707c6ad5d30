"""The f32 attention's 3xTF32 design (``csrc/attention_f32_mma.cu``), on the CPU.

The kernels run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Here their arithmetic is emulated in torch: every product
takes TF32 operands split as x = hi + lo (hi = tf32(x), lo = tf32(x - hi),
rounded as ``cvt.rna`` rounds: to nearest, ties away from zero, the 13 low
mantissa bits cleared) and sums lo*hi + hi*lo + hi*hi in f32; the forward
walks 64-key tiles with zero-filled tail rows, keys >= L at -inf and a
running max and sum; the backward takes delta = sum(g * out), the scores
transposed per 64-key tile (every query of the tile at once: the kernel
steps through them 32 or 16 at a time, which changes only the order of dv's
and dk's sums), and dqu = dbias k over 64-key tiles. The
results are held against ``attention_plain`` in f32 and against the JAX
package's ``reference_attention`` (rate 0: it has no dropout), and
``attention_plain`` against the Pallas kernel in interpret mode at a ragged
f32 shape, forward and ``_fa_bwd``. One TF32 product (no split) is shown to
miss the tolerance at L = 256, D = 128, where the split meets it: the reason
for the design.

Tolerance: 1e-4 of the largest magnitude of the reference (``chip_smoke.py``'s
``TOL_F32``). At L = 1 the softmax of one score is constant, so dqu, dk and
dbias vanish; there they are measured against the terms that cancel, scale *
max |g . v| / (1 - rate) (times max |k| for dqu, max |qu| for dk), as
``tests/test_torch_gpu.py`` measures the kernel's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_tpu.kernels.attention import reference_attention  # noqa: E402
from sarssl_torch.kernels import attention_plain, hash_keep_mask  # noqa: E402

TOL = 1e-4
TILE = 64  # keys a tile of both passes
SEED = 0x9E3779B9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, restored after the module: with one per core
    these matmuls oversubscribe a host whose cores the suite's parallel
    workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """f32 -> TF32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def mm_3x(a, b):
    """a @ b from three TF32 products: the two small ones first, then hi * hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1x(a, b):
    """a @ b from one TF32 product (plain TF32)."""
    return tf32(a) @ tf32(b)


def _inputs(seed, L, D, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]


def _ceil(n, m):
    return -(-n // m) * m


def _pad(x, rows, cols=None):
    cols = x.shape[-1] if cols is None else cols
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def _factor(shape, L, rate):
    """The dropout factor at every position of the padded (B, H, rows, cols)
    grid, hashed from the unpadded flat index ((b H + h) L + i) L + j."""
    b, h, rows, cols = shape
    if rate == 0.0:
        return torch.ones(shape)
    bh = torch.arange(b * h).reshape(b, h, 1, 1)
    flat = (bh * L + torch.arange(rows).reshape(rows, 1)) * L + torch.arange(cols)
    keep = hash_keep_mask(int(flat.max()) + 1, SEED, rate)[flat]
    return keep.float() / (1.0 - rate)


def tiled_forward(qu, k, v, bias, scale, rate, mm=mm_3x):
    """attn_fwd_tf32: 64-key tiles, zero-filled tails, keys >= L at -inf, a
    running max and sum, e = exp(s - m) dropped and rescaled into the product
    with v, the division by the row sum last; returns (out, lse)."""
    L = qu.shape[2]
    lp = _ceil(L, TILE)
    qu_p, k_p, v_p, bias_p = _pad(qu, lp), _pad(k, lp), _pad(v, lp), _pad(bias, lp, lp)
    factor = _factor(bias_p.shape, L, rate)
    m = torch.full(qu_p.shape[:3] + (1,), -float("inf"))
    total = torch.zeros_like(m)
    acc = torch.zeros_like(qu_p)
    for j0 in range(0, lp, TILE):
        js = slice(j0, j0 + TILE)
        s = (mm(qu_p, k_p[:, :, js].transpose(-1, -2)) + bias_p[..., js]) * scale
        s[..., torch.arange(j0, j0 + TILE) >= L] = -float("inf")
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        total = total * corr + e.sum(-1, keepdim=True)
        acc = acc * corr + mm(e * factor[..., js], v_p[:, :, js])
        m = m_new
    return (acc / total)[:, :, :L], (m + torch.log(total)).squeeze(-1)[:, :, :L]


def tiled_backward(qu, k, v, g, bias, out, lse, scale, rate, mm=mm_3x):
    """attn_delta_f32 + attn_bwd_tf32 + attn_dqu_tf32: delta = sum(g out);
    per 64-key tile (zero-filled tail rows), p^T from lse, dv = pd^T g,
    dp^T = v g^T through the mask, ds^T, dk = ds^T qu, dbias stored for rows
    and keys < L; then dqu = dbias k over 64-key tiles."""
    L = qu.shape[2]
    lk = _ceil(L, TILE)
    delta = (g * out).sum(-1)
    k_p, v_p = _pad(k, lk), _pad(v, lk)
    bias_p = _pad(bias, L, lk)
    factor = _factor(bias_p.shape, L, rate)
    dbias_p = torch.zeros_like(bias_p)
    dk_p, dv_p = torch.zeros_like(k_p), torch.zeros_like(v_p)
    for j0 in range(0, lk, TILE):
        js = slice(j0, j0 + TILE)
        st = (mm(k_p[:, :, js], qu.transpose(-1, -2)) + bias_p[..., js].transpose(-1, -2)) * scale
        pt = torch.exp(st - lse[:, :, None, :])
        ft = factor[..., js].transpose(-1, -2)
        dv_p[:, :, js] = mm(pt * ft, g)
        dpt = mm(v_p[:, :, js], g.transpose(-1, -2)) * ft
        dst = pt * (dpt - delta[:, :, None, :]) * scale
        dbias_p[..., js] = dst.transpose(-1, -2)
        dk_p[:, :, js] = mm(dst, qu)
    dbias = dbias_p[..., :L]  # the stored keys
    dbias_t = _pad(dbias, lk, lk)  # dqu's tiles, zero-filled past L
    dqu = torch.zeros((*qu.shape[:2], lk, qu.shape[3]))
    for j0 in range(0, lk, TILE):
        js = slice(j0, j0 + TILE)
        dqu += mm(dbias_t[..., js], k_p[:, :, js])
    return dqu[:, :, :L], dk_p[:, :, :L], dv_p[:, :, :L], dbias


def _errors(got, want, qu, k, v, g, scale, rate):
    """Each result's error relative to the largest magnitude of its
    reference; at L = 1 dqu, dk and dbias against the terms that cancel."""
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    if qu.shape[2] == 1:
        cancel = scale * float((g * v).sum(-1).abs().max()) / (1.0 - rate)
        for i, f in ((1, float(k.abs().max())), (2, float(qu.abs().max())), (4, 1.0)):
            errs[i] = float((got[i] - want[i]).abs().max()) / (cancel * f)
    return errs


def _plain(qu, k, v, bias, g, scale, rate):
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    out = attention_plain(*xs, SEED, scale, rate)
    return (out.detach(), *torch.autograd.grad(out, xs, g))


def _jax_reference(qu, k, v, bias, g, scale):
    """reference_attention and its gradients (jax.vjp under jit), rate 0."""
    def fwd_bwd(qu, k, v, bias, g):
        out, vjp = jax.vjp(lambda *a: reference_attention(*a, scale), qu, k, v, bias)
        return (out, *vjp(g))

    res = jax.jit(fwd_bwd)(*(jnp.asarray(t.numpy()) for t in (qu, k, v, bias, g)))
    return [torch.from_numpy(np.array(t)) for t in res]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", [1, 65, 257, 768])
def test_emulated_3xtf32_forward_and_backward_equal_plain(L, D, rate):
    qu, k, v, g, bias = _inputs(L + D, L, D)
    scale = D ** -0.5
    out, lse = tiled_forward(qu, k, v, bias, scale, rate)
    got = (out, *tiled_backward(qu, k, v, g, bias, out, lse, scale, rate))
    names = ("out", "dqu", "dk", "dv", "dbias")
    for name, e in zip(names, _errors(got, _plain(qu, k, v, bias, g, scale, rate),
                                      qu, k, v, g, scale, rate)):
        assert e <= TOL, f"{name} against attention_plain: {e:.3e}"
    s = (qu @ k.transpose(-1, -2) + bias) * scale
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= TOL
    if rate == 0.0:
        ref = _jax_reference(qu, k, v, bias, g, scale)
        for name, e in zip(names, _errors(got, ref, qu, k, v, g, scale, rate)):
            assert e <= TOL, f"{name} against the JAX reference_attention: {e:.3e}"


def test_plain_tf32_misses_the_tolerance_where_3xtf32_meets_it():
    """At L = 256, D = 128 (the flagship spec encoder's shape) one TF32 product
    a product misses 1e-4 of the f32 result, forward and backward; the split
    holds every result inside it."""
    L, D = 256, 128
    qu, k, v, g, bias = _inputs(11, L, D)
    scale = D ** -0.5
    want = _plain(qu, k, v, bias, g, scale, 0.0)
    errs = {}
    for name, mm in (("1x", mm_1x), ("3x", mm_3x)):
        out, lse = tiled_forward(qu, k, v, bias, scale, 0.0, mm)
        got = (out, *tiled_backward(qu, k, v, g, bias, out, lse, scale, 0.0, mm))
        errs[name] = _errors(got, want, qu, k, v, g, scale, 0.0)
    assert max(errs["3x"]) <= TOL, errs["3x"]
    assert errs["1x"][0] > TOL and max(errs["1x"]) > 5 * TOL, errs["1x"]


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits: a value halfway between two TF32 values
    goes away from zero, others to the nearer one; the split's low part
    carries the next 11 bits."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + 0.5 * one_ulp, -(1.0 + 0.5 * one_ulp), 1.0 + 0.49 * one_ulp,
                      1.0 + 1.5 * one_ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) <= 2.0 ** -11


RAGGED_L, RAGGED_D = 65, 64


def test_plain_f32_matches_pallas_interpret_at_ragged_length():
    """attention_plain in f32 against the Pallas kernel in interpret mode,
    forward and its ``_fa_bwd`` (rate 0), at L = 65, D = 64; and the
    emulated 3xTF32 kernels against the same Pallas results."""
    qu, k, v, g, bias = _inputs(7, RAGGED_L, RAGGED_D)
    scale = RAGGED_D ** -0.5
    xs = tuple(jnp.asarray(t.numpy()) for t in (qu, k, v, bias))
    seed0 = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, seed0, scale, 0.0, True), *xs)
    ref = [torch.from_numpy(np.array(t)) for t in (ref, *vjp(jnp.asarray(g.numpy())))]
    names = ("out", "dqu", "dk", "dv", "dbias")
    plain = _plain(qu, k, v, bias, g, scale, 0.0)
    for name, e in zip(names, _errors(plain, ref, qu, k, v, g, scale, 0.0)):
        assert e <= TOL, f"{name}: attention_plain against Pallas {e:.3e}"
    out, lse = tiled_forward(qu, k, v, bias, scale, 0.0)
    got = (out, *tiled_backward(qu, k, v, g, bias, out, lse, scale, 0.0))
    for name, e in zip(names, _errors(got, ref, qu, k, v, g, scale, 0.0)):
        assert e <= TOL, f"{name}: emulated 3xTF32 against Pallas {e:.3e}"
