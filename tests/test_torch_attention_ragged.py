"""The tensor-core attention at any sequence length, on the CPU.

``csrc/attention_mma.cu`` runs every bfloat16 input at head dim 32, 64 or 128
and any L: it takes ceil(L / 64) key tiles, zero-fills the rows past L, sets
the scores of keys >= L to -inf and never stores a row >= L; it reads the bias
rows, which start at any 2-byte boundary, as 16-byte windows. The kernels
run only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). Here
the same algorithm, tile by tile with its padded tail, and the windows'
address arithmetic are held against ``attention_plain``, and
``attention_plain`` against the Pallas kernel in interpret mode at a ragged L
and D = 32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.attention import fused_attention as jax_fused_attention  # noqa: E402
from sarssl_tpu.kernels.dropout import fused_dropout  # noqa: E402
from sarssl_torch.kernels import attention_plain, hash_keep_mask  # noqa: E402

TILE, BQ = 64, 32  # key tile of both passes; queries a step of the backward's loop
SCALE = 0.2


def _inputs(seed, L, D, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]


def _pad(x, rows, cols=None):
    """Zero rows (dim -2) up to ``rows`` and columns (dim -1) up to ``cols``:
    the zero-filled tail of the kernel's tiles."""
    cols = x.shape[-1] if cols is None else cols
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def _factor(shape, L, seed, rate):
    """The dropout factor at every position of the padded (B, H, rows, cols)
    grid, as the kernel hashes it: the unpadded flat index ((b H + h) L + i) L
    + j, so a position past L takes some other position's bit."""
    b, h, rows, cols = shape
    if rate == 0.0:
        return torch.ones(shape)
    bh = torch.arange(b * h).reshape(b, h, 1, 1)
    flat = (bh * L + torch.arange(rows).reshape(rows, 1)) * L + torch.arange(cols)
    keep = hash_keep_mask(int(flat.max()) + 1, seed, rate)[flat]
    return keep.float() / (1.0 - rate)


def _ceil(n, m):
    return -(-n // m) * m


def _tiled_forward(qu, k, v, bias, seed, scale, rate):
    """The forward over 64-key tiles with zero-filled tail rows, keys >= L at
    -inf, a running max and sum; returns (out, lse) of the rows < L."""
    L = qu.shape[2]
    lp = _ceil(L, TILE)
    qu_p, k_p, v_p, bias_p = _pad(qu, lp), _pad(k, lp), _pad(v, lp), _pad(bias, lp, lp)
    factor = _factor(bias_p.shape, L, seed, rate)
    m = torch.full(qu_p.shape[:3] + (1,), -float("inf"))
    total = torch.zeros_like(m)
    acc = torch.zeros_like(qu_p)
    for j0 in range(0, lp, TILE):
        js = slice(j0, j0 + TILE)
        s = (qu_p @ k_p[:, :, js].transpose(-1, -2) + bias_p[..., js]) * scale
        s[..., torch.arange(j0, j0 + TILE) >= L] = -float("inf")
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        total = total * corr + e.sum(-1, keepdim=True)
        acc = acc * corr + (e * factor[..., js]) @ v_p[:, :, js]
        m = m_new
    assert torch.isfinite(acc).all() and torch.isfinite(total).all()
    return (acc / total)[:, :, :L], (m + torch.log(total)).squeeze(-1)[:, :, :L]


def _tiled_backward(qu, k, v, g, bias, out, lse, seed, scale, rate):
    """The backward as the kernels run it: per 64-key tile, the queries in
    steps of 32 with zero-filled tail rows (qu, g, bias, lse, delta), p^T from
    the saved lse, dv and dk summed over the steps, dbias written for rows and
    keys < L; then dqu = dbias k over the zero-filled window of dbias."""
    L = qu.shape[2]
    lk, lq = _ceil(L, TILE), _ceil(L, BQ)
    delta = (g * out).sum(-1)
    qu_p, g_p, k_p, v_p = _pad(qu, lq), _pad(g, lq), _pad(k, lk), _pad(v, lk)
    bias_p = _pad(bias, lq, lk)
    lse_p, delta_p = (torch.nn.functional.pad(t, (0, lq - L)) for t in (lse, delta))
    factor = _factor(bias_p.shape, L, seed, rate)
    dbias_p = torch.zeros_like(bias_p)
    dk_p, dv_p = torch.zeros_like(k_p), torch.zeros_like(v_p)
    for j0 in range(0, lk, TILE):
        js = slice(j0, j0 + TILE)
        for q0 in range(0, lq, BQ):
            qs = slice(q0, q0 + BQ)
            st = (k_p[:, :, js] @ qu_p[:, :, qs].transpose(-1, -2)
                  + bias_p[:, :, qs, js].transpose(-1, -2)) * scale
            pt = torch.exp(st - lse_p[:, :, None, qs])
            ft = factor[:, :, qs, js].transpose(-1, -2)
            dv_p[:, :, js] += (pt * ft) @ g_p[:, :, qs]
            dpt = (v_p[:, :, js] @ g_p[:, :, qs].transpose(-1, -2)) * ft
            dst = pt * (dpt - delta_p[:, :, None, qs]) * scale
            dbias_p[:, :, qs, js] = dst.transpose(-1, -2)
            dk_p[:, :, js] += dst @ qu_p[:, :, qs]
    for t in (dbias_p, dk_p, dv_p):
        assert torch.isfinite(t).all()
    dbias = dbias_p[:, :, :L, :L]  # the stored rows and keys
    dqu = _pad(dbias, _ceil(L, TILE), lk) @ k_p
    return dqu[:, :, :L], dk_p[:, :, :L], dv_p[:, :, :L], dbias


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("L", [33, 65, 100])
def test_tiled_ragged_tail_forward_and_backward_equal_plain(L, D, rate):
    qu, k, v, g, bias = _inputs(L + D, L, D)
    seed = 0x9E3779B9
    out, lse = _tiled_forward(qu, k, v, bias, seed, SCALE, rate)
    ref = attention_plain(qu, k, v, bias, seed, SCALE, rate)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    s = (qu @ k.transpose(-1, -2) + bias) * SCALE
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5, rtol=0)
    grads = _tiled_backward(qu, k, v, g, bias, out, lse, seed, SCALE, rate)
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref_grads = torch.autograd.grad(attention_plain(*xs, seed, SCALE, rate), xs, g)
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The windows of attention_mma.cu (load_window_tile, store_window_tile): a row
# of a (.., L, L) bf16 matrix starts at any 2-byte boundary; its 16-byte
# chunks from the one holding its first value on fill a tile row of 9 chunks.
# ---------------------------------------------------------------------------
CHUNKS = 9


def _window_load(mem, addr, ncols):
    """One tile row as ``load_window_tile`` fills it from byte address
    ``addr`` of ``mem`` (uint8): chunk c copies min(max(lead + 2 ncols - 16 c,
    0), 16) bytes from the row's chunk-aligned base + 16 c, zeros after."""
    lead, base = addr & 15, addr & ~15
    tile = np.zeros(16 * CHUNKS, np.uint8)
    for c in range(CHUNKS):
        n = min(max(lead + 2 * ncols - 16 * c, 0), 16)
        tile[16 * c:16 * c + n] = mem[base + 16 * c:base + 16 * c + n]
    return tile


def _window_store(mem, addr, ncols, tile):
    """``store_window_tile``: a chunk inside the row's bytes [lead, lead + 2
    ncols) in one 16-byte store, the values of a chunk at either end one by
    one."""
    lead, base = addr & 15, addr & ~15
    end = lead + 2 * ncols
    for c in range(CHUNKS):
        lo = 16 * c
        if end <= lo or lead >= lo + 16:
            continue
        if lead <= lo and end >= lo + 16:
            mem[base + lo:base + lo + 16] = tile[lo:lo + 16]
        else:
            for e in range(8):
                if lead <= lo + 2 * e < end:
                    mem[base + lo + 2 * e:base + lo + 2 * e + 2] = tile[lo + 2 * e:lo + 2 * e + 2]


@pytest.mark.parametrize("L", [1, 33, 100, 257, 512])
@pytest.mark.parametrize("offset", [0, 1, 3])  # the matrix's first element, in elements
def test_window_tiles_place_each_row_at_its_shift(L, offset):
    """Every row of every key tile lands at column shift + j, shift = (its
    address / 2) & 7, with zeros after its last value; the store writes back
    exactly the tile's values of rows and keys < L."""
    rng = np.random.default_rng(L + offset)
    vals = rng.integers(1, 2 ** 16, size=(3, L), dtype=np.uint16)  # no zero values
    mem = np.zeros(2 * (offset + 3 * L) + 64, np.uint8)
    start = 2 * offset
    mem[start:start + vals.nbytes] = vals.view(np.uint8).ravel()
    out = np.zeros_like(mem)
    for r in range(3):
        for j0 in range(0, L, TILE):
            ncols = min(TILE, L - j0)
            addr = start + 2 * (r * L + j0)
            tile = _window_load(mem, addr, ncols).view(np.uint16)
            shift = (addr >> 1) & 7
            np.testing.assert_array_equal(tile[shift:shift + ncols], vals[r, j0:j0 + ncols])
            assert not tile[shift + ncols:].any()
            _window_store(out, addr, ncols, tile.view(np.uint8))
    np.testing.assert_array_equal(out[start:start + vals.nbytes], vals.view(np.uint8).ravel())
    assert not out[:start].any() and not out[start + vals.nbytes:].any()


# ---------------------------------------------------------------------------
# attention_plain against the Pallas kernel (interpret mode) at a ragged L
# ---------------------------------------------------------------------------
def _seed_of(key) -> int:
    """The uint32 seed ``_hash_mask`` derives from a key (dropout.py:114-115)."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ np.uint32((int(kd[-1]) * 0x9E3779B9) & 0xFFFFFFFF))


RAGGED_L, RAGGED_D = 33, 32


def test_plain_attention_matches_pallas_interpret_at_ragged_length():
    qu, k, v, g, bias = (x.numpy() for x in _inputs(7, RAGGED_L, RAGGED_D))
    xs = (qu, k, v, bias)
    seed0 = jnp.zeros((1,), jnp.int32)
    ref = jax_fused_attention(*map(jnp.asarray, xs), seed0, SCALE, 0.0, True)
    out = attention_plain(*map(torch.from_numpy, xs), 0, SCALE, 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    grads_ref = jax.grad(lambda a: jnp.sum(jax_fused_attention(*a, seed0, SCALE, 0.0, True)
                                           * jnp.asarray(g)))(tuple(map(jnp.asarray, xs)))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    grads = torch.autograd.grad(attention_plain(*ts, 0, SCALE, 0.0), ts, torch.from_numpy(g))
    for a, r, name in zip(grads, grads_ref, ["dqu", "dk", "dv", "dbias"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3, err_msg=name)


def test_plain_attention_dropout_matches_jnp_fused_dropout_at_ragged_length():
    """Rate 0.3 at L = 33: the hash of the flat (b, h, i, j) index over the
    unpadded (B, H, L, L) tensor, as the JAX unfused path draws it."""
    qu, k, v, _, bias = (x.numpy() for x in _inputs(8, RAGGED_L, RAGGED_D))
    key, rate = jax.random.key(5), 0.3
    s = (jnp.einsum("bhid,bhjd->bhij", qu, k) + bias) * SCALE
    ref = jnp.einsum("bhij,bhjd->bhid", fused_dropout(jax.nn.softmax(s, axis=-1), key, rate), v)
    out = attention_plain(*map(torch.from_numpy, (qu, k, v, bias)), _seed_of(key), SCALE, rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
