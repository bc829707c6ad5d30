"""The inputs the hand-written kernels take past one launch's grid or 32-bit
offsets: their launch planning on shapes alone, the refusals that remain,
and the plain versions at those edges against the JAX package.

On the card the edges run in ``chip_smoke.py`` phase ``edges`` and in
``tests/test_torch_gpu.py``; here each plan is held on shapes (the launchers
on ``meta`` tensors, which allocate nothing) and each plain version on small
inputs. Tolerance of the conv plain version against the Pallas kernel in
interpret mode: rtol 1e-4 / atol 1e-5 (f32 on both sides, the taps summed in
another order); masks exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.kernels.conv3x3 import conv3x3 as jax_conv3x3  # noqa: E402
from sarssl_tpu.kernels.dropout import _hash_mask  # noqa: E402
from sarssl_torch.kernels import attention as att  # noqa: E402
from sarssl_torch.kernels import conv3x3_plain, dropout_plain, hash_keep_mask  # noqa: E402
from sarssl_torch.kernels.conv3x3 import (any_mma_passes, conv3x3_from_padded_blocks,  # noqa: E402
                                          conv_batch_chunks, conv_kernel, launch_conv3x3,
                                          pack_weights, pack_weights_any)
from sarssl_torch.kernels.dropout import (dropout_refusal, keep_threshold,  # noqa: E402
                                          lanes_grid, launch_dropout, launch_dropout_lanes,
                                          short_lane_index, short_lanes_keep_mask)

META = torch.device("meta")


# --- attention: launches over (b, h) pairs, the uint32 dropout index ---

@pytest.mark.parametrize("B, H, L", [
    (13107, 5, 64),        # B * H = 65535: one launch
    (16384, 4, 64),        # 65536: two runs of batches
    (131071, 1, 64),       # 131071
    (16448, 4, 64),        # chip_smoke's edge
    (1, 65536, 16),        # H alone past the grid: runs of one batch's heads
    (3, 70001, 8),
    (4, 2, 2 ** 29),       # rows past _ROWS_MAX: a pair a launch
    (128, 4, 256),         # the flagship: one launch
])
def test_attention_chunks_cover_every_pair_once(B, H, L):
    chunks = att.attention_chunks(B, H, L)
    seen = np.zeros((B, H), dtype=np.int64)
    for b0, nb, h0, nh in chunks:
        assert nb * nh <= att.GRID_YZ
        assert nb * nh * L <= att._ROWS_MAX or nb * nh == 1
        assert nh == H or nb == 1  # whole batches, or one batch's heads
        seen[b0:b0 + nb, h0:h0 + nh] += 1
    assert (seen == 1).all()
    fits = B * H <= att.GRID_YZ and B * H * L <= att._ROWS_MAX
    assert (len(chunks) == 1) == fits
    if fits:
        assert chunks == [(0, B, 0, H)]


@pytest.mark.parametrize("heads_total, head_offset", [(None, 0), (7, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_chunk_launches_hash_the_whole_tensors_index(heads_total, head_offset, rate):
    """Each launch's seed and heads (``_chunk_drop``) given to the plain
    version on its pairs give the slice of the whole plain version bit for
    bit: runs of batches and runs of one batch's heads, of a whole tensor and
    of a tensor-parallel rank's heads."""
    B, H, L, D = 5, 3, 8, 4
    rng = np.random.default_rng(0)
    qu, k, v = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
                for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((B, H, L, L)).astype(np.float32))
    seed, scale = 0xFFFFFF00, 0.5
    whole = att.attention_plain(qu, k, v, bias, seed, scale, rate, heads_total, head_offset)
    drop = att._drop_args(seed, rate, H, heads_total, head_offset)
    for b0, nb, h0, nh in [(0, 2, 0, H), (2, 3, 0, H), (1, 1, 0, 2), (4, 1, 2, 1)]:
        r, s, _, _, ht, ho = att._chunk_drop(drop, b0, h0, L)
        assert r == drop[0]
        sl = (slice(b0, b0 + nb), slice(h0, h0 + nh))
        part = att.attention_plain(qu[sl], k[sl], v[sl], bias[sl], s, scale, rate, ht, ho)
        assert torch.equal(part, whole[sl]), (b0, nb, h0, nh)


@pytest.mark.parametrize("B, heads_total, L, refused_above_0", [
    (1, 1, 65535, False), (1, 1, 65536, True),       # L * L just under, at 2**32
    (2, 4, 23170, False), (2, 4, 23171, True),       # just under, just over
    (1, 2, 46341, True), (16448, 4, 64, False)])
def test_attention_refuses_past_uint32_at_rate_above_0_only(B, heads_total, L, refused_above_0):
    assert att.attention_refusal(B, heads_total, L, 0.0) is None
    refusal = att.attention_refusal(B, heads_total, L, 0.1)
    assert (refusal is not None) == refused_above_0
    if refusal:
        assert "uint32" in refusal and "dropout.py:117" in refusal


@pytest.mark.parametrize("launch", [att.launch_attention_fwd_mma, att.launch_attention_fwd_tf32])
def test_launchers_refuse_the_shape_at_rate_above_0_and_take_it_at_0(launch):
    """On meta tensors (no memory): B * H * L * L = 2**32 raises the uint32
    refusal at rate 0.1; at rate 0 the shape passes and only the device is
    refused (the kernels run on CUDA tensors); B * H past the grid is no
    refusal either."""
    qu = torch.empty((1, 1, 65536, 16), device=META)
    bias = torch.empty((1, 1, 65536, 65536), device=META)
    with pytest.raises(ValueError, match="uint32"):
        launch(qu, qu, qu, bias, 7, 0.25, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        launch(qu, qu, qu, bias, 7, 0.25, 0.0)
    many = torch.empty((16448, 4, 64, 16), device=META)
    with pytest.raises(ValueError, match="CUDA"):
        launch(many, many, many, torch.empty((16448, 4, 64, 64), device=META), 7, 0.25, 0.1)


def test_fma_kernels_keep_their_own_limits():
    """``csrc/attention.cu`` serves no route and keeps one launch over B * H
    and uint32 indices at every rate."""
    att._check_fma_grid(torch.empty((16383, 4, 64, 16), device=META), None)
    with pytest.raises(ValueError, match="65535"):
        att._check_fma_grid(torch.empty((16384, 4, 64, 16), device=META), None)
    with pytest.raises(ValueError, match="uint32"):
        att._check_fma_grid(torch.empty((1, 1, 65536, 16), device=META), None)


# --- dropout: offsets past 2**31, the uint32 index, the lanes' grid ---

@pytest.mark.parametrize("n, refused", [
    (2 ** 31 - 1, False), (2 ** 31, False), (2 ** 31 + 1, False), (2 ** 32 - 1, False),
    (2 ** 32, True)])
def test_dropout_offsets_and_refusal_by_size(n, refused):
    assert (dropout_refusal(n) is not None) == refused
    x = torch.empty((n,), dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError, match="uint32" if refused else "CUDA"):
        launch_dropout(x, 5, 0.1)
    lanes = torch.empty((1, n), dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError, match="uint32" if refused else "CUDA"):
        launch_dropout_lanes(lanes, torch.zeros(1, dtype=torch.int64), 0.1)


@pytest.mark.parametrize("nlane, runs", [(1, 1), (65535, 1), (65536, 2), (65600, 2),
                                          (131070, 2), (131071, 3)])
def test_lanes_grid_covers_every_lane_once(nlane, runs):
    """One launch at any lane count: program (i, y, z) takes lane z * ny +
    y, those past the last lane store nothing, and fewer than a run idle."""
    blocks, ny, nz = lanes_grid(5000, nlane)
    assert blocks == 2 and nz == runs and 0 < ny <= 65535 and nz <= 65535
    lane = (np.arange(nz)[:, None] * ny + np.arange(ny)[None, :]).ravel()
    assert np.array_equal(lane[lane < nlane], np.arange(nlane))
    assert ny * nz - nlane < nz
    with pytest.raises(ValueError, match="lanes"):
        lanes_grid(1, 65535 ** 2 + 1)


def _jax_mask_at(seed: int, i0: int, m: int, rate: float) -> np.ndarray:
    """JAX's mask at flat indices i0 .. i0 + m with seed ``seed``: by the
    seed-shift identity (the hash reads ``index + seed`` mod 2**32, the
    identity ``models/common.py`` folds a data shard's offset in by), its
    mask at 0 .. m with seed ``seed + i0``; a key whose data is ``[s, 0]``
    gives ``_hash_mask`` the seed s."""
    key = jax.random.wrap_key_data(jnp.asarray([(seed + i0) % 2 ** 32, 0], jnp.uint32))
    return np.asarray(_hash_mask(key, (m,), rate))


@pytest.mark.parametrize("i0", [2 ** 31 - 600, 2 ** 32 - 1000])
@pytest.mark.parametrize("seed", [0, 0x9E3779B9])
def test_plain_mask_past_2_31_equals_jax_hash(i0, seed):
    """The plain mask at indices across 2**31 and up to 2**32 - 1 (the index
    map places a window of m elements at i0 of the whole tensor) against
    JAX's ``_hash_mask``, bit for bit."""
    m, rate = 1000, 0.3
    port = hash_keep_mask(m, seed, rate, index_map=(m, i0 + m, i0))
    np.testing.assert_array_equal(port.numpy(), _jax_mask_at(seed, i0, m, rate))
    assert keep_threshold(rate) == int(np.uint32(rate * 4294967296.0))


def test_plain_slice_by_index_map_and_by_seed_shift_equal_the_whole():
    """The two ways ``chip_smoke.py`` holds a slice of a large launch against
    the plain version: the index map placing the slice, and the seed shifted
    by the slice's start; both the whole plain version's slice."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(5000).astype(np.float32))
    seed, rate = 0xFFFFF000, 0.25
    whole = dropout_plain(x, seed, rate)
    for a, b in ((0, 700), (1234, 4321), (4096, 5000)):
        m = b - a
        assert torch.equal(dropout_plain(x[a:b], seed, rate, (m, a + m, a)), whole[a:b])
        assert torch.equal(dropout_plain(x[a:b], (seed + a) % 2 ** 32, rate), whole[a:b])


# --- convolutions: any channel count and batch ---

@pytest.mark.parametrize("dtype, C, Cout, kernel", [
    (torch.bfloat16, 64, 64, "tc"), (torch.bfloat16, 128, 64, "tc"),
    (torch.float32, 64, 128, "fma"), (torch.float32, 3, 64, "any"),
    (torch.bfloat16, 3, 64, "tc_any"), (torch.bfloat16, 64, 48, "tc_any"),
    (torch.float32, 96, 160, "any"), (torch.bfloat16, 256, 256, "tc_any"),
    (torch.float32, 64, 64, "fma"), (torch.float32, 128, 128, "fma"),
    (torch.float32, 128, 64, "fma"), (torch.bfloat16, 32, 32, "tc_any"),
    (torch.bfloat16, 13, 3, "tc_any"), (torch.float32, 5, 24, "any")])
def test_conv_kernel_routing(dtype, C, Cout, kernel):
    """By dtype and channels, without H and W (the row tiles; images smaller
    than a row tile take the image groups in bfloat16,
    ``tests/test_torch_conv_groups.py``): the FMA kernels' pixel tiles lie on
    the grid's x dimension, so no H or W changes a float32 kernel; bfloat16
    outside the tensor-core instances' pairs runs the runtime-channel
    tensor-core kernel, float32 there the runtime-channel FMA kernel."""
    assert conv_kernel(dtype, C, Cout) == kernel


@pytest.mark.parametrize("N, launches", [(1, 1), (65535, 1), (65536, 2), (65600, 2),
                                         (131071, 3)])
def test_conv_batch_chunks_cover_every_image_once(N, launches):
    chunks = conv_batch_chunks(N)
    assert len(chunks) == launches and all(0 < nn <= 65535 for _, nn in chunks)
    assert sum(nn for _, nn in chunks) == N and chunks[0][0] == 0


@pytest.mark.parametrize("channels", [(32, 32), (3, 64), (256, 256)])
def test_conv_launcher_takes_any_channels(channels):
    """No channel pair or batch is refused any more: on meta tensors only
    the device is."""
    C, Cout = channels
    x = torch.empty((65600, 4, 8, C), dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError, match="CUDA"):
        launch_conv3x3(x, torch.empty((3, 3, C, Cout), dtype=torch.bfloat16, device=META),
                       "conv3x3_fwd")


@pytest.mark.parametrize("C, Cout", [(3, 64), (64, 48), (96, 160)])
def test_plain_conv_at_other_channels_matches_pallas_interpret(C, Cout):
    """Forward and VJP (dx as the conv of dy with the rotated weights, dW)
    at channel counts that the runtime-channel kernel takes, against
    ``sarssl_tpu``'s Pallas conv in interpret mode."""
    rng = np.random.default_rng(C)
    x = rng.standard_normal((1, 8, 6, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    dy = rng.standard_normal((1, 8, 6, Cout)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jax_conv3x3(a, b, 8, True), jnp.asarray(x), jnp.asarray(w))
    gx_ref, gw_ref = vjp(jnp.asarray(dy))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = conv3x3_plain(xt, wt)
    out.backward(torch.from_numpy(dy))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), **tol)


# --- the runtime-channel tensor-core conv's blocks, the short-lane dropout ---

@pytest.mark.parametrize("C, Cout, passes, nb", [
    (3, 3, 1, 8), (13, 24, 1, 24), (48, 160, 3, 56), (64, 48, 1, 48), (96, 64, 1, 64),
    (256, 256, 4, 64), (512, 512, 8, 64), (1, 65, 2, 40)])
def test_any_mma_blocks_cover_the_channels(C, Cout, passes, nb):
    """ceil(Cout / 64) passes of NB channels (a multiple of 8 up to 64, at
    most 7 past Cout a pass) and ceil(C / 64) K chunks, the packed weight
    zero past C and Cout."""
    assert any_mma_passes(Cout) == (passes, nb)
    assert nb % 8 == 0 and nb <= 64 and 0 <= passes * nb - Cout < 8 * passes
    w = torch.randn((3, 3, C, Cout))
    packed = pack_weights_any(w)
    assert tuple(packed.shape) == (passes, -(-C // 64), 9, nb, 64)
    flat = packed.permute(2, 1, 4, 0, 3).reshape(9, -(-C // 64) * 64, passes * nb)
    assert torch.equal(flat[:, :C, :Cout], w.reshape(9, C, Cout))
    assert not flat[:, C:].any() and not flat[:, :, Cout:].any()


@pytest.mark.parametrize("C, Cout", [(64, 64), (128, 64), (64, 128), (128, 128), (192, 256)])
def test_pack_weights_any_holds_pack_weights_blocks(C, Cout):
    """Where C and Cout are multiples of 64 the runtime-channel packing
    holds the dense packing's blocks, transposed to [co][ci]: pass p, chunk
    k, tap t is block (t, k) of output chunk p."""
    w = torch.randn((3, 3, C, Cout))
    dense, packed = pack_weights(w), pack_weights_any(w)
    kh = C // 64
    for p in range(Cout // 64):
        for k in range(kh):
            for tap in range(9):
                assert torch.equal(packed[p, k, tap], dense[p, tap * kh + k].T)


@pytest.mark.parametrize("C, Cout", [(3, 3), (13, 24), (48, 160), (3, 160), (13, 3),
                                     (48, 24)])
def test_padded_block_conv_matches_pallas_interpret(C, Cout):
    """``conv3x3_any_mma.cu``'s arithmetic (zero-padded K chunks and output
    passes) in plain PyTorch against ``sarssl_tpu``'s Pallas conv in
    interpret mode, f32 on both sides (rtol 1e-4 / atol 1e-5)."""
    rng = np.random.default_rng(C * 1000 + Cout)
    x = rng.standard_normal((1, 8, 5, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) / np.sqrt(9 * C)).astype(np.float32)
    ref = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(w), 8, True))
    out = conv3x3_from_padded_blocks(torch.from_numpy(x), pack_weights_any(torch.from_numpy(w)),
                                     Cout)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nlane, lane_numel", [(3, 1), (4097, 1), (70, 63), (5, 4095),
                                               (3, 4096), (1, 1)])
def test_short_lane_index_covers_every_element_once(nlane, lane_numel):
    """The short-lane kernel's flat map gives each element of (N,
    lane_numel) its lane and its index in the lane, once, in flat order."""
    lane, j = short_lane_index(nlane, lane_numel)
    assert torch.equal(lane * lane_numel + j, torch.arange(nlane * lane_numel))
    assert int(j.min()) >= 0 and int(j.max()) < lane_numel and int(lane.max()) == nlane - 1


@pytest.mark.parametrize("lane_numel", [1, 63, 4095])
def test_short_lanes_mask_equals_each_lanes_hash(lane_numel):
    """The short-lane kernel's plain mask is each lane's ``hash_keep_mask``
    with its own seed (seeds above 2**31 among them), lane by lane."""
    seeds = torch.tensor([0, 7, 0x9E3779B9, 2 ** 32 - 1, 123456789], dtype=torch.int64)
    mask = short_lanes_keep_mask(seeds, lane_numel, 0.3)
    for lane, seed in enumerate(seeds.tolist()):
        assert torch.equal(mask[lane], hash_keep_mask(lane_numel, seed, 0.3))
