"""The hand-written kernels against their plain versions on a CUDA card.

Marked ``gpu``; each test skips when no card is present. This file imports
no JAX, so on a machine without it run it without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from sarssl_torch.kernels import (attention_plain, conv3x3, conv3x3_plain,  # noqa: E402
                                  conv3x3_s2d, conv3x3_s2d_plain, dropout_plain,
                                  fused_attention, hash_dropout, launches)
from sarssl_torch.kernels.attention import (attention_route, fma_row_block,  # noqa: E402
                                            fma_smem_bytes, launch_attention_bwd_fma,
                                            padded_head_dim,
                                            launch_attention_bwd_mma,
                                            launch_attention_bwd_tf32,
                                            launch_attention_fwd_fma,
                                            launch_attention_fwd_mma,
                                            launch_attention_fwd_tf32, padded_head_dim)
from sarssl_torch.kernels.conv3x3 import (conv3x3_dx, conv3x3_fwd, conv_kernel,  # noqa: E402
                                          launch_conv3x3_any_mma, launch_conv3x3_mma,
                                          pack_weights, rot180_io)
from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx, conv3x3_s2d_fwd  # noqa: E402
from sarssl_torch.kernels.dropout import launch_dropout, launch_dropout_lanes  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative to max |plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the conv tests' dW is a cuDNN call
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _attention_case(gen, shape, dtype, rate):
    """fused_attention, forward and backward, against the plain version in
    f32; asserts which set of kernels ran from the launch counts (at the
    instance's head dim, D padded to the next of 16 / 32 / 64 / 128 / 256;
    never the FMA kernels)."""
    B, H, L, D = shape
    shapes = [shape] * 3 + [(B, H, L, L)]
    xs = [torch.randn(s, generator=gen, device="cuda").to(dtype).requires_grad_()
          for s in shapes]
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    seed, scale = 0xFEEDBEEF, D ** -0.5
    names = [f"attention_{kind}_{tag}d{padded_head_dim(D)}"
             for tag in ("", "tc_", "tf32x3_", "fma_") for kind in ("fwd", "bwd")]
    before = [launches[n] for n in names]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    route = attention_route(dtype, L, D)
    tc, tf = int(route == "tc"), int(route == "tf32x3")
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, tc, tc, tf, tf, 0, 0]
    assert out.shape == shape and all(a.shape == x.shape for a, x in zip(grads, xs))
    ys = [x.detach().float().requires_grad_() for x in xs]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    errs = [_rel(a, b) for a, b in zip((out, *grads), (ref, *ref_grads))]
    if L == 1:
        # the softmax of one score is constant: dqu, dk and dbias of the plain
        # version vanish up to f32 rounding, and the kernel's are out's
        # rounding left in ds = p (dp - delta); each is measured against the
        # terms that cancel there, scale max |g . v| / (1 - rate), times
        # max |k| for dqu and max |qu| for dk
        qu, k, v, _ = (x.detach().float() for x in xs)
        cancel = scale * float((g.float() * v).sum(-1).abs().max()) / (1.0 - rate)
        for i, factor in ((1, k.abs().max()), (2, qu.abs().max()), (4, 1.0)):
            errs[i] = float((grads[i - 1].float() - ref_grads[i - 1]).abs().max()
                            / (cancel * factor))
    for name, e in zip(("out", "dqu", "dk", "dv", "dbias"), errs):
        assert e <= TOL[dtype], name


@pytest.mark.parametrize("L", [64, 100, 256])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_kernel_matches_plain(cuda, L, D, dtype, rate):
    """Head dim 16, 32, 64 or 128 runs the tensor-core kernels at every L,
    bfloat16 those of attention_mma.cu, float32 the 3xTF32 ones of
    attention_f32_mma.cu (their counts rise)."""
    want = "tc" if dtype == torch.bfloat16 else "tf32x3"
    assert attention_route(dtype, L, D) == want
    _attention_case(cuda, (2, 3, L, D), dtype, rate)


@pytest.mark.parametrize("L", [64, 100, 256])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fma_attention_in_f32_matches_plain_when_called_directly(cuda, L, D, rate):
    """The FMA kernels in f32 at the tensor-core head dims, which
    ``fused_attention`` no longer routes there: launched directly."""
    xs = [torch.randn(s, generator=cuda, device="cuda")
          for s in [(2, 3, L, D)] * 4 + [(2, 3, L, L)]]
    qu, k, v, g, bias = xs
    args = (0xFEEDBEEF, D ** -0.5, rate)
    out = launch_attention_fwd_fma(qu, k, v, bias, *args)
    grads = launch_attention_bwd_fma(qu, k, v, bias, g, *args)
    ys = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g)
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[torch.float32], name


@pytest.mark.parametrize("L", [1, 33, 257, 768, 1000])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_tf32_attention_at_ragged_and_long_lengths_matches_plain(cuda, L, D, rate):
    """The 3xTF32 kernels at tails of 1 and 33 rows, the CLS token's 257, and
    past the 704 where the FMA kernels stop (768, 1000)."""
    _attention_case(cuda, (1, 2, L, D), torch.float32, rate)


@pytest.mark.parametrize("L", [256, 257])
@pytest.mark.parametrize("offset", [1, 3, 4])
def test_tf32_attention_takes_a_bias_at_any_alignment(cuda, L, offset):
    """An f32 bias whose data starts ``offset`` elements into its storage: 1
    and 3 take the any-L instance's 4-byte copies, 4 (16 bytes) at L = 256
    the instance for whole tiles."""
    B, H, D = 2, 2, 64
    qu, k, v, g = (torch.randn((B, H, L, D), generator=cuda, device="cuda") for _ in range(4))
    store = torch.randn(offset + B * H * L * L, generator=cuda, device="cuda")
    bias = store[offset:].view(B, H, L, L)
    args = (0xFEEDBEEF, D ** -0.5, 0.3)
    out, lse = launch_attention_fwd_tf32(qu, k, v, bias, *args)
    grads = launch_attention_bwd_tf32(qu, k, v, bias, g, out, lse, *args)
    ys = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g)
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[torch.float32], name


@pytest.mark.parametrize("L,D", [(256, 64), (256, 128), (257, 64), (512, 32)])
def test_tf32_attention_backward_is_bit_identical_from_run_to_run(cuda, L, D):
    shape = (4, 4, L, D)
    qu, k, v, g = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    bias = torch.randn((4, 4, L, L), generator=cuda, device="cuda")
    args = (0xFEEDBEEF, D ** -0.5, 0.1)
    out, lse = launch_attention_fwd_tf32(qu, k, v, bias, *args)
    first = launch_attention_bwd_tf32(qu, k, v, bias, g, out, lse, *args)
    second = launch_attention_bwd_tf32(qu, k, v, bias, g, out, lse, *args)
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("L", [1, 33, 257, 768, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_head_dim_16_at_ragged_and_long_lengths_matches_plain(cuda, L, dtype, rate):
    """Head dim 16 on the tensor-core kernels at tails of 1 and 33 rows, the
    CLS token's 257, and past the 704 where the FMA kernels stop (768, 1000)."""
    _attention_case(cuda, (1, 2, L, 16), dtype, rate)


@pytest.mark.parametrize("L", [1, 64, 257])
@pytest.mark.parametrize("D", [4, 8, 48, 100, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_head_dims_match_plain(cuda, L, D, dtype):
    """Head dims that are no instance's run the next one up on zero-padded
    inputs (16, 16, 64, 128, 256), with dropout: out and the gradients come
    back at D."""
    _attention_case(cuda, (2, 2, L, D), dtype, 0.3)


@pytest.mark.parametrize("L", [1, 33, 256, 257, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_head_dim_256_matches_plain(cuda, L, dtype, rate):
    """Head dim 256 on the tensor-core kernels (the bf16 forward on its D =
    256 instance, the other passes on the wide instance) at tails of 1 and 33
    rows, whole tiles, the CLS token's 257 and a long 768, with dropout's
    positions (held through the gradients) those of the plain version."""
    _attention_case(cuda, (1, 2, L, 256), dtype, rate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_dropped_positions_equal_plain(cuda, dtype):
    """With v the identity's first 256 columns, out is the dropped and
    rescaled probabilities: the kernel's zeros are the plain mask's."""
    from sarssl_torch.kernels import hash_keep_mask

    B, H, L, D = 2, 2, 320, 256
    qu, k = (torch.randn((B, H, L, D), generator=cuda, device="cuda").to(dtype)
             for _ in range(2))
    bias = torch.randn((B, H, L, L), generator=cuda, device="cuda").to(dtype)
    v = torch.eye(L, device="cuda", dtype=dtype)[:, :D].expand(B, H, L, D).contiguous()
    seed, rate = 0xFEEDBEEF, 0.3
    pd = fused_attention(qu, k, v, bias, seed, D ** -0.5, rate)
    keep = hash_keep_mask(B * H * L * L, seed, rate, "cuda").reshape(B, H, L, L)
    assert torch.equal(pd != 0, keep[..., :D])


@pytest.mark.parametrize("L", [1, 33, 256, 257])
@pytest.mark.parametrize("D", [300, 320, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_wide_head_dims_match_plain(cuda, L, D, dtype, rate):
    """Past 256 the wide instance (D = 300 and 320 at 320, on blocks of 64
    columns; 512 and 1000 at 512 and 1024, on blocks of 128) at tails of 1
    and 33 rows, whole tiles and the CLS token's 257, with dropout's
    positions (held through the gradients) those of the plain version."""
    names = [f"attention_{kind}_{tag}wide_d{padded_head_dim(D)}" for kind in ("fwd", "bwd")
             for tag in ("tc_", "tf32x3_")]
    before = [launches[n] for n in names]
    _attention_case(cuda, (1, 2, L, D), dtype, rate)
    tc = int(dtype == torch.bfloat16)
    after = [launches[n] for n in names]
    assert [a - b for a, b in zip(after, before)] == [tc, 1 - tc, tc, 1 - tc]


@pytest.mark.parametrize("L", [1, 33, 64, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_instance_at_256_matches_plain(cuda, L, dtype):
    """The wide instance at D = 256, forward and backward, against the plain
    version, rate 0.3: the route's launchers run it in every pass but the
    bf16 forward, which ``_wide_launches`` launches on it beside the route's
    D = 256 instance (no model path takes it there). The counts say which
    instance ran."""
    from sarssl_torch.kernels.attention import _wide_launches

    route = attention_route(dtype, L, 256)
    tc = route == "tc"
    fwd = _wide_launches(route) if tc else launch_attention_fwd_tf32
    bwd = launch_attention_bwd_mma if tc else launch_attention_bwd_tf32
    qu, k, v, g = (torch.randn((2, 2, L, 256), generator=cuda, device="cuda").to(dtype)
                   for _ in range(4))
    bias = torch.randn((2, 2, L, L), generator=cuda, device="cuda").to(dtype)
    args = (0xFEEDBEEF, 256 ** -0.5, 0.3)
    names = [f"attention_{kind}_{route}_{w}d256" for kind in ("fwd", "bwd") for w in ("", "wide_")]
    before = [launches[n] for n in names]
    out, lse = fwd(qu, k, v, bias, *args)
    grads = bwd(qu, k, v, bias, g, out, lse, *args)
    # the bf16 wide forward, off the route, raises its wide count alone
    assert [launches[n] - b for n, b in zip(names, before)] == [int(not tc), 1, 1, 1]
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    names = ("out", "dqu", "dk", "dv", "dbias")
    for i, (name, a, b) in enumerate(zip(names, (out, *grads), (ref, *ref_grads))):
        if L == 1 and i in (1, 2, 4):  # they vanish at L = 1 (_attention_case)
            continue
        assert _rel(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_routes_count_their_instances(cuda, dtype):
    """``fused_attention`` at D = 200 and 256 (both at 256): the bf16 forward
    on the D = 256 instance, the bf16 backward and both f32 passes on the wide
    instance, as ``attention_instance`` names them."""
    from sarssl_torch.kernels.attention import attention_instance

    route = attention_route(dtype, 64, 256)
    for D in (200, 256):
        names = [f"attention_{kind}_{route}_{w}d256" for kind in ("fwd", "bwd")
                 for w in ("", "wide_")]
        before = [launches[n] for n in names]
        xs = [torch.randn(s, generator=cuda, device="cuda").to(dtype).requires_grad_()
              for s in [(2, 2, 64, D)] * 3 + [(2, 2, 64, 64)]]
        out = fused_attention(*xs, 0xFEEDBEEF, D ** -0.5, 0.3)
        torch.autograd.grad(out, xs, torch.ones_like(out))
        wide = [attention_instance(dtype, kind, 256) == "wide" for kind in ("fwd", "bwd")]
        assert wide == [route == "tf32x3", True]
        assert [launches[n] - b for n, b in zip(names, before)] == [1, int(wide[0]), 1, 1]


@pytest.mark.parametrize("L", [1, 33, 256, 257])
@pytest.mark.parametrize("D", [300, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_forward_key_splits_match_plain(cuda, L, D, dtype):
    """The wide forward at batch 8 (launched at D's padded head dim) with
    every number of key splits from 1 to ceil(L / 64) forced, and the one the
    launcher chooses, rate 0.3: out against the plain version, lse against
    the scores' log-sum-exp; at L = 257, where 4 splits leave the last one no
    key tile, the dropped positions (v the identity) those of the plain mask;
    a launch of more than one split counted as such."""
    from sarssl_torch.kernels import hash_keep_mask
    from sarssl_torch.kernels.attention import _launch_fwd

    B, H, Dp = 8, 4, padded_head_dim(D)
    route = attention_route(dtype, L, Dp)
    qu, k, v = (torch.randn((B, H, L, Dp), generator=cuda, device="cuda").to(dtype)
                for _ in range(3))
    bias = torch.randn((B, H, L, L), generator=cuda, device="cuda").to(dtype)
    seed, rate = 0xFEEDBEEF, 0.3
    args = (seed, (H * D) ** -0.5, rate)
    x = [t.float() for t in (qu, k, v, bias)]
    ref = attention_plain(*x, *args)
    ref_lse = torch.logsumexp((x[0] @ x[1].transpose(-1, -2) + x[3]) * args[1], -1)
    keep = hash_keep_mask(B * H * L * L, seed, rate, "cuda").reshape(B, H, L, L)
    eye = torch.eye(L, Dp, device="cuda", dtype=dtype).expand(B, H, L, Dp).contiguous()
    name = f"attention_fwd_{route}_wide_split_d{Dp}"
    nt = -(-L // 64)
    for splits in (*range(1, nt + 1), None):
        before = launches[name]
        out, lse = _launch_fwd(route, qu, k, v, bias, *args, splits=splits)
        if splits is not None:
            assert launches[name] - before == int(splits > 1)
        assert _rel(out, ref) <= TOL[dtype] and _rel(lse, ref_lse) <= TOL[dtype], splits
        if L == 257:
            pd = _launch_fwd(route, qu, k, eye, bias, *args, splits=splits)[0]
            assert torch.equal(pd[..., :L] != 0, keep), splits
    with pytest.raises(ValueError):
        _launch_fwd(route, qu, k, v, bias, *args, splits=nt + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_dropped_positions_equal_plain(cuda, dtype):
    """On the wide instance (D = L = 512) with v the identity, out is the
    dropped and rescaled probabilities: the kernel's zeros are the plain
    mask's."""
    from sarssl_torch.kernels import hash_keep_mask

    B, H, L, D = 1, 2, 512, 512
    qu, k = (torch.randn((B, H, L, D), generator=cuda, device="cuda").to(dtype)
             for _ in range(2))
    bias = torch.randn((B, H, L, L), generator=cuda, device="cuda").to(dtype)
    v = torch.eye(L, device="cuda", dtype=dtype).expand(B, H, L, D).contiguous()
    seed, rate = 0xFEEDBEEF, 0.3
    pd = fused_attention(qu, k, v, bias, seed, D ** -0.5, rate)
    keep = hash_keep_mask(B * H * L * L, seed, rate, "cuda").reshape(B, H, L, L)
    assert torch.equal(pd != 0, keep)


@pytest.mark.parametrize("L,D", [(1, 32), (33, 32), (257, 32), (512, 32), (257, 64),
                                 (257, 128)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_kernel_at_option_lengths_matches_plain(cuda, L, D, rate):
    """The tensor-core kernels at the lengths the CLS token (257) and one
    channel a patch (512, D = 32) bring, and at tails of 1 and 33 rows."""
    _attention_case(cuda, (2, 2, L, D), torch.bfloat16, rate)


@pytest.mark.parametrize("L", [256, 257])
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_attention_kernel_takes_a_bias_at_any_alignment(cuda, L, offset):
    """A bias whose data starts ``offset`` elements into its storage (not
    16-byte aligned, but for 8): the kernels read its rows as windows."""
    B, H, D = 2, 2, 64
    qu, k, v, g = (torch.randn((B, H, L, D), generator=cuda, device="cuda").bfloat16()
                   for _ in range(4))
    store = torch.randn(offset + B * H * L * L, generator=cuda, device="cuda").bfloat16()
    bias = store[offset:].view(B, H, L, L)
    args = (0xFEEDBEEF, D ** -0.5, 0.3)
    out, lse = launch_attention_fwd_mma(qu, k, v, bias, *args)
    grads = launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args)
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, *args)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[torch.bfloat16], name


@pytest.mark.parametrize("D", [64, 128])
def test_attention_kernel_matches_plain_at_flagship_shape(cuda, D):
    _attention_case(cuda, (4, 4, 256, D), torch.bfloat16, 0.1)


@pytest.mark.parametrize("L", [257, 384, 448, 512])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fma_attention_at_long_sequences_matches_plain(cuda, L, D, dtype):
    """The FMA kernels, forward and backward, called directly at the lengths
    the CLS token (257) and the single-channel patch sequence (512) bring,
    with dropout: where 64 rows of scores do not fit in a block's shared
    memory, the block takes 32 (at L = 512 the backward row pass at every D)."""
    B, H = 2, 3
    xs = [torch.randn(s, generator=cuda, device="cuda").to(dtype)
          for s in [(B, H, L, D)] * 4 + [(B, H, L, L)]]
    qu, k, v, g, bias = xs
    seed, scale, rate = 0xFEEDBEEF, D ** -0.5, 0.1
    assert fma_smem_bytes("bwd", L, D) <= 232448
    if L == 512:
        assert fma_row_block("bwd", L, D) == 32
    out = launch_attention_fwd_fma(qu, k, v, bias, seed, scale, rate)
    grads = launch_attention_bwd_fma(qu, k, v, bias, g, seed, scale, rate)
    ys = [t.float().requires_grad_() for t in (qu, k, v, bias)]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[dtype], name


def test_fma_attention_refuses_what_a_block_cannot_hold(cuda):
    """At L = 768, D = 128 the forward fits at 32 rows a block and runs; the
    backward row pass needs more shared memory than a block has and raises."""
    x = torch.randn(1, 1, 768, 128, device="cuda")
    bias = torch.randn(1, 1, 768, 768, device="cuda")
    assert fma_row_block("fwd", 768, 128) == 32
    out = launch_attention_fwd_fma(x, x, x, bias, 0, 0.1, 0.0)
    assert _rel(out, attention_plain(x, x, x, bias, 0, 0.1, 0.0)) <= TOL[torch.float32]
    with pytest.raises(ValueError):
        launch_attention_bwd_fma(x, x, x, bias, x, 0, 0.1, 0.0)


@pytest.mark.parametrize("L,D", [(256, 64), (256, 128), (257, 64), (257, 128), (512, 32),
                                 (257, 32)])
def test_attention_backward_is_bit_identical_from_run_to_run(cuda, L, D):
    shape = (4, 4, L, D)
    qu, k, v, g = (torch.randn(shape, generator=cuda, device="cuda").bfloat16()
                   for _ in range(4))
    bias = torch.randn((4, 4, L, L), generator=cuda, device="cuda").bfloat16()
    args = (0xFEEDBEEF, D ** -0.5, 0.1)
    out, lse = launch_attention_fwd_mma(qu, k, v, bias, *args)
    first = launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args)
    second = launch_attention_bwd_mma(qu, k, v, bias, g, out, lse, *args)
    for name, a, b in zip(("dqu", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name
    out2, lse2 = launch_attention_fwd_mma(qu, k, v, bias, *args)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4095, 1_000_003])
def test_dropout_kernel_equals_plain(cuda, dtype, n):
    x = torch.randn(n, generator=cuda, device="cuda").to(dtype)
    for seed in (0, 0xFFFFFFFF, 123456789):
        assert torch.equal(launch_dropout(x, seed, 0.1), dropout_plain(x, seed, 0.1))
    xr = x.clone().requires_grad_()
    g = torch.randn_like(x)
    (grad,) = torch.autograd.grad(hash_dropout(xr, 7, 0.2), xr, g)
    assert torch.equal(grad, dropout_plain(g, 7, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 5), (3, 4095), (8, 2, 4097)])
def test_lane_seeded_dropout_kernel_equals_vmapped_plain(cuda, dtype, shape):
    """One seed a lane: the bare launch and ``hash_dropout`` under vmap
    (forward and gradient) against ``dropout_plain`` vmapped, bit for bit."""
    from torch.func import vmap

    plain = vmap(dropout_plain, in_dims=(0, 0, None))
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    seeds = torch.randint(0, 2 ** 32, (shape[0],), generator=cuda, device="cuda")
    seeds[0] = 0xFFFFFFFF
    assert torch.equal(launch_dropout_lanes(x, seeds, 0.1), plain(x, seeds, 0.1))
    xr, g = x.clone().requires_grad_(), torch.randn_like(x)
    before = launches["hash_dropout_lanes"]
    out = vmap(hash_dropout, in_dims=(0, 0, None))(xr, seeds, 0.2)
    (grad,) = torch.autograd.grad(out, xr, g)
    assert launches["hash_dropout_lanes"] == before + 2
    assert torch.equal(out, plain(x, seeds, 0.2)) and torch.equal(grad, plain(g, seeds, 0.2))


CONV_SHAPES = [  # (N, H, W, C, Cout): H not a multiple of the tile, W not of 8
    (2, 19, 37, 64, 64), (2, 16, 64, 64, 64), (2, 13, 30, 128, 128), (1, 9, 21, 64, 128),
    (1, 11, 18, 128, 64)]
# the launch counter each conv kernel adds beside the launch's own name
CONV_TAGS = {"tc": "_tc", "tc_any": "_tc_any", "tc_groups": "_tc_groups", "fma": "",
             "any": "_any"}


def _conv_route_names(prefix, dtype, H, W, C, Cout):
    """The counters a forward and a dx launch of ``prefix`` add at this
    shape: each pass by its own route (dx is the conv of dy, Cout -> C)."""
    names = []
    for kind, pair in (("fwd", (C, Cout)), ("dx", (Cout, C))):
        kernel = conv_kernel(dtype, *pair, H, W)
        assert kernel.startswith("tc") == (dtype == torch.bfloat16)
        names += [f"{prefix}_{kind}", f"{prefix}_{kind}{CONV_TAGS[kernel]}"]
    return names


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    N, H, W, C, Cout = shape
    x = torch.randn((N, H, W, C), generator=cuda, device="cuda").to(dtype)
    w = (0.1 * torch.randn((3, 3, C, Cout), generator=cuda, device="cuda")).to(dtype)
    dy = torch.randn((N, H, W, Cout), generator=cuda, device="cuda").to(dtype)
    assert _rel(conv3x3_fwd(x, w), conv3x3_plain(x.float(), w.float())) <= TOL[dtype]
    assert _rel(conv3x3_dx(dy, w), conv3x3_plain(dy.float(), rot180_io(w).float())) <= TOL[dtype]
    # through autograd: forward and dx are kernel launches, dW the library;
    # bfloat16 runs a tensor-core kernel (row tiles, or image groups where the
    # image is smaller than a row tile: its count rises), float32 the FMA
    names = _conv_route_names("conv3x3", dtype, H, W, C, Cout)
    before = [launches[n] for n in names]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(conv3x3(xr, wr), (xr, wr), dy)
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, 1, 1], names
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    gx_ref, gw_ref = torch.autograd.grad(conv3x3_plain(xf, wf), (xf, wf), dy.float())
    assert _rel(gx, gx_ref) <= TOL[dtype] and _rel(gw, gw_ref) <= TOL[dtype]


@pytest.mark.parametrize("shape", [(2, 19, 38, 64), (2, 16, 64, 32), (1, 7, 10, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_s2d_kernel_matches_plain(cuda, shape, dtype):
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    C = shape[-1]
    w = (0.1 * torch.randn((3, 3, C, C), generator=cuda, device="cuda")).to(dtype)
    dy = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    assert _rel(conv3x3_s2d_fwd(x, w), conv3x3_plain(x.float(), w.float())) <= TOL[dtype]
    assert _rel(conv3x3_s2d_dx(dy, w),
                conv3x3_plain(dy.float(), rot180_io(w).float())) <= TOL[dtype]
    # the conv of x itself on C channels: conv3x3's route at this shape
    # (bfloat16: C = 64 the C = 64 instance, C = 32 the runtime-channel
    # kernel, (7, 10) images the image groups)
    names = _conv_route_names("conv3x3_s2d", dtype, *shape[1:3], C, C)
    before = [launches[n] for n in names]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(conv3x3_s2d(xr, wr), (xr, wr), dy)
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, 1, 1], names
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    gx_ref, gw_ref = torch.autograd.grad(conv3x3_s2d_plain(xf, wf), (xf, wf), dy.float())
    assert _rel(gx, gx_ref) <= TOL[dtype] and _rel(gw, gw_ref) <= TOL[dtype]


# H and W of 1, 2 and the tile's 16 rows / 32 (s2d: 16 view) columns +- 1
CONV_EDGES = [(1, 1, 2), (1, 2, 2), (1, 1, 64), (1, 33, 2), (1, 15, 30), (1, 17, 34),
              (2, 16, 32), (1, 31, 66)]


@pytest.mark.parametrize("nhw", CONV_EDGES)
def test_conv_tensor_core_kernel_at_tile_edges(cuda, nhw):
    """bfloat16, N = 1 included: conv3x3 at all four channel pairs and the
    s2d form, forward and dx, against the plain version, through the
    wrappers (which take the image groups for the small images) and the row
    tiles of ``conv3x3_mma.cu`` launched directly at every shape."""
    N, H, W = nhw
    tol = TOL[torch.bfloat16]
    for C, Cout in ((64, 64), (128, 128), (64, 128), (128, 64)):
        x = torch.randn((N, H, W, C), generator=cuda, device="cuda").bfloat16()
        dy = torch.randn((N, H, W, Cout), generator=cuda, device="cuda").bfloat16()
        w = (0.1 * torch.randn((3, 3, C, Cout), generator=cuda, device="cuda")).bfloat16()
        ref, ref_dx = (conv3x3_plain(x.float(), w.float()),
                       conv3x3_plain(dy.float(), rot180_io(w).float()))
        assert _rel(conv3x3_fwd(x, w), ref) <= tol, (C, Cout)
        assert _rel(conv3x3_dx(dy, w), ref_dx) <= tol, (C, Cout)
        assert _rel(launch_conv3x3_mma(x, pack_weights(w), "rows"), ref) <= tol, (C, Cout)
        assert _rel(launch_conv3x3_mma(dy, pack_weights(rot180_io(w)), "rows"),
                    ref_dx) <= tol, (C, Cout)
    x = torch.randn((N, H, W, 64), generator=cuda, device="cuda").bfloat16()
    w = (0.1 * torch.randn((3, 3, 64, 64), generator=cuda, device="cuda")).bfloat16()
    name = "conv3x3_s2d_fwd" + CONV_TAGS[conv_kernel(torch.bfloat16, 64, 64, H, W)]
    before = launches[name]
    assert _rel(conv3x3_s2d_fwd(x, w), conv3x3_plain(x.float(), w.float())) <= tol
    assert _rel(conv3x3_s2d_dx(x, w), conv3x3_plain(x.float(), rot180_io(w).float())) <= tol
    assert launches[name] == before + 1


def test_conv_tensor_core_kernel_at_front_end_shape_is_bit_identical_from_run_to_run(cuda):
    """(128, 256, 256, 64) bfloat16, the four launches; the kernel uses no
    atomics, so two runs agree bit for bit."""
    shape = (128, 256, 256, 64)
    x = torch.randn(shape, generator=cuda, device="cuda").bfloat16()
    w = (torch.randn((3, 3, 64, 64), generator=cuda, device="cuda") / 24).bfloat16()
    ref = {False: conv3x3_plain(x.float(), w.float()),
           True: conv3x3_plain(x.float(), rot180_io(w).float())}
    for name, fn in (("conv3x3_fwd", conv3x3_fwd), ("conv3x3_dx", conv3x3_dx),
                     ("conv3x3_s2d_fwd", conv3x3_s2d_fwd), ("conv3x3_s2d_dx", conv3x3_s2d_dx)):
        before = launches[name + "_tc"]
        first, second = fn(x, w), fn(x, w)
        assert launches[name + "_tc"] == before + 2, name
        assert torch.equal(first, second), name
        assert _rel(first, ref[name.endswith("_dx")]) <= 1e-2, name


def test_conv_wrappers_reject_what_the_kernel_does_not_take(cuda):
    """What no kernel takes still raises. Channel pairs without an instance
    (once refused) run the runtime-channel kernels (bf16: on the tensor
    cores, here, at 8 x 16 images, in image groups, counted as
    ``_tc_groups``): held here against the plain version with their launches
    counted."""
    x = torch.randn(2, 8, 16, 64, device="cuda")
    w = torch.randn(3, 3, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="even width"):
        conv3x3_s2d(torch.randn(2, 8, 15, 64, device="cuda"), w)
    for fn, plain, C, name in ((conv3x3, conv3x3_plain, 32, "conv3x3_fwd"),
                               (conv3x3_s2d, conv3x3_s2d_plain, 128, "conv3x3_s2d_fwd")):
        xc = torch.randn(2, 8, 16, C, device="cuda", dtype=torch.bfloat16)
        wc = (0.1 * torch.randn(3, 3, C, C, device="cuda")).to(torch.bfloat16)
        tag = CONV_TAGS[conv_kernel(torch.bfloat16, C, C, 8, 16)]
        before = launches[name + tag]
        assert _rel(fn(xc, wc), plain(xc.float(), wc.float())) <= TOL[torch.bfloat16], name
        assert launches[name + tag] == before + 1, name
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3(x.half(), w.half())


# --- the inputs past one launch's grid or 32-bit offsets (chip_smoke.py
# phase edges holds them at larger shapes and times them) ---

@pytest.mark.parametrize("D", [16, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_past_65535_pairs_matches_plain(cuda, D, dtype, rate):
    """B * H = 65600: two launches a pass (counted as chunked), at L = 17,
    whose second launch starts dbias at no 16-byte boundary (the instance
    for any L stores it value by value or as windows)."""
    route = attention_route(dtype, 17, D)
    names = [f"attention_{kind}_{route}_chunked_d{D}" for kind in ("fwd", "bwd")]
    before = [launches[n] for n in names]
    _attention_case(cuda, (16400, 4, 17, D), dtype, rate)
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1]


def _blocked_rows(qu, k, v, bias, g, out, grads, scale, rows=4096):
    """The plain version at rate 0 per (b, h) and block of query rows of an
    attention too large for it in one piece; the largest error of out, dqu,
    dk, dv, dbias relative to max |plain|."""
    B, H, L, _ = qu.shape
    diff, peak = [0.0] * 5, [0.0] * 5

    def add(i, a, b):
        a, b = a.detach().float(), b.detach()
        diff[i] = max(diff[i], float((a - b).abs().max()))
        peak[i] = max(peak[i], float(b.abs().max()))

    for b in range(B):
        for h in range(H):
            kf, vf = (t[b, h].float().requires_grad_() for t in (k, v))
            dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
            for r0 in range(0, L, rows):
                sl = (b, h, slice(r0, r0 + rows))
                qb, bb = (t[sl].float().requires_grad_() for t in (qu, bias))
                ob = torch.softmax((qb @ kf.T + bb) * scale, dim=-1) @ vf
                gq, gk, gv, gb = torch.autograd.grad(ob, (qb, kf, vf, bb), g[sl].float())
                add(0, out[sl], ob)
                add(1, grads[0][sl], gq)
                add(4, grads[3][sl], gb)
                dk += gk
                dv += gv
            add(2, grads[1][b, h], dk)
            add(3, grads[2][b, h], dv)
    return [d / p for d, p in zip(diff, peak)]


@pytest.mark.parametrize("shape, dtype", [
    ((1, 1, 65600, 16), torch.bfloat16),
    ((1, 256, 4100, 16), torch.float32),
    ((1, 1, 65600, 16), torch.float32)])
def test_attention_past_2_32_scores_at_rate_0_matches_plain(cuda, shape, dtype):
    """B * H * L * L past 2**32 (bias, dbias offsets past 32 bits), forward
    and backward at rate 0 against the plain version in blocks of rows; at
    rate 0.1 the shape is refused (uint32 dropout index)."""
    B, H, L, _ = shape
    qu, k, v, g = (torch.randn(shape, generator=cuda, device="cuda").to(dtype) for _ in range(4))
    bias = torch.randn((B, H, L, L), generator=cuda, device="cuda", dtype=dtype)
    xs = [t.requires_grad_() for t in (qu, k, v, bias)]
    out = fused_attention(*xs, 0, 0.25, 0.0)
    grads = torch.autograd.grad(out, xs, g)
    errs = _blocked_rows(qu.detach(), k.detach(), v.detach(), bias.detach(), g, out.detach(),
                         grads, 0.25)
    for name, e in zip(("out", "dqu", "dk", "dv", "dbias"), errs):
        assert e <= TOL[dtype], name
    with pytest.raises(ValueError, match="uint32"):
        fused_attention(qu.detach(), k.detach(), v.detach(), bias.detach(), 0, 0.25, 0.1)


@pytest.mark.parametrize("D", [64, 128])
def test_attention_f32_at_long_l_matches_plain(cuda, D):
    """f32 at L = 16384, forward and backward at rate 0 against the plain
    version in blocks of rows, within 1e-4: each tile's 3xTF32 products are
    summed apart from the running sums over L (attention_f32_mma.cu's
    mma_acc_rows), which the tensor core's truncating adder would otherwise
    drift past the tolerance."""
    shape = (1, 1, 16384, D)
    qu, k, v, g = (torch.randn(shape, generator=cuda, device="cuda") for _ in range(4))
    bias = torch.randn((1, 1, 16384, 16384), generator=cuda, device="cuda")
    xs = [t.requires_grad_() for t in (qu, k, v, bias)]
    before = [launches[f"attention_{kind}_tf32x3_d{D}"] for kind in ("fwd", "bwd")]
    out = fused_attention(*xs, 0, D ** -0.5, 0.0)
    grads = torch.autograd.grad(out, xs, g)
    assert [launches[f"attention_{kind}_tf32x3_d{D}"] - b
            for kind, b in zip(("fwd", "bwd"), before)] == [1, 1]
    errs = _blocked_rows(qu.detach(), k.detach(), v.detach(), bias.detach(), g, out.detach(),
                         grads, D ** -0.5)
    for name, e in zip(("out", "dqu", "dk", "dv", "dbias"), errs):
        assert e <= TOL[torch.float32], (name, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_past_2_31_elements_equals_plain(cuda, dtype):
    """n = 2**31 + 2**20: one launch (counted), every element against the
    plain version in slices placed by its index map, bit for bit."""
    n, step = 2 ** 31 + 2 ** 20, 2 ** 27
    x = torch.randn((n,), generator=cuda, device="cuda", dtype=dtype)
    before = launches["hash_dropout"]
    out = launch_dropout(x, 0x9E3779B9, 0.1)
    assert launches["hash_dropout"] == before + 1
    for a in range(0, n, step):
        m = min(step, n - a)
        assert torch.equal(out[a:a + m], dropout_plain(x[a:a + m], 0x9E3779B9, 0.1,
                                                       (m, a + m, a))), a


@pytest.mark.parametrize("shape, dtype", [((65600, 64), torch.float32),
                                          ((2, 2 ** 31 + 64), torch.bfloat16)])
def test_lane_seeded_dropout_past_its_grid_equals_plain(cuda, shape, dtype):
    """65600 lanes (two runs of lanes on the grid) and lanes past 2**31
    elements, each in one launch: each lane's elements against the plain
    version with its seed, bit for bit."""
    from torch.func import vmap

    x = torch.randn(shape, generator=cuda, device="cuda", dtype=dtype)
    seeds = torch.randint(0, 2 ** 32, (shape[0],), generator=cuda, device="cuda")
    before = launches["hash_dropout_lanes"]
    out = launch_dropout_lanes(x, seeds, 0.1)
    assert launches["hash_dropout_lanes"] == before + 1
    if shape[0] > 65535:
        assert torch.equal(out, vmap(dropout_plain, in_dims=(0, 0, None))(x, seeds, 0.1))
        return
    step = 2 ** 27
    for lane in range(shape[0]):
        for a in range(0, shape[1], step):
            m = min(step, shape[1] - a)
            ref = dropout_plain(x[lane, a:a + m], int(seeds[lane]), 0.1, (m, a + m, a))
            assert torch.equal(out[lane, a:a + m], ref), (lane, a)


@pytest.mark.parametrize("lane_numel", [1, 63, 4095])
def test_short_lanes_dropout_equals_plain(cuda, lane_numel):
    """Lanes shorter than a block (one launch of the short-lane kernel,
    counted as ``hash_dropout_lanes_short``), forward and gradient under
    vmap: each lane against the plain version with its seed, bit for bit."""
    from torch.func import vmap

    x = torch.randn((7000, lane_numel), generator=cuda, device="cuda")
    g = torch.randn_like(x)
    seeds = torch.randint(0, 2 ** 32, (7000,), generator=cuda, device="cuda")
    before = [launches[n] for n in ("hash_dropout_lanes", "hash_dropout_lanes_short")]
    xr = x.clone().requires_grad_()
    out = vmap(hash_dropout, in_dims=(0, 0, None))(xr, seeds, 0.1)
    (grad,) = torch.autograd.grad(out, xr, g)
    assert [launches[n] - b for n, b in zip(("hash_dropout_lanes", "hash_dropout_lanes_short"),
                                            before)] == [2, 2]
    plain = vmap(dropout_plain, in_dims=(0, 0, None))
    assert torch.equal(out, plain(x, seeds, 0.1))
    assert torch.equal(grad, plain(g, seeds, 0.1))


@pytest.mark.parametrize("channels", [(3, 64), (64, 48), (96, 160), (256, 256), (5, 24),
                                      (13, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_at_any_channel_count_matches_plain(cuda, channels, dtype):
    """The runtime-channel kernels, forward and dx (counted as ``_any`` in
    f32, ``_tc_any`` in bf16: conv3x3_any_mma.cu on the tensor cores, C % 8
    and Cout % 8 nonzero among them), through autograd against the plain
    version; at C == Cout the s2d form too, on the 2C-channel view."""
    C, Cout = channels
    x = torch.randn((2, 19, 38, C), generator=cuda, device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, Cout), generator=cuda, device="cuda") / (3 * C ** 0.5)).to(dtype)
    dy = torch.randn((2, 19, 38, Cout), generator=cuda, device="cuda").to(dtype)
    forms = [(conv3x3, conv3x3_plain, "conv3x3")]
    if C == Cout:
        forms.append((conv3x3_s2d, conv3x3_s2d_plain, "conv3x3_s2d"))
    tag = "_tc_any" if dtype == torch.bfloat16 else "_any"
    for fn, plain, name in forms:
        names = (f"{name}_fwd{tag}", f"{name}_dx{tag}")
        before = [launches[n] for n in names]
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xr, wr)
        gx, gw = torch.autograd.grad(y, (xr, wr), dy)
        assert [launches[n] - b for n, b in zip(names, before)] == [1, 1], name
        xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
        ref = plain(xf, wf)
        gx_ref, gw_ref = torch.autograd.grad(ref, (xf, wf), dy.float())
        assert _rel(y, ref) <= TOL[dtype] and _rel(gx, gx_ref) <= TOL[dtype], name
        assert _rel(gw, gw_ref) <= TOL[dtype], name


@pytest.mark.parametrize("C", [64, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_past_65535_images_matches_plain(cuda, C, dtype):
    """N = 65600: the FMA kernels launch two runs of images (counted as
    chunked); the tensor-core kernels (bf16: at 2 x 4 images the image
    groups, 32 images a tile, at C = 64 and 3) walk them in one."""
    x = torch.randn((65600, 2, 4, C), generator=cuda, device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, 64), generator=cuda, device="cuda") / (3 * C ** 0.5)).to(dtype)
    tc = dtype == torch.bfloat16
    route = "conv3x3_fwd" + CONV_TAGS[conv_kernel(dtype, C, 64, 2, 4)]
    assert (route == "conv3x3_fwd_tc_groups") == tc
    before = launches["conv3x3_fwd_chunked"], launches[route]
    y = conv3x3_fwd(x, w)
    assert launches["conv3x3_fwd_chunked"] == before[0] + (0 if tc else 1)
    assert launches[route] == before[1] + 1
    assert _rel(y, conv3x3_plain(x.float(), w.float())) <= TOL[dtype]


GROUP_SHAPES = [(65600, 4, 8), (7, 1, 1), (33, 3, 5), (9, 5, 17)]


@pytest.mark.parametrize("nhw", GROUP_SHAPES)
@pytest.mark.parametrize("channels", [(64, 64), (3, 64), (128, 128), (13, 24)])
def test_conv_image_groups_match_plain(cuda, nhw, channels):
    """bfloat16 images smaller than a row tile: a tile of G whole images
    (conv3x3_any_mma.cu's image groups; a ragged last group at (7, 1, 1),
    (33, 3, 5) and (9, 5, 17)), forward and dx through autograd against the
    plain version, each pass counted as ``_tc_groups``."""
    N, H, W = nhw
    C, Cout = channels
    x = torch.randn((N, H, W, C), generator=cuda, device="cuda").bfloat16()
    w = (torch.randn((3, 3, C, Cout), generator=cuda, device="cuda") / (3 * C ** 0.5)).bfloat16()
    dy = torch.randn((N, H, W, Cout), generator=cuda, device="cuda").bfloat16()
    names = _conv_route_names("conv3x3", torch.bfloat16, H, W, C, Cout)
    assert names[1::2] == ["conv3x3_fwd_tc_groups", "conv3x3_dx_tc_groups"]
    before = [launches[n] for n in names]
    xr = x.clone().requires_grad_()
    y = conv3x3(xr, w)
    (gx,) = torch.autograd.grad(y, xr, dy)
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, 1, 1]
    assert _rel(y, conv3x3_plain(x.float(), w.float())) <= TOL[torch.bfloat16]
    assert _rel(gx, conv3x3_plain(dy.float(), rot180_io(w).float())) <= TOL[torch.bfloat16]


def test_conv_image_groups_are_bit_identical_from_run_to_run(cuda):
    """(65600, 4, 8) 64 -> 64 and 3 -> 64 in image groups, forward and dx:
    no atomics, so two runs agree bit for bit; the row tiles launched
    directly agree with them within the tolerance."""
    for C in (64, 3):
        x = torch.randn((65600, 4, 8, C), generator=cuda, device="cuda").bfloat16()
        w = (torch.randn((3, 3, C, 64), generator=cuda, device="cuda") / (3 * C ** 0.5)).bfloat16()
        dy = torch.randn((65600, 4, 8, 64), generator=cuda, device="cuda").bfloat16()
        for fn, inp in ((conv3x3_fwd, x), (conv3x3_dx, dy)):
            assert torch.equal(fn(inp, w), fn(inp, w)), (C, fn.__name__)
        rows = launch_conv3x3_any_mma(x, w, "rows")
        assert _rel(rows, conv3x3_fwd(x, w)) <= TOL[torch.bfloat16], C


@pytest.mark.parametrize("C", [32, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_s2d_runs_on_x_channels(cuda, C, dtype):
    """conv3x3_s2d at C off the old C = 64 instance: the conv of x itself on
    C channels (no block of the expanded weight multiplied), forward and dx
    through autograd, counted by conv3x3's route at C, against
    ``conv3x3_s2d_plain`` (the 2C view with the expanded weight)."""
    shape = (2, 19, 38, C)
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, C), generator=cuda, device="cuda") / (3 * C ** 0.5)).to(dtype)
    dy = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    names = _conv_route_names("conv3x3_s2d", dtype, 19, 38, C, C)
    before = [launches[n] for n in names]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv3x3_s2d(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), dy)
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, 1, 1], names
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    ref = conv3x3_s2d_plain(xf, wf)
    gx_ref, gw_ref = torch.autograd.grad(ref, (xf, wf), dy.float())
    assert _rel(y, ref) <= TOL[dtype] and _rel(gx, gx_ref) <= TOL[dtype]
    assert _rel(gw, gw_ref) <= TOL[dtype]


def test_downstream_step_on_card_matches_cpu(cuda):
    """One finetune step, dropout 0.1, same seeds: card (kernels) against CPU."""
    import numpy as np

    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    cfg = SARSSLConfig().tiny(sig_shape=(64, 16, 2, 2), patch_shape=(64, 1), spec_dembed=64,
                              spat_dembed=32, dropout=0.1, pretrain=False)
    wave, tdoa = synth_batch(np.random.default_rng(0), 4, 15 * 64 + 128)
    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=1)
        step = make_downstream_step(model, FeatureConfig(win_len=128, nfft=128), device=dev)
        out = step(create_train_state(model), wave, tdoa / 16000.0, 1e-3,
                   torch.Generator().manual_seed(2))
        losses[dev] = float(out["loss"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"]), losses


def test_downstream_step_on_rir_data_on_card_matches_cpu(cuda, tmp_path):
    """A batch of speech x real RIR (``MicSigFromRIRDataset``, recorded noise
    mixed in) through one T60 finetune step, dropout 0.1, same seeds: card
    (kernels) against CPU."""
    import numpy as np

    from sarssl_torch.data import (MicSigFromRIRDataset, NpyRIRDataset, SpeakerTreeDataset,
                                   batch_iterator, write_wav)
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import create_train_state, make_downstream_step

    rng = np.random.default_rng(0)
    (tmp_path / "src" / "s1").mkdir(parents=True)
    write_wav(str(tmp_path / "src" / "s1" / "u.wav"),
              (rng.standard_normal((4000, 1)) * 0.1).astype(np.float32), 16000)
    room = tmp_path / "rirs" / "R1" / "A"
    room.mkdir(parents=True)
    for s in range(2):
        rir = rng.standard_normal((800, 2)) * 0.05 * np.exp(-np.arange(800) / 200)[:, None]
        rir[40 + s, 0] = rir[43, 1] = 1.0
        np.save(room / f"SP{s}_MP1-1-2.npy", rir.astype(np.float32).T[None, :, :, None])
        np.savez(room / f"SP{s}_MP1-1-2_info.npz", T60=0.3 + 0.2 * s, fs=16000)
    write_wav(str(room / "_MP1-1-2_Ambient.wav"),
              (rng.standard_normal((3000, 2)) * 0.01).astype(np.float32), 16000)
    nsample = 15 * 64 + 128
    ds = MicSigFromRIRDataset(NpyRIRDataset(str(tmp_path / "rirs")),
                              SpeakerTreeDataset(str(tmp_path / "src"), T=nsample / 16000),
                              T=nsample / 16000, seed=3, length=4)
    wave, annos = next(batch_iterator(ds, 4, seed=1))
    assert wave.shape == (4, nsample, 2)
    cfg = SARSSLConfig().tiny(sig_shape=(64, 16, 2, 2), patch_shape=(64, 1), spec_dembed=64,
                              spat_dembed=32, dropout=0.1, pretrain=False)
    losses = {}
    for dev in ("cuda", "cpu"):
        model = SARSSL(cfg, device=dev, seed=1)
        step = make_downstream_step(model, FeatureConfig(win_len=128, nfft=128), task="T60",
                                    device=dev)
        out = step(create_train_state(model), wave, annos["T60"], 1e-3,
                   torch.Generator().manual_seed(2))
        losses[dev] = float(out["loss"])
    assert np.isfinite(losses["cpu"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"]), losses


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 2, 64, 16, device="cuda")
    bias = torch.randn(2, 2, 64, 64, device="cuda")
    with pytest.raises(ValueError):
        fused_attention(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, bias, 0, 0.1)
    with pytest.raises(ValueError):
        fused_attention(x.half(), x.half(), x.half(), bias.half(), 0, 0.1)
    # past 256 fused_attention pads to the wide instance, whose launcher takes
    # only the multiples of its chunk; no head dim below 1 runs
    wide = torch.randn(2, 2, 64, 257, device="cuda")
    with pytest.raises(ValueError):
        launch_attention_fwd_tf32(wide, wide, wide, bias, 0, 0.1, 0.0)
    empty = torch.randn(2, 2, 64, 0, device="cuda")
    with pytest.raises(ValueError):
        fused_attention(empty, empty, empty, bias, 0, 0.1)
    with pytest.raises(ValueError):
        launch_dropout(torch.randn(4, 4, device="cuda").t(), 0, 0.1)


def test_cli_smoke_on_card_writes_its_files(cuda, tmp_path, capsys):
    """``run_pretrain --smoke`` without ``--cpu`` runs on the card."""
    import json
    import os

    from sarssl_torch.cli.run_pretrain import main

    assert main(["--smoke", "--exp-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "device cuda" in out and "SMOKE PASS" in out
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "best_model.msgpack", "latest_model.msgpack", "model0.msgpack", "model1.msgpack"]
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        assert [json.loads(line)["split"] for line in f] == ["train", "val", "train", "val"]


def test_checkpoint_of_card_tensors_round_trips(cuda, tmp_path):
    """A state on the card, saved and restored into a fresh model on the
    card: parameters, BatchNorm stats and optimizer state bit for bit."""
    import numpy as np

    from sarssl_torch.data.synthetic import synth_batch
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.ops import FeatureConfig
    from sarssl_torch.train import checkpoint as ckpt
    from sarssl_torch.train import create_train_state, make_pretrain_step

    cfg = SARSSLConfig().tiny(sig_shape=(64, 16, 2, 2), patch_shape=(64, 1))
    model = SARSSL(cfg, device="cuda", seed=1)
    state = create_train_state(model)
    wave, _ = synth_batch(np.random.default_rng(0), 4, 15 * 64 + 128)
    step = make_pretrain_step(model, FeatureConfig(win_len=128, nfft=128), device="cuda")
    for _ in range(2):
        step(state, wave, 1e-3, torch.Generator().manual_seed(3))
    ckpt.save_checkpoint(str(tmp_path), state, 1, -0.5)
    fresh = create_train_state(SARSSL(cfg, device="cuda", seed=2))
    ckpt.restore_state(fresh, ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path))))
    for (n, a), b in zip(model.state_dict().items(), fresh.model.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), n
    for mine, theirs in ((state.optimizer.mu, fresh.optimizer.mu),
                         (state.optimizer.nu, fresh.optimizer.nu)):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert fresh.optimizer.count == 2
    assert fresh.optimizer.lr == float(np.float32(state.optimizer.lr))  # stored as optax's f32


@pytest.mark.parametrize("nmic", [2, 4])
def test_downstream_cli_smoke_on_card_writes_its_files(cuda, nmic, tmp_path, capsys):
    """``run_downstream --smoke`` without ``--cpu`` runs the grid on the card:
    the result files, the ensemble, and per-pair MAEs for 4 mics."""
    import json
    import os

    from sarssl_torch.cli.run_downstream import main

    argv = ["--smoke", "--exp-dir", str(tmp_path)] + (["--nmic", "4", "--ch-mode", "MM"]
                                                      if nmic > 2 else [])
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "device cuda" in out and "SMOKE PASS" in out
    cell = tmp_path / "trial0_bs4_lr0.001"
    assert os.path.exists(cell / "ckpt" / "ensemble_model.msgpack")
    with open(tmp_path / "results.json") as f:
        assert set(json.load(f)) == {"task", "mode", "cells", "summary", "best", "best_test_mae"}
    with open(cell / "logs" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["split"] for r in recs][-2:] == ["test", "val_final"]
    assert ("mae_pair5" in recs[-1]) == (nmic > 2)


def test_istft_and_pretext_metrics_on_card_match_cpu(cuda):
    """The STFT -> ISTFT round trip and ``pretext_metrics`` on the card
    against the CPU (f32, TF32 off): within 1e-5 of the largest value, PESQ
    within 1e-3."""
    import numpy as np

    from sarssl_torch.ops import PatchMask, gen_patch_mask, istft, stft
    from sarssl_torch.train.pretext_eval import pretext_metrics

    wave = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4352, 2)).astype(
        np.float32))
    for impl in ("matmul", "fft"):
        back = istft(stft(wave.cuda(), impl=impl)).cpu()
        assert _rel(back[:, 256:-256], wave[:, 256:-256]) <= 1e-5, impl
    rng = np.random.default_rng(1)
    tar = torch.from_numpy(rng.standard_normal((2, 16, 256, 2, 2)).astype(np.float32))
    pred = tar + 0.3 * torch.from_numpy(rng.standard_normal(tar.shape).astype(np.float32))
    mask = gen_patch_mask(torch.Generator().manual_seed(2), 2, 16, 8)
    out = {dev: pretext_metrics({"pred": pred.to(dev), "tar": tar.to(dev),
                                 "mask": PatchMask(*(t.to(dev) for t in mask))},
                                (256, 16, 2, 2), (256, 1), compute_pesq=True)
           for dev in ("cuda", "cpu")}
    for k in ("mse", "mse_mask", "mse_mask_ch"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= 1e-5 * abs(out["cpu"][k]), k
    for k in ("sig_pred", "sig_tar", "pred_tf", "tar_tf"):
        assert _rel(torch.from_numpy(out["cuda"][k]), torch.from_numpy(out["cpu"][k])) <= 1e-5, k
    assert np.abs(out["cuda"]["pesq"] - out["cpu"]["pesq"]).max() <= 1e-3


def test_pretext_test_cli_on_card(cuda, tmp_path, capsys):
    """``run_pretrain --smoke --test`` without ``--cpu``: metrics and dumps."""
    import json
    import math
    import os

    from sarssl_torch.cli.run_pretrain import main

    assert main(["--smoke", "--exp-dir", str(tmp_path)]) == 0
    assert main(["--smoke", "--test", "--exp-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "loaded best checkpoint (epoch" in out and "pretext test: mse" in out
    with open(tmp_path / "test_dumps" / "metrics.json") as f:
        metrics = json.load(f)
    assert set(metrics) == {"mse", "mse_mask", "pesq", "pesq_mask_ch"}
    assert all(math.isfinite(v) for v in metrics.values())
    dumps = set(os.listdir(tmp_path / "test_dumps"))
    assert {"pred0.wav", "tar0.wav", "metrics.json"} | {f"ins_{i}.mat" for i in range(4)} <= dumps
    assert os.path.exists(tmp_path / "config_test.json")


@pytest.mark.parametrize("flags", [["--mel-bins", "8"], ["--pretrain-frozen-encoder"]],
                         ids=["mel_bins", "frozen_encoder"])
def test_pretrain_options_cli_smoke_on_card(cuda, flags, tmp_path, capsys):
    """``--mel-bins`` and ``--pretrain-frozen-encoder`` (from a smoke run's
    checkpoint, whose encoders stay bit-identical) on the card."""
    import numpy as np

    from sarssl_torch.cli.run_pretrain import main
    from sarssl_torch.train import checkpoint as ckpt

    extra = []
    if "--pretrain-frozen-encoder" in flags:
        assert main(["--smoke", "--epochs", "1", "--exp-dir", str(tmp_path / "init")]) == 0
        extra = ["--init-ckpt", str(tmp_path / "init" / "checkpoints")]
    assert main(["--smoke", "--epochs", "1", "--exp-dir", str(tmp_path / "run")] + flags
                + extra) == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    if extra:
        init = ckpt.load_checkpoint(ckpt.best_path(extra[1]))["params"]
        saved = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path / "run" / "checkpoints")))
        for part in ("spec_encoder", "spat_encoder"):
            a, b = saved["params"][part], init[part]
            stack = [(a, b)]
            while stack:
                x, y = stack.pop()
                for k in x:
                    if isinstance(x[k], dict):
                        stack.append((x[k], y[k]))
                    else:
                        np.testing.assert_array_equal(x[k], y[k])


def test_vis_embed_on_card(cuda, tmp_path, capsys):
    """``run_downstream --ds-test --ds-test-mode vis_embed`` on the card."""
    from sarssl_torch.cli.run_downstream import main
    from sarssl_torch.utils import vis

    assert main(["--smoke", "--exp-dir", str(tmp_path / "grid")]) == 0
    assert main(["--smoke", "--ds-test", "--ds-test-mode", "vis_embed", "--ckpt",
                 str(tmp_path / "grid" / "trial0_bs4_lr0.001" / "ckpt"),
                 "--exp-dir", str(tmp_path / "vis")]) == 0
    out = capsys.readouterr().out
    import importlib.util
    plots = vis._plt() is not None and importlib.util.find_spec("sklearn") is not None
    want = str(tmp_path / "vis" / "tsne.png") if plots else None
    assert f"t-SNE saved to {want}" in out


# the on-card synthesizer's deterministic part, card f32 against CPU f32 on the
# same draws, relative to the CPU wave's peak: the same tolerance as JAX's
# against the port's on the CPU (tests/test_torch_device_synth.py)
TOL_SYNTH = 1e-4


@pytest.mark.parametrize("nsample", [16640, 65792])
def test_device_synth_card_matches_cpu(cuda, nsample):
    from sarssl_torch.data import device_synth as ds

    cfg = ds.DeviceSynthConfig(nsample=nsample)
    draws = ds.draw_inputs(torch.Generator().manual_seed(3), 4, cfg)
    want, wl = ds.synth_pair(draws, cfg)
    got, gl = ds.synth_pair({k: v.cuda() for k, v in draws.items()}, cfg)
    assert got.device.type == "cuda" and got.shape == (4, nsample, 2)
    assert _rel(got.cpu(), want) <= TOL_SYNTH
    for k in wl:
        assert _rel(gl[k].cpu(), wl[k]) <= 1e-6, k


def test_synth_batch_device_is_deterministic_on_card(cuda):
    """The same generator seed gives the same batch bit for bit: the images
    reach the frames by a one-hot matmul, not by atomics."""
    from sarssl_torch.data import device_synth as ds

    cfg = ds.DeviceSynthConfig(nsample=65792)
    runs = [ds.synth_batch_device(torch.Generator(device="cuda").manual_seed(7), 16, cfg)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    other = ds.synth_batch_device(torch.Generator(device="cuda").manual_seed(8), 16, cfg)[0]
    assert not torch.equal(runs[0][0], other)
    assert torch.isfinite(runs[0][0]).all()


@pytest.mark.parametrize("shape,dtype", [((2, 4, 128, 64), torch.bfloat16),
                                         ((2, 4, 128, 128), torch.bfloat16),
                                         ((2, 4, 96, 32), torch.float32),
                                         ((2, 4, 65, 64), torch.bfloat16)])
def test_attention_head_shards_are_slices_of_the_full_launch(cuda, shape, dtype):
    """A tensor-parallel rank's heads h0..h0+H/2 with (H, h0), forward and
    backward, equal the head slice of the full launch bit for bit, on the
    route the shape takes, and the plain version with the same arguments."""
    B, H, L, D = shape
    gen = cuda
    qu, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    bias = torch.randn((B, H, L, L), generator=gen, device="cuda").to(dtype)
    seed, scale, rate = 0x9E3779B9, D ** -0.5, 0.1
    xs = [t.clone().requires_grad_() for t in (qu, k, v, bias)]
    full = fused_attention(*xs, seed, scale, rate)
    full_grads = torch.autograd.grad(full, xs, g)
    for h0 in (0, H // 2):
        hs = slice(h0, h0 + H // 2)
        part = [t[:, hs].contiguous().requires_grad_() for t in (qu, k, v, bias)]
        out = fused_attention(*part, seed, scale, rate, H, h0)
        grads = torch.autograd.grad(out, part, g[:, hs].contiguous())
        for a, b in zip((out, *grads), (full, *full_grads)):
            assert torch.equal(a, b[:, hs])
        ys = [t.detach().float().requires_grad_() for t in part]
        ref = attention_plain(*ys, seed, scale, rate, H, h0)
        assert _rel(out, ref) <= TOL[dtype]


def test_dropout_column_shards_are_slices_of_the_full_launch(cuda):
    """The dropout kernel with (row_local, row_total, col_offset), forward
    and gradient, equals the column slice of the full launch and the plain
    version with the same index map, bit for bit."""
    x = torch.randn((4, 33, 96), generator=cuda, device="cuda")
    g = torch.randn_like(x)
    seed, rate = 0x9E3779B9, 0.25
    full, full_g = hash_dropout(x, seed, rate), hash_dropout(g, seed, rate)
    for c0, w in ((0, 32), (32, 32), (64, 32), (8, 40)):
        imap = (w, 96, c0)
        xs = x[..., c0:c0 + w].contiguous().requires_grad_()
        out = hash_dropout(xs, seed, rate, imap)
        (grad,) = torch.autograd.grad(out, xs, g[..., c0:c0 + w].contiguous())
        assert torch.equal(out, full[..., c0:c0 + w])
        assert torch.equal(grad, full_g[..., c0:c0 + w])
        assert torch.equal(out, dropout_plain(xs.detach(), seed, rate, imap))
        assert torch.equal(launch_dropout(xs.detach(), seed, rate, imap), out)
