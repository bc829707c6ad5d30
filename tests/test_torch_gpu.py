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
from sarssl_torch.kernels.attention import (launch_attention_bwd_mma,  # noqa: E402
                                            launch_attention_fwd_mma, takes_tensor_cores)
from sarssl_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_fwd, rot180_io  # noqa: E402
from sarssl_torch.kernels.conv_s2d import conv3x3_s2d_dx, conv3x3_s2d_fwd  # noqa: E402
from sarssl_torch.kernels.dropout import launch_dropout  # noqa: E402

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
    f32; asserts which set of kernels ran from the launch counts."""
    B, H, L, D = shape
    shapes = [shape] * 3 + [(B, H, L, L)]
    xs = [torch.randn(s, generator=gen, device="cuda").to(dtype).requires_grad_()
          for s in shapes]
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    seed, scale = 0xFEEDBEEF, D ** -0.5
    names = [f"attention_fwd_d{D}", f"attention_bwd_d{D}", f"attention_fwd_tc_d{D}",
             f"attention_bwd_tc_d{D}"]
    before = [launches[n] for n in names]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    tc = int(takes_tensor_cores(dtype, L, D))
    assert [launches[n] - b for n, b in zip(names, before)] == [1, 1, tc, tc]
    ys = [x.detach().float().requires_grad_() for x in xs]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("L", [64, 100, 256])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_kernel_matches_plain(cuda, L, D, dtype, rate):
    """bfloat16 at head dim 64 or 128 and L a multiple of 64 runs the
    tensor-core kernels (their count rises); every other case the FMA kernels
    (it does not)."""
    assert takes_tensor_cores(dtype, L, D) == (
        dtype == torch.bfloat16 and D in (64, 128) and L in (64, 256))
    _attention_case(cuda, (2, 3, L, D), dtype, rate)


@pytest.mark.parametrize("D", [64, 128])
def test_attention_kernel_matches_plain_at_flagship_shape(cuda, D):
    _attention_case(cuda, (4, 4, 256, D), torch.bfloat16, 0.1)


@pytest.mark.parametrize("D", [64, 128])
def test_attention_backward_is_bit_identical_from_run_to_run(cuda, D):
    shape = (4, 4, 256, D)
    qu, k, v, g = (torch.randn(shape, generator=cuda, device="cuda").bfloat16()
                   for _ in range(4))
    bias = torch.randn((4, 4, 256, 256), generator=cuda, device="cuda").bfloat16()
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


CONV_SHAPES = [  # (N, H, W, C, Cout): H not a multiple of the tile, W not of 8
    (2, 19, 37, 64, 64), (2, 16, 64, 64, 64), (2, 13, 30, 128, 128), (1, 9, 21, 64, 128),
    (1, 11, 18, 128, 64)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    N, H, W, C, Cout = shape
    x = torch.randn((N, H, W, C), generator=cuda, device="cuda").to(dtype)
    w = (0.1 * torch.randn((3, 3, C, Cout), generator=cuda, device="cuda")).to(dtype)
    dy = torch.randn((N, H, W, Cout), generator=cuda, device="cuda").to(dtype)
    assert _rel(conv3x3_fwd(x, w), conv3x3_plain(x.float(), w.float())) <= TOL[dtype]
    assert _rel(conv3x3_dx(dy, w), conv3x3_plain(dy.float(), rot180_io(w).float())) <= TOL[dtype]
    # through autograd: forward and dx are kernel launches, dW the library
    before = launches["conv3x3_fwd"], launches["conv3x3_dx"]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(conv3x3(xr, wr), (xr, wr), dy)
    assert (launches["conv3x3_fwd"], launches["conv3x3_dx"]) == (before[0] + 1, before[1] + 1)
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
    before = launches["conv3x3_s2d_fwd"], launches["conv3x3_s2d_dx"]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(conv3x3_s2d(xr, wr), (xr, wr), dy)
    assert (launches["conv3x3_s2d_fwd"], launches["conv3x3_s2d_dx"]) == (
        before[0] + 1, before[1] + 1)
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    gx_ref, gw_ref = torch.autograd.grad(conv3x3_s2d_plain(xf, wf), (xf, wf), dy.float())
    assert _rel(gx, gx_ref) <= TOL[dtype] and _rel(gw, gw_ref) <= TOL[dtype]


def test_conv_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 8, 16, 64, device="cuda")
    w = torch.randn(3, 3, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="even width"):
        conv3x3_s2d(torch.randn(2, 8, 15, 64, device="cuda"), w)
    with pytest.raises(ValueError, match="no kernel instance"):
        conv3x3(torch.randn(2, 8, 16, 32, device="cuda"), torch.randn(3, 3, 32, 32, device="cuda"))
    with pytest.raises(ValueError, match="no kernel instance"):
        conv3x3_s2d(torch.randn(2, 8, 16, 128, device="cuda"),
                    torch.randn(3, 3, 128, 128, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3(x.half(), w.half())


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 2, 64, 16, device="cuda")
    bias = torch.randn(2, 2, 64, 64, device="cuda")
    with pytest.raises(ValueError):
        fused_attention(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, bias, 0, 0.1)
    with pytest.raises(ValueError):
        fused_attention(x.half(), x.half(), x.half(), bias.half(), 0, 0.1)
    with pytest.raises(ValueError):
        fused_attention(torch.randn(2, 2, 64, 24, device="cuda"), x, x, bias, 0, 0.1)
    with pytest.raises(ValueError):
        launch_dropout(torch.randn(4, 4, device="cuda").t(), 0, 0.1)
