"""The hand-written kernels against their plain versions on a CUDA card.

Marked ``gpu``; each test skips when no card is present. This file imports
no JAX, so on a machine without it run it without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from sarssl_torch.kernels import (attention_plain, dropout_plain, fused_attention,  # noqa: E402
                                  hash_dropout, launches)
from sarssl_torch.kernels.dropout import launch_dropout  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative to max |plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("L", [64, 100, 256])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_kernel_matches_plain(cuda, L, D, dtype, rate):
    shapes = [(2, 3, L, D)] * 3 + [(2, 3, L, L)]
    xs = [torch.randn(s, generator=cuda, device="cuda").to(dtype).requires_grad_()
          for s in shapes]
    g = torch.randn(shapes[0], generator=cuda, device="cuda").to(dtype)
    seed, scale = 0xFEEDBEEF, D ** -0.5
    before = launches[f"attention_fwd_d{D}"]
    out = fused_attention(*xs, seed, scale, rate)
    grads = torch.autograd.grad(out, xs, g)
    assert launches[f"attention_fwd_d{D}"] == before + 1
    ys = [x.detach().float().requires_grad_() for x in xs]
    ref = attention_plain(*ys, seed, scale, rate)
    ref_grads = torch.autograd.grad(ref, ys, g.float())
    for name, a, b in zip(("out", "dqu", "dk", "dv", "dbias"), (out, *grads),
                          (ref, *ref_grads)):
        assert _rel(a, b) <= TOL[dtype], name


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
