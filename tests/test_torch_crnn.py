"""The port's CRNN ablation encoders against ``sarssl_tpu``: the three
single-model ``EmbedEncoder`` arms (``crnn``, ``crnn-sim``, ``tcrnn``) in
both modes and ``CauCRNN``, at the JAX package's own test shapes
(``tests/test_models_variants.py``: a (16, 8) TF map of 2 x 2 channels in
(16, 1) patches, dembed 16).

Weights: JAX's ``init``, carried onto the port's module by
``from_jax_params`` (strict load) and back by ``to_jax_params`` (exact). The
inputs are the same numpy arrays, drawn from a seed.

Tolerances (f32 on both sides, sums in another order): outputs and
BatchNorm running stats rtol 1e-4 / atol 1e-5; gradients of ``sum(out * w)``
(``w`` seeded) within 1e-4 of each parameter's largest gradient magnitude
(the GRU's recurrence carries rounding through every frame).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

from sarssl_tpu.models.crnn import CauCRNN as JCauCRNN  # noqa: E402
from sarssl_tpu.models.encoder import EmbedEncoder as JEncoder  # noqa: E402
from sarssl_torch.models import CauCRNN, EmbedEncoder  # noqa: E402
from sarssl_torch.models.common import Conv, same_pads  # noqa: E402
from sarssl_torch.utils.weights import flax_tree, from_jax_params, to_jax_params  # noqa: E402

SIG = (16, 8, 2, 2)  # (nf, nt, nreim, nmic)
PATCH = (16, 1)
DEMBED = 16
NB = 2
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_GRAD = 1e-4
CAU = dict(conv_chs=16, rnn_hid=32, out_dim=24)  # the JAX causality test's CauCRNN
CAU_X = (1, 64, 24, 4)
ARMS = [("crnn", "spec"), ("crnn", "spat"), ("crnn-sim", "spec"), ("crnn-sim", "spat"),
        ("tcrnn", "spec"), ("tcrnn", "spat"), ("caucrnn", None)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small ops, restored after the module:
    with one per core they oversubscribe a host whose cores the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    params, buffers = from_jax_params(_np_tree(variables))
    module.load_state_dict({**params, **buffers}, strict=True)
    return module


def _build(local, mode):
    """(JAX module, port module, input): the port's at torch's default init,
    to be overwritten with JAX's."""
    if local == "caucrnn":
        return (JCauCRNN(**CAU), CauCRNN(nch=CAU_X[3], nf=CAU_X[1], **CAU), _rand(CAU_X, 0))
    npatch, dpatch = SIG[1], PATCH[0] * PATCH[1] * SIG[2] * SIG[3]
    kw = dict(model=(local,), mode=mode)
    return (JEncoder(sig_shape=SIG, patch_shape=PATCH, dembed=DEMBED, **kw),
            EmbedEncoder(SIG, PATCH, DEMBED, generator=torch.Generator().manual_seed(0), **kw),
            _rand((NB, npatch, dpatch), 0))


@pytest.fixture(scope="module", params=ARMS, ids=lambda a: "-".join(filter(None, a)))
def arm(request):
    """Each side's eval and train outputs, the train forward's BatchNorm
    stats and the gradients of ``sum(out * w)`` in train mode."""
    jm, tm, x = _build(*request.param)
    variables = _np_tree(jm.init(jax.random.key(1), jnp.asarray(x), False))
    _load(tm, variables)
    params, stats = variables["params"], variables.get("batch_stats", {})

    def train_loss(p, w):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    j_eval = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), False))(variables))
    w = _rand(j_eval.shape, 2)
    (_, (j_train, j_stats)), j_grads = jax.jit(jax.value_and_grad(train_loss, has_aux=True))(
        params, jnp.asarray(w))
    tm.eval()
    with torch.no_grad():
        t_eval = tm(torch.tensor(x), False).numpy()
    tm.train()
    t_train = tm(torch.tensor(x), True)
    (t_train * torch.tensor(w)).sum().backward()
    return dict(variables=variables, module=tm, j_eval=j_eval, t_eval=t_eval,
                j_train=np.asarray(j_train), t_train=t_train.detach().numpy(),
                j_stats=_np_tree(j_stats), j_grads=_np_tree(j_grads), param=request.param,
                local=request.param[0])


def test_eval_forward_matches(arm):
    assert arm["t_eval"].shape == arm["j_eval"].shape
    if arm["local"] != "caucrnn":
        assert arm["t_eval"].shape == (NB, SIG[1], DEMBED)  # (nb, nt == npatch, dembed)
    np.testing.assert_allclose(arm["t_eval"], arm["j_eval"], **TOL)


def test_train_forward_and_batch_stats_match(arm):
    np.testing.assert_allclose(arm["t_train"], arm["j_train"], **TOL)
    _, want = from_jax_params({"params": {}, "batch_stats": arm["j_stats"]})
    got = dict(arm["module"].named_buffers())
    assert set(got) == set(want) and want
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), err_msg=name, **TOL)
    # the stats moved off their init in the train forward
    init = from_jax_params(arm["variables"])[1]
    assert any(not torch.equal(got[n], init[n]) for n in want)


def test_gradients_match(arm):
    want, _ = from_jax_params({"params": arm["j_grads"]})
    got = dict(arm["module"].named_parameters())
    assert set(got) == set(want)
    for name, ref in want.items():
        scale = float(ref.abs().max())
        assert got[name].grad is not None, name
        np.testing.assert_allclose(got[name].grad.numpy(), ref.numpy(), rtol=0,
                                   atol=TOL_GRAD * scale + 1e-12, err_msg=name)


def _flat(tree):
    return {"/".join(map(str, p)): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_to_jax_params_round_trip_is_exact(arm):
    fresh = _build(*arm["param"])[1]
    got = _flat(to_jax_params(_load(fresh, arm["variables"])))
    want = _flat({"params": arm["variables"]["params"],
                  "batch_stats": arm["variables"].get("batch_stats", {})})
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_gru_cells_keep_flax_names():
    jm, tm, x = _build("crnn-sim", "spat")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), False))
    rnn = shapes["params"]["crnn"]["rnn"]
    assert sorted(rnn) == ["GRUCell_0", "GRUCell_1"]
    gates = {"ir": ["bias", "kernel"], "iz": ["bias", "kernel"], "in": ["bias", "kernel"],
             "hr": ["kernel"], "hz": ["kernel"], "hn": ["bias", "kernel"]}
    assert {k: sorted(v) for k, v in rnn["GRUCell_0"].items()} == gates
    names = {n for n, _ in tm.named_parameters() if ".rnn." in n}
    port_leaf = {"kernel": "weight", "bias": "bias"}
    assert names == {f"crnn.rnn.{d}.{'in_' if g == 'in' else g}.{port_leaf[leaf]}"
                     for d in ("fwd", "bwd") for g, leaves in gates.items() for leaf in leaves}
    # no trainable hidden bias on the reset and update gates: torch.gru gets zeros there
    b_hh = tm.crnn.rnn.fwd.gru_weights()[3]
    assert torch.equal(b_hh[:2 * tm.crnn.rnn.fwd.hidden], torch.zeros(2 * tm.crnn.rnn.fwd.hidden))


def test_tcrnn_conv1d_kernel_layout():
    """flax's 1-D kernel (k, cin, cout) is conv1d's (cout, cin, k)."""
    kernel = _rand((3, 5, 7), 3)
    params, _ = from_jax_params({"params": {"crnn": {"conv0a": {"kernel": kernel}}}})
    w = params["crnn.conv0a.weight"].numpy()
    assert w.shape == (7, 5, 3)
    np.testing.assert_array_equal(w, kernel.transpose(2, 1, 0))
    np.testing.assert_array_equal(flax_tree(params)["crnn"]["conv0a"]["kernel"], kernel)


@pytest.mark.parametrize("n,k,s", [(16, 3, 4), (16, 3, 2), (15, 3, 2), (17, 3, 4), (16, 1, 4)])
def test_same_padding_with_stride_matches_flax(n, k, s):
    """flax pads a strided 'SAME' conv (ceil(n/s) - 1) * s + k - n in all, the
    odd row at the end; torch's symmetric padding would shift the windows."""
    x = _rand((2, n, 5, 3), 4)  # NHWC
    conv = fnn.Conv(4, (k, k), strides=(s, 1), use_bias=False)
    v = _np_tree(conv.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    port = Conv(3, 4, (k, k), (s, 1))
    _load(port, v)
    got = port(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    lo, hi = same_pads(n, k, s)
    assert (lo, hi) == ((max((-(-n // s) - 1) * s + k - n, 0)) // 2,
                        max((-(-n // s) - 1) * s + k - n, 0) - lo)
    if (n, k, s) == (16, 3, 4):  # the stride-4 block of the test encoders
        assert (lo, hi) == (0, 0)
        sym = F.conv2d(torch.tensor(x).permute(0, 3, 1, 2), port.weight, None, (s, 1), k // 2)
        sym = sym.permute(0, 2, 3, 1).detach().numpy()
        assert sym.shape == want.shape and np.abs(sym - want).max() > 1e-2


def test_caucrnn_is_causal():
    """As ``tests/test_models_variants.py`` holds JAX's: a change in the last
    raw frame leaves the first pooled frame (frames 0..11) as it was."""
    _, tm, x = _build("caucrnn", None)
    tm.eval()
    with torch.no_grad():
        y = tm(torch.tensor(x), False)
        x2 = x.copy()
        x2[:, :, -1, :] += 10.0
        y2 = tm(torch.tensor(x2), False)
    assert y.shape == (1, 2, CAU["out_dim"])  # 24 frames / (2 * 2 * 3)
    assert float(y.abs().max()) <= tm.max_num_sources + 1e-6
    np.testing.assert_allclose(y2[:, 0].numpy(), y[:, 0].numpy(), atol=1e-6)
    assert not torch.allclose(y2[:, 1], y[:, 1])
