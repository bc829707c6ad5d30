"""The vmapped grid's optimizer under every ``make_adam`` chain, on the CPU.

JAX's ``stack_states`` stacks whole ``TrainState``s, so each lane of its
vmapped grid applies the optax chain ``make_adam(lr, b1, b2, weight_decay,
grad_clip)`` built for it. The port's ``StackedAdam`` takes the same four
settings from the stacked states and applies ``Adam.update``'s chain to each
lane: clipping by that lane's own global norm, the decay added before the
lane's rate.

Tolerances, each where it is asserted:
- a lane against the sequential ``Adam`` on the same gradients: rel 1e-6,
  atol 1e-7 (the stacked step multiplies the rate in and subtracts, the
  sequential one adds ``-lr * step``; one rounding apart);
- the port's vmapped step against JAX's ``make_vmapped_downstream_steps`` on
  the tiny model: per-step loss and MAE within rel 1e-5, as
  ``tests/test_torch_grid_vmap.py`` holds the default chain; the same run
  under the default chain misses JAX's by more than 1e-4, so the comparison
  sees the settings.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flax.core import FrozenDict  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.train.state import TrainState as JTrainState  # noqa: E402
from sarssl_tpu.train.state import make_adam as j_make_adam  # noqa: E402
from sarssl_tpu.train.grid import make_vmapped_downstream_steps as j_vmapped_steps  # noqa: E402
from sarssl_tpu.train.grid import stack_states as j_stack_states  # noqa: E402
from sarssl_torch.data import SyntheticPairs  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.train import (Adam, StackedAdam, create_train_state, make_adam,  # noqa: E402
                                make_vmapped_downstream_steps, slice_state, stack_states)
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402
from tiny import CFG, FEAT, NSAMPLE  # noqa: E402

CHAIN = dict(b1=0.5, b2=0.9, weight_decay=1e-2, grad_clip=1.0)
LR = 1e-2
NB = 4
JCFG = type(CFG)(**{**CFG.__dict__, "dropout": 0.0, "pretrain": False})
TFEAT = FeatureConfig(win_len=FEAT.win_len, nfft=FEAT.nfft)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(rng, shapes, scale=1.0):
    return [torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
            for s in shapes]


def _stacked_against_sequential(lrs, grad_scales, steps=3, **chain):
    """StackedAdam over ``len(lrs)`` lanes and one sequential Adam a lane,
    fed the same gradients (lane ``l``'s scaled by ``grad_scales[l]``);
    returns both sets of parameters."""
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    base = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    stacked = [torch.stack([b] * len(lrs)).requires_grad_() for b in base]
    opt = StackedAdam(stacked, **chain)
    singles = [[torch.nn.Parameter(b.clone()) for b in base] for _ in lrs]
    adams = [make_adam(1e-3, **chain)([(str(i), p) for i, p in enumerate(ps)])
             for ps in singles]
    for _ in range(steps):
        grads = [_grads(rng, shapes, s) for s in grad_scales]
        for i, p in enumerate(stacked):
            p.grad = torch.stack([g[i] for g in grads])
        opt.update(torch.tensor(lrs))
        for lane, (ps, a) in enumerate(zip(singles, adams)):
            for p, g in zip(ps, grads[lane]):
                p.grad = g
            a.update(lrs[lane])
    return stacked, singles


def _assert_lanes_equal(stacked, singles):
    for i, p in enumerate(stacked):
        for lane, ps in enumerate(singles):
            torch.testing.assert_close(p.detach()[lane], ps[i].detach(), rtol=1e-6, atol=1e-7)


def test_stacked_lane_takes_the_sequential_adamw_clip_step():
    """A lane under make_adam(lr, b1=0.5, b2=0.9, weight_decay=1e-2,
    grad_clip=1.0) equals the sequential Adam over a few steps."""
    stacked, singles = _stacked_against_sequential([1e-2, 1e-3], [3.0, 0.1], **CHAIN)
    _assert_lanes_equal(stacked, singles)
    default, _ = _stacked_against_sequential([1e-2, 1e-3], [3.0, 0.1])
    assert max(float((a - b).detach().abs().max()) for a, b in zip(stacked, default)) > 1e-4


def test_a_clipped_lane_does_not_clip_its_neighbour():
    """Lane 0's gradients lie far above the clip norm, lane 1's below it:
    each lane is scaled by its own norm, so lane 1 steps unclipped, as its
    sequential cell does (a norm over both lanes would clip it too)."""
    stacked, singles = _stacked_against_sequential([1e-2, 1e-2], [50.0, 0.01], steps=2,
                                                   grad_clip=1.0)
    _assert_lanes_equal(stacked, singles)
    unclipped, _ = _stacked_against_sequential([1e-2, 1e-2], [50.0, 0.01], steps=2)
    for p, q in zip(stacked, unclipped):
        assert torch.equal(p.detach()[1], q.detach()[1])
    assert max(float((p.detach()[0] - q.detach()[0]).abs().max())
               for p, q in zip(stacked, unclipped)) > 1e-4


def _tiny_state(tx, seed=2):
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu", seed=seed)
    return create_train_state(model, tx=tx)


@pytest.mark.parametrize("field,value", [("b1", 0.8), ("b2", 0.99), ("weight_decay", 0.0),
                                         ("grad_clip", None)])
def test_lanes_with_differing_settings_raise(field, value):
    a = _tiny_state(make_adam(LR, **CHAIN))
    b = _tiny_state(make_adam(LR, **{**CHAIN, field: value}))
    with pytest.raises(ValueError, match="differ"):
        stack_states([a, b])


def test_slice_state_returns_the_four_settings():
    st = _tiny_state(make_adam(LR, **CHAIN))
    stacked = stack_states([st, st])
    opt = stacked.optimizer
    assert (opt.b1, opt.b2, opt.weight_decay, opt.grad_clip) == (0.5, 0.9, 1e-2, 1.0)
    lane = slice_state(stacked, 1).optimizer
    assert isinstance(lane, Adam)
    assert (lane.b1, lane.b2, lane.weight_decay, lane.grad_clip) == (0.5, 0.9, 1e-2, 1.0)
    assert lane.state_dict()["inner_state"].keys() == st.optimizer.state_dict()[
        "inner_state"].keys()


@pytest.fixture(scope="module")
def jax_chain():
    """JAX's downstream state on the tiny config (dropout 0) under CHAIN, as
    its ``create_train_state`` builds it (the init jitted: a third of the
    eager init's time, the same weights), and the port's weights from it."""
    nf, nt, nreim, nmic = JCFG.sig_shape
    jm = JSARSSL(JCFG)
    variables = jax.jit(lambda key, x: jm.init({"params": key}, x, None, False))(
        jax.random.key(0), jnp.zeros((NB, nmic, nf, nt, nreim)))
    tx = j_make_adam(LR, **CHAIN)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                         batch_stats=variables.get("batch_stats", FrozenDict()),
                         opt_state=tx.init(variables["params"]), tx=tx)
    params, buffers = from_jax_params(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    return jm, jstate, {**params, **buffers}


def _port_losses(sd, data, chain):
    model = SARSSL(SARSSLConfig(**JCFG.__dict__), device="cpu")
    model.load_state_dict(sd, strict=True)
    train, _ = make_vmapped_downstream_steps(model, TFEAT, device="cpu")
    stacked = stack_states([create_train_state(model, tx=make_adam(LR, **chain))] * 2)
    lrs = torch.tensor([LR, LR / 10])
    out = []
    for w, g in data:
        m = train(stacked, np.stack([w] * 2), np.stack([g] * 2), lrs,
                  torch.zeros((2, 0), dtype=torch.int64))
        out.append((m["loss"].numpy(), m["mae"].numpy()))
    return out


def test_vmapped_lane_equals_jax_vmapped_lane_under_adamw_clip(jax_chain):
    """Three vmapped steps of two lanes (lr 1e-2, 1e-3) under CHAIN: each
    step's per-lane loss and MAE equal JAX's ``make_vmapped_downstream_steps``
    on states built with the same ``make_adam``."""
    jm, jstate, sd = jax_chain
    data = [(w, g["TDOA"].astype(np.float32)) for w, g in SyntheticPairs(
        nsample=NSAMPLE, seed=11).batches(NB, 3, with_labels=True)]
    jtrain, _ = j_vmapped_steps(jm, FEAT)
    jst = j_stack_states([jstate] * 2)
    jlrs = jnp.asarray([LR, LR / 10], jnp.float32)
    keys = jax.random.split(jax.random.key(5), 2)
    want = []
    for w, g in data:
        jst, m = jtrain(jst, jnp.asarray(np.stack([w] * 2)), jnp.asarray(np.stack([g] * 2)),
                        jlrs, keys)
        want.append((np.asarray(m["loss"]), np.asarray(m["mae"])))
    got = _port_losses(sd, data, CHAIN)
    for step, ((gl, gm), (wl, wm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(gm, wm, rtol=1e-5, err_msg=f"mae, step {step}")
    default = _port_losses(sd, data, {})
    assert max(abs(d[0] - w[0]).max() / abs(w[0]).max() for d, w in zip(default, want)) > 1e-4
