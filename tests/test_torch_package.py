"""Package-level checks of the port: the weight converter maps every flax
leaf, the package (its CLI included) imports nothing of JAX, flax, optax,
msgpack or the JAX package, and entry points refuse to fall back to the CPU
when no GPU is present."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_torch.models import SARSSL, SARSSLConfig  # noqa: E402
from sarssl_torch.ops import FeatureConfig  # noqa: E402
from sarssl_torch.utils.weights import from_jax_params  # noqa: E402
from tiny import CFG  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("spat_layers", [1, 3])
def test_from_jax_params_maps_every_leaf(spat_layers):
    jcfg = type(CFG)(**{**CFG.__dict__, "spat_layers": spat_layers})
    nf, nt, nreim, nmic = jcfg.sig_shape
    x = jnp.zeros((2, nmic, nf, nt, nreim))
    mask = gen_patch_mask(jax.random.key(0), 2, jcfg.npatch, jcfg.effective_nmasked())
    variables = jax.tree.map(np.asarray, JSARSSL(jcfg).init({"params": jax.random.key(1)},
                                                            x, mask, False))
    params, buffers = from_jax_params(variables)
    n_leaves = len(jax.tree.leaves(variables))
    assert len(params) + len(buffers) == n_leaves
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    model.load_state_dict({**params, **buffers}, strict=True)  # no leaf unmapped
    state = model.state_dict()
    assert len(state) == n_leaves
    for name, value in {**params, **buffers}.items():
        assert torch.equal(state[name], value), name
    # layouts: Dense (in, out) -> (out, in); conv HWIO -> OIHW; depthwise (k,1,ch) -> (ch,1,k)
    jp = variables["params"]["spec_encoder"]
    np.testing.assert_array_equal(
        state["spec_encoder.seq.blocks.0.mhsa.query.weight"].numpy(),
        jp["global"]["block0"]["mhsa"]["query"]["kernel"].T)
    np.testing.assert_array_equal(state["spec_encoder.front.conv1.weight"].numpy(),
                                  jp["front"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["spec_encoder.seq.blocks.0.conv.dwconv.weight"].numpy(),
        jp["global"]["block0"]["conv"]["Conv_0"]["kernel"].transpose(2, 1, 0))


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sarssl_torch\n"
        "for m in pkgutil.walk_packages(sarssl_torch.__path__, 'sarssl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sarssl_torch.cli.run_pretrain import build_parser\n"
        "build_parser().parse_args(['--smoke'])\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'sarssl_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('sarssl_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 38  # every module of the slice was imported


def test_sources_name_no_jax_import():
    """No import of the banned packages anywhere in a line (a ``try:
    import msgpack`` fall-back included), nor through ``importlib``."""
    names = r"(jax|jaxlib|flax|optax|msgpack|sarssl_tpu)"
    pattern = re.compile(rf"(^|[\s;:])(import|from)\s+{names}([.\s,]|$)"
                         rf"|import_module\(\s*['\"]{names}['\".]")
    files = list((REPO / "sarssl_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(f.parent.name == "cli" for f in files)
    for f in files:
        for line in f.read_text().splitlines():
            assert not pattern.search(line), f"{f}: {line}"


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from sarssl_torch.train import make_pretrain_step
    from sarssl_torch.utils.device import resolve_device

    cfg = SARSSLConfig(**CFG.__dict__)
    with pytest.raises(RuntimeError, match="cuda"):
        SARSSL(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    model = SARSSL(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_pretrain_step(model, FeatureConfig())


def test_chip_smoke_refuses_without_gpu():
    """With no GPU, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
