"""The port's downstream CLI (``sarssl_torch.cli.run_downstream``) against
the JAX package's: the same parser (flags, defaults, ``dest`` names, so the
same ``config.json`` keys), ``--smoke`` on the CPU with the JAX CLI's result
files, a JAX-written ``--pretrain-ckpt`` (the same keys loaded as JAX's
``partial_load``), the lineareval freeze through the ensemble, ``--ds-test``
in both ported modes, the multi-pair run, the results reader on the committed
JAX grids, every unported flag raising, the grids ``--grid-vmap`` refuses, and no
silent fall-back to the CPU.

Tolerances: ``--ds-test``'s printed test MAE against the grid's ``test_mae``
to the printed 5 decimals (the same model on the same batches); the no-train
baseline against JAX's on the same targets to the printed 5 decimals; the
frozen encoders exact; the results tables equal.
"""
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from scipy.io import loadmat  # noqa: E402

from sarssl_tpu.cli.run_downstream import build_parser as j_build_parser  # noqa: E402
from sarssl_tpu.data import SyntheticPairs as JSyntheticPairs  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_tpu.train.checkpoint import partial_load as j_partial_load  # noqa: E402
from sarssl_tpu.train.learner import mae_without_training as j_mae_wo  # noqa: E402
from sarssl_tpu.train.steps import _target_transform as j_target  # noqa: E402
from sarssl_tpu.utils import results as jresults  # noqa: E402
from sarssl_torch.cli.run_downstream import build_parser, grid_summary, main  # noqa: E402
from sarssl_torch.utils import results as tresults  # noqa: E402
from sarssl_torch.utils.weights import _key, from_jax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "trial0_bs4_lr0.001"
# the keys of a JAX results.json (sarssl_tpu/cli/run_downstream.py:648-678)
RESULT_KEYS = {"task", "mode", "cells", "summary", "best", "best_test_mae"}
CELL_KEYS = {"val_mae", "test_mae", "lr", "bs", "trial", "epochs_run"}
NF, NT = 256, 8  # the smoke model: 2304 samples -> 8 frames of 256 bins


def _smoke(exp, *more):
    return main(["--smoke", "--cpu", "--exp-dir", str(exp), *more])


def _records(exp, cell=CELL):
    with open(os.path.join(exp, cell, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _torch_name(jax_key: str) -> str:
    *path, leaf = jax_key.split("/")
    return _key(path, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))


@pytest.fixture(scope="module")
def jax_pretrain_dir(tmp_path_factory):
    """A JAX pretext state of the smoke model's widths, saved by the JAX
    package as ``best_model`` (f32)."""
    jcfg = JSARSSLConfig(dtype="float32").tiny(sig_shape=(NF, NT, 2, 2), patch_shape=(NF, 1),
                                               spec_dembed=32, spat_dembed=16)
    mask = gen_patch_mask(jax.random.key(0), 2, jcfg.npatch, jcfg.effective_nmasked())
    state = j_create_state(JSARSSL(jcfg), jax.random.key(7), jnp.zeros((2, 2, NF, NT, 2)), mask)
    d = tmp_path_factory.mktemp("jax_pretrain")
    jckpt.save_checkpoint(str(d), state, 5, -1.0, is_best=True)
    return str(d)


def test_parser_matches_jax():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                         a.const) for a in parser._actions}
    assert table(build_parser()) == table(j_build_parser())
    assert vars(build_parser().parse_args([])) == vars(j_build_parser().parse_args([]))


def test_smoke_on_cpu_passes_and_writes_jax_files(tmp_path, capsys):
    assert _smoke(tmp_path) == 0
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and "TF32 off" in out and "device cpu" in out
    with open(tmp_path / "config.json") as f:
        assert set(json.load(f)) == set(vars(j_build_parser().parse_args([])))
    with open(tmp_path / "results.json") as f:
        res = json.load(f)
    assert set(res) == RESULT_KEYS and set(res["cells"]) == {CELL}
    assert set(res["cells"][CELL]) == CELL_KEYS
    assert res["best"] == "bs4_lr0.001" and res["summary"]["bs4_lr0.001"]["mean_test_mae"] == \
        res["best_test_mae"] == res["cells"][CELL]["test_mae"]
    assert (res["task"], res["mode"], res["cells"][CELL]["epochs_run"]) == ("TDOA", "finetune", 3)
    for f in glob.glob(os.path.join(REPO, "exp", "ds_r3", "*", "results.json")):
        with open(f) as fh:  # a committed JAX grid has the same keys
            j = json.load(fh)
        assert set(j) == RESULT_KEYS and set(next(iter(j["cells"].values()))) == CELL_KEYS
    mat = loadmat(str(tmp_path / "results.mat"))["results"]
    assert set(mat.dtype.names) == RESULT_KEYS
    ckpt_files = set(os.listdir(tmp_path / CELL / "ckpt"))
    assert {"ensemble_model.msgpack", "best_model.msgpack", "latest_model.msgpack"} <= ckpt_files
    recs = _records(tmp_path)
    assert [(r["split"], r["step"]) for r in recs] == [
        ("train", 0), ("val", 0), ("train", 1), ("val", 1), ("train", 2), ("val", 2),
        ("test", 3), ("val_final", 3)]
    assert all(set(r) == ({"split", "step", "time", "loss", "mae", "lr"} if r["split"] == "train"
                          else {"split", "step", "time", "loss", "mae"}) for r in recs)
    # only the last 5 best epochs' files stay; the ensemble file is JAX-readable
    val = [r["mae"] for r in recs if r["split"] == "val"]
    from sarssl_tpu.train.learner import EarlyStopping, smooth_data
    stop, best = EarlyStopping(2), []
    for e in range(3):
        if stop.update(-smooth_data(val[:e + 1])[-1]):
            best.append(e)
    assert {f for f in ckpt_files if re.fullmatch(r"model\d+\.msgpack", f)} == \
        {f"model{e}.msgpack" for e in best[-5:]}
    ens = jckpt.load_checkpoint(jckpt.ensemble_path(str(tmp_path / CELL / "ckpt")))
    assert ens["meta"]["epoch"] == -1 and "opt_state" not in ens


def test_pretrain_ckpt_from_jax_loads_jax_keys(jax_pretrain_dir, tmp_path, capsys):
    """The port loads the same keys as JAX's ``partial_load`` of that file
    into the JAX smoke downstream model."""
    jcfg = JSARSSLConfig(dtype="float32", pretrain=False).tiny(
        sig_shape=(NF, NT, 2, 2), patch_shape=(NF, 1), spec_dembed=32, spat_dembed=16,
        pretrain=False)
    ds = j_create_state(JSARSSL(jcfg), jax.random.key(100), jnp.zeros((4, 2, NF, NT, 2)), None)
    payload = jckpt.load_checkpoint(jckpt.best_path(jax_pretrain_dir))
    _, jloaded = j_partial_load(ds.params, payload["params"])
    n = len(jax.tree.leaves(ds.params))
    assert _smoke(tmp_path, "--epochs", "1", "--pretrain-ckpt", jax_pretrain_dir) == 0
    out = capsys.readouterr().out
    assert f"{CELL}: partial_load: {len(jloaded)}/{n} parameters loaded" in out
    from sarssl_torch.cli.run_downstream import pretrained_params
    from sarssl_torch.models import SARSSL, SARSSLConfig
    from sarssl_torch.train import partial_load
    model = SARSSL(SARSSLConfig(**jcfg.__dict__), device="cpu")
    loaded = partial_load(model, pretrained_params(jckpt.best_path(jax_pretrain_dir), False))
    assert sorted(loaded) == sorted(map(_torch_name, jloaded))


def test_lineareval_keeps_the_loaded_encoders_through_the_ensemble(jax_pretrain_dir, tmp_path):
    assert _smoke(tmp_path, "--ds-trainmode", "lineareval", "--pretrain-ckpt",
                  jax_pretrain_dir) == 0
    src = from_jax_params({"params": jckpt.load_checkpoint(
        jckpt.best_path(jax_pretrain_dir))["params"]})[0]
    ens = from_jax_params(jckpt.load_checkpoint(
        jckpt.ensemble_path(str(tmp_path / CELL / "ckpt"))))[0]
    enc = [n for n in ens if n.startswith(("spec_encoder.", "spat_encoder."))]
    assert enc and all(torch.equal(ens[n], src[n]) for n in enc)


def test_lineareval_without_pretrain_ckpt_raises(tmp_path):
    with pytest.raises(ValueError, match="lineareval requires --pretrain-ckpt"):
        _smoke(tmp_path, "--ds-trainmode", "lineareval")


def test_finetune_without_pretrain_ckpt_warns(tmp_path, capsys):
    assert _smoke(tmp_path, "--epochs", "1") == 0
    assert "WARNING: --ds-trainmode finetune without --pretrain-ckpt" in capsys.readouterr().out


def test_pretrain_ckpt_matching_nothing_raises(tmp_path):
    d = tmp_path / "other"
    jckpt.save_named(str(d), type("S", (), {"params": {"x": np.zeros(3, np.float32)},
                                            "batch_stats": {}})(), "best_model")
    with pytest.raises(ValueError, match="matched zero parameter keys"):
        _smoke(tmp_path / "run", "--pretrain-ckpt", str(d))


def test_scratchlow_loads_nothing(jax_pretrain_dir, tmp_path, capsys):
    assert _smoke(tmp_path, "--epochs", "1", "--ds-trainmode", "scratchlow",
                  "--pretrain-ckpt", jax_pretrain_dir) == 0
    assert "partial_load" not in capsys.readouterr().out


def test_ds_test_reads_the_cells_ensemble(tmp_path, capsys):
    """``--ds-test`` on a cell's checkpoint dir restores ``ensemble_model``
    and prints the grid's test MAE for that cell."""
    assert _smoke(tmp_path / "grid") == 0
    with open(tmp_path / "grid" / "results.json") as f:
        want = json.load(f)["cells"][CELL]["test_mae"]
    capsys.readouterr()
    ckpt_dir = str(tmp_path / "grid" / CELL / "ckpt")
    assert _smoke(tmp_path / "test", "--ds-test", "--ckpt", ckpt_dir) == 0
    out = capsys.readouterr().out
    assert f"loaded {ckpt_dir}/ensemble_model.msgpack" in out
    got = float(re.search(r"test \[TDOA\]: loss \S+ MAE (\S+)", out).group(1))
    assert got == pytest.approx(want, abs=5e-6)
    assert not os.path.exists(tmp_path / "test" / "results.json")
    os.remove(os.path.join(ckpt_dir, "ensemble_model.msgpack"))
    assert _smoke(tmp_path / "test", "--ds-test", "--ckpt", ckpt_dir) == 0
    assert f"loaded {ckpt_dir}/best_model.msgpack" in capsys.readouterr().out


def test_ds_test_without_training_equals_jax_baseline(tmp_path, capsys):
    assert _smoke(tmp_path, "--ds-test", "--ds-test-mode", "cal_metric_wo_info") == 0
    out = capsys.readouterr().out

    def targets(seed, num):  # the JAX CLI's smoke batches: bs 4, nsample 2304
        return np.concatenate([np.asarray(j_target("TDOA", jnp.asarray(g["TDOA"])))
                               for _, g in JSyntheticPairs(nsample=2304, seed=seed).batches(
                                   4, num // 4, with_labels=True)])
    r = j_mae_wo(targets(100, 16), targets(2, 8))
    assert (f"no-train baseline [TDOA]: train MAE {r['mae_train']:.5f} test MAE "
            f"{r['mae_test']:.5f} (mean {r['mean']:.5f})") in out


@pytest.mark.parametrize("ch_mode", ["M", "MM"])
def test_multi_pair_smoke_logs_per_pair_maes(ch_mode, jax_pretrain_dir, tmp_path, capsys):
    assert _smoke(tmp_path, "--nmic", "4", "--ch-mode", ch_mode, "--epochs", "2",
                  "--pretrain-ckpt", jax_pretrain_dir) == 0
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out
    n_trunk = len(jax.tree.leaves(jckpt.load_checkpoint(jckpt.best_path(jax_pretrain_dir))[
        "params"]["spec_encoder"])) + len(jax.tree.leaves(jckpt.load_checkpoint(
            jckpt.best_path(jax_pretrain_dir))["params"]["spat_encoder"]))
    assert re.search(rf"partial_load: {n_trunk}/{n_trunk + 6} parameters loaded", out), out
    npair = 3 if ch_mode == "M" else 6
    for r in _records(tmp_path):
        if r["split"] != "train":
            assert {f"mae_pair{k}" for k in range(npair)} <= set(r), r
            assert f"mae_pair{npair}" not in r
            np.testing.assert_allclose(np.mean([r[f"mae_pair{k}"] for k in range(npair)]),
                                       r["mae"], rtol=1e-5)


def test_grid_summary_leaves_non_finite_configs_out(capsys):
    cells = {"a": {"val_mae": float("nan"), "test_mae": 1.0, "lr": 1e-3, "bs": 8, "trial": 0,
                   "epochs_run": 3},
             "b": {"val_mae": 5.0, "test_mae": 4.0, "lr": 1e-4, "bs": 8, "trial": 0,
                   "epochs_run": 3}}
    out = grid_summary("TDOA", "finetune", cells)
    assert out["best"] == "bs8_lr0.0001" and out["best_test_mae"] == 4.0
    assert set(out) == RESULT_KEYS
    assert "1 config(s) with non-finite mean val MAE excluded" in capsys.readouterr().out


def test_results_reader_equals_jax_on_committed_grids(capsys):
    dirs = sorted(os.path.dirname(f) for f in glob.glob(
        os.path.join(REPO, "exp", "ds_r3", "*", "results.json")))
    assert dirs
    for metric in ("test_mae", "val_mae"):
        assert tresults.mae_table(dirs, metric) == jresults.mae_table(dirs, metric)
    for d in dirs:
        assert tresults.read_results(d) == jresults.read_results(d)
    jresults.print_mae_table(dirs)
    want = capsys.readouterr().out
    tresults.print_mae_table(dirs)
    assert capsys.readouterr().out == want


UNPORTED = [["--mesh", "1x1"]]


@pytest.mark.parametrize("flag", UNPORTED, ids=[" ".join(f) for f in UNPORTED])
def test_unported_flags_raise(flag, tmp_path):
    """The flags that raised NotImplementedError until their path was
    ported now run: --mesh 1x1 joins a group of one rank in process, runs the
    smoke to the end and leaves no process group behind."""
    import torch.distributed as dist

    assert _smoke(tmp_path, *flag) == 0
    assert not dist.is_initialized()


GRID_REFUSED = [["--bs-set", "4", "8"], ["--nmic", "4"], ["--rir-cv"], ["--mesh", "1x1"]]


@pytest.mark.parametrize("flag", GRID_REFUSED, ids=[" ".join(f) for f in GRID_REFUSED])
def test_grid_vmap_refusals_raise(flag, tmp_path):
    """The grids --grid-vmap refuses, as the JAX CLI asserts: more than one
    batch size, the multi-pair model, --rir-cv and --mesh."""
    with pytest.raises(ValueError, match="--grid-vmap"):
        _smoke(tmp_path, "--grid-vmap", *flag)
    assert not os.listdir(tmp_path)  # raised before writing anything


def test_synthetic_data_has_no_label_for_other_tasks(tmp_path):
    with pytest.raises(ValueError, match="TDOA labels only"):
        _smoke(tmp_path, "--ds-task", "T60")


def test_without_cpu_and_without_a_gpu_main_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--smoke", "--exp-dir", str(tmp_path)])


@pytest.mark.parametrize("cpu", [True, False], ids=["cpu", "no_cpu_flag"])
def test_module_entry_point(cpu, tmp_path):
    """``python -m sarssl_torch.cli.run_downstream --smoke [--cpu]``: SMOKE
    PASS on the CPU, with the ensemble file; without ``--cpu`` it needs a
    card and fails without one."""
    if not cpu and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, "-m", "sarssl_torch.cli.run_downstream", "--smoke",
                          "--exp-dir", str(tmp_path)] + (["--cpu"] if cpu else []), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if cpu:
        assert out.returncode == 0, out.stderr
        assert "SMOKE PASS" in out.stdout
        assert os.path.exists(tmp_path / CELL / "ckpt" / "ensemble_model.msgpack")
    else:
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
        assert "SMOKE" not in out.stdout
