"""``run_downstream --grid-vmap`` of the port on the CPU: the smoke grid
against the port's sequential grid on the same flags (per-cell MAE, result
files, ensemble files the JAX package reads), ``--trial-set``,
``--time-budget``, a gen_simu -> pack_data -> resident run against the same
run streamed, and ``--room-trials`` from a wav tree and a packed one against
the sequential grid.

Tolerance: per-cell val and test MAE of the vmapped grid against the
sequential one within rel 1e-2 (``TOL_GRID``, as ``chip_smoke.py`` asserts on
the card). Both draw the same batches, generators and dropout masks; the
lanes' grouped convolutions and batched products round otherwise than one
cell's, and the epochs' Adam steps carry that into the weights: the worst
cell of the smoke grid read 2.3e-4 on a CPU, of the flagship grid 1.2e-3 on an
H100. ``--trial-set`` and the resident run against their references: rel
1e-6.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.io import loadmat  # noqa: E402

from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_torch.cli import gen_simu as tgen  # noqa: E402
from sarssl_torch.cli import pack_data as tpack  # noqa: E402
from sarssl_torch.cli import run_downstream as tds_cli  # noqa: E402
from sarssl_torch.data import shards as tsh  # noqa: E402
from sarssl_torch.data.wavio import write_wav  # noqa: E402

TOL_GRID = 1e-2
GRID = ["--smoke", "--cpu", "--ntrial", "2", "--lr-set", "1e-3", "1e-4"]
VMAP = ["--grid-vmap", "--scan-block", "2"]
CELLS = [f"trial{t}_bs4_lr{lr}" for t in (0, 1) for lr in ("0.001", "0.0001")]
RESULT_KEYS = {"task", "mode", "cells", "summary", "best", "best_test_mae"}
CELL_KEYS = {"val_mae", "test_mae", "lr", "bs", "trial", "epochs_run"}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads for these small runs, restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed after it."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _results(exp):
    with open(os.path.join(exp, "results.json")) as f:
        return json.load(f)


def _assert_cells_close(got, want, rtol):
    assert sorted(got) == sorted(want)
    for cell in want:
        for k in ("val_mae", "test_mae"):
            np.testing.assert_allclose(got[cell][k], want[cell][k], rtol=rtol, err_msg=cell)


@pytest.fixture(scope="module")
def smoke_grids(tmp_path_factory):
    """The smoke grid (2 trials x 2 lr, 3 epochs) vmapped and sequential."""
    root = tmp_path_factory.mktemp("grids")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        exps = {}
        for name, more in (("vmap", VMAP), ("seq", [])):
            exps[name] = str(root / name)
            assert tds_cli.main([*GRID, *more, "--exp-dir", exps[name]]) == 0
    finally:
        torch.set_num_threads(n)
    yield exps
    shutil.rmtree(root, ignore_errors=True)


def test_smoke_grid_vmap_equals_the_sequential_grid(smoke_grids):
    g, s = _results(smoke_grids["vmap"]), _results(smoke_grids["seq"])
    assert set(g) == set(s) == RESULT_KEYS and sorted(g["cells"]) == sorted(CELLS)
    _assert_cells_close(g["cells"], s["cells"], TOL_GRID)
    for cell in CELLS:
        assert set(g["cells"][cell]) == CELL_KEYS | {"truncated"}
        assert set(s["cells"][cell]) == CELL_KEYS
        assert g["cells"][cell]["truncated"] is False
        assert g["cells"][cell]["epochs_run"] == s["cells"][cell]["epochs_run"] == 3
    assert g["best"] == s["best"]
    mat_g, mat_s = (loadmat(os.path.join(smoke_grids[k], "results.mat")) for k in ("vmap", "seq"))
    assert set(mat_g["results"].dtype.names) == set(mat_s["results"].dtype.names) == RESULT_KEYS
    with open(os.path.join(smoke_grids["vmap"], "results.partial.json")) as f:
        assert json.load(f) == g["cells"]


def test_grid_cells_write_only_ensembles_that_jax_reads(smoke_grids):
    for cell in CELLS:
        d = os.path.join(smoke_grids["vmap"], cell, "ckpt")
        assert os.listdir(d) == ["ensemble_model.msgpack"]
        got = jckpt.load_checkpoint(jckpt.ensemble_path(d))
        want = jckpt.load_checkpoint(jckpt.ensemble_path(os.path.join(
            smoke_grids["seq"], cell, "ckpt")))
        assert set(got) == set(want) == {"meta", "params", "batch_stats"}
        assert got["meta"]["epoch"] == -1
        for part in ("params", "batch_stats"):
            a, b = (jax_leaves(t[part]) for t in (got, want))
            assert list(a) == list(b) and all(a[k].shape == b[k].shape for k in a)


def jax_leaves(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_leaves(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def test_trial_set_gives_the_full_grids_cells(smoke_grids, tmp_path):
    assert tds_cli.main([*GRID, *VMAP, "--trial-set", "1", "--exp-dir", str(tmp_path)]) == 0
    got = _results(tmp_path)["cells"]
    assert sorted(got) == sorted(CELLS[2:])
    want = {c: _results(smoke_grids["vmap"])["cells"][c] for c in CELLS[2:]}
    _assert_cells_close(got, want, 1e-6)


def test_time_budget_still_writes_results_marked_truncated(tmp_path, capsys):
    assert tds_cli.main([*GRID, *VMAP, "--grid-chunk", "2", "--time-budget", "0.001",
                         "--exp-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("hit its prorated time budget at epoch 0") == 2  # each chunk
    res = _results(tmp_path)
    assert sorted(res["cells"]) == sorted(CELLS)
    for r in res["cells"].values():
        assert r["truncated"] is True and r["epochs_run"] == 1 and np.isfinite(r["test_mae"])
    assert np.isfinite(res["best_test_mae"])


# --------------------------------------------------------------- data on disk

def _downstream(exp, *more):
    """The flagship model at 0.144 s clips (8 frames), as
    tests/test_torch_data_cli.py runs it."""
    return tds_cli.main(["--ds-train", "--cpu", "--T", "0.144", "--ds-trainmode", "scratchlow",
                         "--epochs", "2", "--lr-set", "1e-3", "--bs-set", "2", "--val-num", "4",
                         "--test-num", "4", "--workers", "0", "--exp-dir", str(exp), *more])


def test_packed_grid_stages_the_split_and_equals_the_streamed_grid(tmp_path, capsys,
                                                                    monkeypatch):
    """gen_simu -> pack_data -> --grid-vmap: the packed split staged on the
    device (index gathers), equal to the same grid streamed because the split
    is over a 0 GB budget."""
    d, pk = str(tmp_path / "data"), str(tmp_path / "packed")
    assert tgen.main(["--mode", "sig", "--stage", "train", "--data-num", "6", "--save-dir", d,
                      "--workers", "0", "--T", "1.04", "--noise", "spatial_white",
                      "--t60-range", "0.3", "0.5", "--room-x", "4", "6", "--room-y", "4", "6",
                      "--room-z", "2.5", "3"]) in (0, None)
    assert tpack.main(["--data-dir", d, "--out", pk]) in (0, None)
    flags = ["--ds-task", "T60", "--data-dir", pk, "--train-num", "4", "--ntrial", "2", *VMAP]
    capsys.readouterr()
    assert _downstream(tmp_path / "res", *flags) == 0
    assert "staged 6 train utts" in capsys.readouterr().out
    monkeypatch.setenv("SARSSL_RESIDENT_BUDGET_GB", "0")
    assert _downstream(tmp_path / "stream", *flags) == 0
    assert "exceeds the resident budget" in capsys.readouterr().out
    res, stream = _results(tmp_path / "res"), _results(tmp_path / "stream")
    assert sorted(res["cells"]) == ["trial0_bs2_lr0.001", "trial1_bs2_lr0.001"]
    _assert_cells_close(res["cells"], stream["cells"], 1e-6)


def _room_tree(root, nrooms=4, per_room=4, nsample=2304, seed=0):
    rng = np.random.default_rng(seed)
    for r in range(nrooms):
        d = os.path.join(root, f"R{r}")
        os.makedirs(d)
        for i in range(per_room):
            write_wav(os.path.join(d, f"{i}_0.wav"),
                      rng.standard_normal((nsample, 2)).astype(np.float32) * 0.1, 16000)
            np.savez(os.path.join(d, f"{i}_0_info.npz"), TDOA=np.float32(1e-4 * (r + 1)),
                     T60=np.float32(0.3 + 0.1 * r + 0.01 * i))
    return root


def _eval_tree(root, n=4, nsample=2304, seed=7):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        write_wav(os.path.join(root, f"{i}.wav"),
                  rng.standard_normal((nsample, 2)).astype(np.float32) * 0.1, 16000)
        np.savez(os.path.join(root, f"{i}_info.npz"), TDOA=np.float32(5e-5),
                 T60=np.float32(0.4 + 0.05 * i))
    return root


@pytest.mark.parametrize("packed", [False, True], ids=["wav_tree", "packed"])
def test_room_trials_grid_vmap_equals_the_sequential_grid(packed, tmp_path):
    """Two 2-room trials over a 4-room tree (packed: staged on the device,
    the trials' room blocks gathered by index) through --grid-vmap and the
    sequential grid."""
    tree = _room_tree(str(tmp_path / "tree"))
    if packed:
        tsh.pack_wav_tree(tree, str(tmp_path / "packed"), items_per_shard=6)
        tree = str(tmp_path / "packed")
    val, test = _eval_tree(str(tmp_path / "val")), _eval_tree(str(tmp_path / "test"), seed=8)
    flags = ["--ds-task", "T60", "--room-trials", "--ds-nsimroom", "2", "--data-dir", tree,
             "--val-data-dir", val, "--test-data-dir", test, "--train-num", "8"]
    assert _downstream(tmp_path / "vmap", *flags, "--grid-vmap", "--scan-block", "1") == 0
    assert _downstream(tmp_path / "seq", *flags) == 0
    got, want = _results(tmp_path / "vmap")["cells"], _results(tmp_path / "seq")["cells"]
    assert {c["trial"] for c in got.values()} == {0, 1}
    _assert_cells_close(got, want, TOL_GRID)
