"""Both CLIs of the port with ``--mesh`` on the CPU: two gloo ranks spawned
with ``torchrun``'s environment (``tests/torch_parallel_ranks.py``), each
calling ``main``, against the unmeshed run in this process, on a small packed
directory: each data rank reads its block of every packed batch, so the two
ranks together step on the unmeshed run's batches with its masks.

``run_downstream --mesh 2x1`` (T60, the flagship model at 0.144 s clips, 1
epoch of 2 steps) gives the unmeshed run's losses and ``results.json`` MAEs
within rel 1e-4. ``run_pretrain --smoke --mesh 2x1`` (the smoke model, 1
epoch of 4 steps) gives its ``diff`` (a function of the batches and the masks
alone) within rel 1e-6 and its losses within rel 1e-4. And the paths that
refuse a mesh raise ``ValueError`` before writing anything.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from sarssl_torch.cli import run_downstream as ds_cli
from sarssl_torch.cli import run_pretrain as pre_cli
from sarssl_torch.data import shards as tsh
from sarssl_torch.data.wavio import write_wav

ITEM = 2600  # samples an item: the smoke clip (2304) and 0.144 s clips fit


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(0)
    tree = root / "tree"
    tree.mkdir()
    for i in range(24):
        write_wav(str(tree / f"{i}.wav"), rng.uniform(-0.9, 0.9, (ITEM, 2)), 16000)
        np.savez(str(tree / f"{i}_info.npz"), TDOA=np.float32(rng.uniform(-3e-4, 3e-4)),
                 T60_edc=np.float32(rng.uniform(0.2, 1.0)), DRR=np.float16(rng.normal(5, 3)),
                 C50=np.float16(rng.normal()), SNR=np.float32(rng.uniform(15, 30)))
    tsh.pack_wav_tree(str(tree), str(root / "packed"), items_per_shard=8)
    yield str(root / "packed")
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed after it (flagship checkpoint files)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close(got, want, key, rtol):
    assert [(r["split"], r["step"]) for r in got] == [(r["split"], r["step"]) for r in want]
    np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=rtol,
                               err_msg=key)


def test_pretrain_mesh_2x1_equals_unmeshed(packed, tmp_path):
    argv = ["--smoke", "--cpu", "--epochs", "1", "--data-dir", packed, "--workers", "0"]
    assert pre_cli.main(argv + ["--exp-dir", str(tmp_path / "one")]) == 0
    rcs = R.spawn(R.cli_rank, 2, "run_pretrain",
                  argv + ["--mesh", "2x1", "--exp-dir", str(tmp_path / "mesh")])
    assert rcs == [0, 0]
    want = _records(tmp_path / "one" / "logs" / "metrics.jsonl")
    got = _records(tmp_path / "mesh" / "logs" / "metrics.jsonl")
    assert len(want) == 2  # 1 epoch of train and val
    _close(got, want, "diff", 1e-6)
    _close(got, want, "loss", 1e-4)
    # rank 0 wrote the checkpoints and the config, once
    ckpts = tmp_path / "mesh" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == sorted(os.listdir(tmp_path / "one" / "checkpoints"))
    with open(tmp_path / "mesh" / "config.json") as f:
        assert json.load(f)["mesh"] == "2x1"


def test_downstream_mesh_2x1_equals_unmeshed(packed, tmp_path):
    argv = ["--ds-train", "--cpu", "--ds-task", "T60", "--T", "0.144", "--data-dir", packed,
            "--ntrial", "1", "--bs-set", "4", "--lr-set", "1e-3", "--epochs", "1",
            "--train-num", "8", "--val-num", "4", "--test-num", "4",
            "--ds-trainmode", "scratchlow", "--workers", "0"]
    assert ds_cli.main(argv + ["--exp-dir", str(tmp_path / "one")]) == 0
    rcs = R.spawn(R.cli_rank, 2, "run_downstream",
                  argv + ["--mesh", "2x1", "--exp-dir", str(tmp_path / "mesh")])
    assert rcs == [0, 0]
    cell = "trial0_bs4_lr0.001"
    want = _records(tmp_path / "one" / cell / "logs" / "metrics.jsonl")
    got = _records(tmp_path / "mesh" / cell / "logs" / "metrics.jsonl")
    _close(got, want, "loss", 1e-4)
    _close(got, want, "mae", 1e-4)
    with open(tmp_path / "one" / "results.json") as f:
        want = json.load(f)
    with open(tmp_path / "mesh" / "results.json") as f:
        got = json.load(f)
    assert got["best"] == want["best"]
    for k in ("val_mae", "test_mae"):
        assert got["cells"][cell][k] == pytest.approx(want["cells"][cell][k], rel=1e-4)


REFUSED = [("run_pretrain", ["--resident"]), ("run_pretrain", ["--device-synth"]),
           ("run_pretrain", ["--test"]), ("run_downstream", ["--grid-vmap"]),
           ("run_downstream", ["--ds-test"])]


@pytest.mark.parametrize("cli,flag", REFUSED, ids=[f"{c} {f[0]}" for c, f in REFUSED])
def test_mesh_refusals_raise(cli, flag, packed, tmp_path):
    main = pre_cli.main if cli == "run_pretrain" else ds_cli.main
    with pytest.raises(ValueError, match="--mesh"):
        main(["--smoke", "--cpu", "--data-dir", packed, "--exp-dir", str(tmp_path),
              "--mesh", "1x1", *flag])
    assert not os.listdir(tmp_path)  # raised before writing anything


@pytest.mark.parametrize("cli", ["run_pretrain", "run_downstream"])
def test_malformed_mesh_raises(cli, tmp_path):
    main = pre_cli.main if cli == "run_pretrain" else ds_cli.main
    with pytest.raises(ValueError, match="DxM"):
        main(["--smoke", "--cpu", "--exp-dir", str(tmp_path), "--mesh", "2"])
    assert not os.listdir(tmp_path)


def test_mesh_that_does_not_tile_one_process_raises(tmp_path):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="tile"):
        pre_cli.main(["--smoke", "--cpu", "--exp-dir", str(tmp_path), "--mesh", "2x1"])
    assert not dist.is_initialized()  # the group it made is gone
