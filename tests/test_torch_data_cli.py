"""Both CLIs of the port on the data path, on the CPU, against the JAX
package's data streams: ``run_pretrain`` from a wav tree, a packed directory,
``--resident`` (f32 and int16), ``--device-synth``, ``--extra-val-dirs`` and
``--test --data-dir``; ``run_downstream`` on annotated trees (T60, DRR) with
``--room-trials``, ``--fixed-train-subset`` and ``--ds-test``.

Each run's train batches are caught at the learner and held against the
batches the JAX package's datasets draw for the same seeds, bit for bit (the
int16 staging within half its quantization step plus f32 rounding). The
downstream runs use the flagship model at 0.144 s clips (8 frames), the
pre-training runs the smoke model.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from sarssl_torch.cli import run_downstream as tds_cli
from sarssl_torch.cli import run_pretrain as tpre_cli
from sarssl_torch.data import device_synth
from sarssl_torch.data import shards as tsh
from sarssl_torch.data.wavio import write_wav
from sarssl_torch.train import learner as tlearner
from sarssl_torch.utils import batch_generator
from sarssl_tpu.cli import run_downstream as jds_cli
from sarssl_tpu.data import datasets as jds
from sarssl_tpu.data import shards as jsh

NS_SMOKE = 2304  # the smoke model's clip
SEED = 100  # both CLIs' default --seed
ITEM = 2600  # samples an item in the trees below


def _write_tree(root, n, rooms=None, seed=0):
    """A gen_simu-layout tree of random annotated items (``R{r}/`` subdirs
    when ``rooms`` is given)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root if rooms is None else root / f"R{i % rooms}"
        d.mkdir(parents=True, exist_ok=True)
        write_wav(str(d / f"{i}.wav"), rng.uniform(-0.9, 0.9, (ITEM, 2)), 16000)
        np.savez(str(d / f"{i}_info.npz"), TDOA=np.float32(rng.uniform(-3e-4, 3e-4)),
                 T60_edc=np.float32(rng.uniform(0.2, 1.0)), DRR=np.float16(rng.normal(5, 3)),
                 C50=np.float16(rng.normal()), SNR=np.float32(rng.uniform(15, 30)))
    return str(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    d = {"tree": _write_tree(root / "tree", 20),
         "val": _write_tree(root / "val", 8, seed=1),
         "rooms": _write_tree(root / "rooms", 12, rooms=3, seed=2)}
    for name in ("tree", "rooms"):
        d[name + "_packed"] = str(root / (name + "_packed"))
        tsh.pack_wav_tree(d[name], d[name + "_packed"], items_per_shard=8)
    return d


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads for these small CLI runs, restored after each
    test: with one per core they oversubscribe a host whose cores the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed after it: a flagship downstream cell
    writes ~0.5 GB of checkpoint files."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _host(x):
    return torch.as_tensor(x).cpu().numpy()


@pytest.fixture
def caught(monkeypatch):
    """The train batches each learner was handed, as host arrays."""
    seen = []

    def wrap(cls):
        train_epoch = cls.train_epoch

        def run(self, batches, generator):
            batches = list(batches)
            seen.append([tuple(_host(x) for x in b) if isinstance(b, (tuple, list))
                         else _host(b) for b in batches])
            return train_epoch(self, batches, generator)
        monkeypatch.setattr(cls, "train_epoch", run)

    wrap(tlearner.PretrainLearner)
    wrap(tlearner.DownstreamLearner)
    return seen


def _pretrain(exp, *more):
    """One epoch of the smoke model (4 train batches of 4, 2 val batches)."""
    return tpre_cli.main(["--smoke", "--cpu", "--epochs", "1", "--exp-dir", str(exp), *more])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_packed_epoch(d, epoch, nbatch=4, bs=4, **kw):
    it = jsh.PackedDataset(d, load_anno=False).iter_batches(bs, shuffle=True, seed=SEED + epoch,
                                                            **kw)
    return [w[:, :NS_SMOKE] for _, w in zip(range(nbatch), it)]


def test_pretrain_from_a_wav_tree_draws_jax_batches(data, caught, tmp_path, capsys):
    assert _pretrain(tmp_path, "--data-dir", data["tree"], "--workers", "2") == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    assert len(caught) == 1
    for epoch, got in enumerate(caught):
        ds = jds.FixMicSigDataset(data["tree"], data_num=16,
                                  transforms=[jds.Selecting((0, NS_SMOKE))])
        want = list(jds.batch_iterator(ds, 4, shuffle=True, seed=SEED + epoch))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_pretrain_from_packed_and_resident_draw_the_same_rows(data, caught, tmp_path):
    d = data["tree_packed"]
    assert _pretrain(tmp_path / "p", "--data-dir", d) == 0
    assert _pretrain(tmp_path / "r", "--data-dir", d, "--resident") == 0
    assert _pretrain(tmp_path / "q", "--data-dir", d, "--resident", "--resident-dtype",
                     "int16") == 0
    packed, resident, int16 = caught
    _, scale = jsh.PackedDataset(d).all_waves_i16(NS_SMOKE)
    want = _jax_packed_epoch(d, 0)
    for p, r, q, w in zip(packed, resident, int16, want):
        np.testing.assert_array_equal(p, w)
        np.testing.assert_array_equal(r, w)
        assert np.abs(q - w).max() <= scale / 2 + 1e-6
    # the losses of the streamed and the staged runs are the same
    lp = [r["loss"] for r in _records(tmp_path / "p" / "logs" / "metrics.jsonl")]
    lr = [r["loss"] for r in _records(tmp_path / "r" / "logs" / "metrics.jsonl")]
    assert lp == lr


def test_resident_num_restricts_the_train_rows(data, caught, tmp_path):
    d = data["tree_packed"]
    assert _pretrain(tmp_path, "--data-dir", d, "--resident", "--resident-num", "9") == 0
    for epoch, got in enumerate(caught):
        want = _jax_packed_epoch(d, epoch, nbatch=2, subset=np.arange(9))
        assert len(got) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_resident_refuses_what_it_cannot_stage(data, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="packed"):
        _pretrain(tmp_path, "--data-dir", data["tree"], "--resident")
    with pytest.raises(ValueError, match="packed"):
        _pretrain(tmp_path, "--device-synth", "--resident")
    monkeypatch.setenv("SARSSL_RESIDENT_BUDGET_GB", "0.0001")
    with pytest.raises(ValueError, match="SARSSL_RESIDENT_BUDGET_GB"):
        _pretrain(tmp_path, "--data-dir", data["tree_packed"], "--resident")


def test_device_synth_draws_each_batch_from_its_generator(caught, tmp_path, capsys):
    assert _pretrain(tmp_path, "--device-synth") == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    cfg = device_synth.DeviceSynthConfig(nsample=NS_SMOKE)
    (got,) = caught
    assert len(got) == 4
    for i in (0, 3):
        want, _ = device_synth.synth_batch_device(batch_generator(SEED, "data", 0, i), 4, cfg,
                                                  device="cpu")
        np.testing.assert_array_equal(got[i], want.numpy())
    # the next epoch draws anew
    other, _ = device_synth.synth_batch_device(batch_generator(SEED, "data", 1, 0), 4, cfg,
                                               device="cpu")
    assert not np.array_equal(got[0], other.numpy())


def test_device_synth_without_cpu_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpre_cli.main(["--pretrain", "--device-synth", "--exp-dir", str(tmp_path)])


def test_extra_val_dirs_and_test_on_a_data_dir(data, tmp_path, capsys):
    assert _pretrain(tmp_path, "--data-dir", data["tree"], "--val-data-dir", data["val"],
                     "--extra-val-dirs", data["val"], data["tree"]) == 0
    splits = [r["split"] for r in _records(tmp_path / "logs" / "metrics.jsonl")]
    assert splits.count("val_val") == splits.count("val_tree") == splits.count("val") == 1
    assert "extra val [val]" in capsys.readouterr().out
    assert tpre_cli.main(["--smoke", "--cpu", "--test", "--data-dir", data["val"], "--exp-dir",
                          str(tmp_path)]) == 0
    with open(tmp_path / "test_dumps" / "metrics.json") as f:
        assert np.isfinite(list(json.load(f).values())).all()


def test_pretrain_without_a_data_source_raises(tmp_path):
    with pytest.raises(ValueError, match="no data source"):
        tpre_cli.main(["--pretrain", "--cpu", "--exp-dir", str(tmp_path)])


def _downstream(exp, *more):
    return tds_cli.main(["--ds-train", "--cpu", "--T", "0.144", "--ds-trainmode", "scratchlow",
                         "--epochs", "1", "--lr-set", "1e-3", "--bs-set", "2",
                         "--train-num", "4", "--val-num", "2", "--test-num", "2",
                         "--exp-dir", str(exp), *more])


@pytest.mark.parametrize("task,col", [("T60", "T60_edc"), ("DRR", "DRR")])
def test_downstream_trains_file_labels(task, col, data, caught, tmp_path, capsys):
    assert _downstream(tmp_path, "--ds-task", task, "--data-dir", data["tree"], "--ntrial",
                       "1", "--val-data-dir", data["val"], "--test-data-dir", data["val"]) == 0
    with open(tmp_path / "results.json") as f:
        res = json.load(f)
    assert res["task"] == task and np.isfinite(res["best_test_mae"])
    ds = jds.FixMicSigDataset(data["tree"], load_anno=True, data_num=4,
                              transforms=[jds.Selecting((0, 2304))])
    want = list(jds.batch_iterator(ds, 2, shuffle=True, seed=SEED))
    for (w, g), (jw, jl) in zip(caught[0], want):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(g, jl[task].astype(np.float32))
    if task != "T60":
        return
    # --ds-test on the cell's ensemble reads the test dir
    capsys.readouterr()
    assert tds_cli.main(["--ds-test", "--cpu", "--T", "0.144", "--ds-task", task, "--bs-set", "2",
                         "--data-dir", data["tree"], "--test-data-dir", data["val"],
                         "--test-num", "2", "--ckpt", str(tmp_path / "trial0_bs2_lr0.001" / "ckpt"),
                         "--exp-dir", str(tmp_path / "test")]) == 0
    assert f"test [{task}]" in capsys.readouterr().out


@pytest.mark.parametrize("packed", [False, True], ids=["wav_tree", "packed"])
def test_room_trials_train_on_their_room_blocks(packed, data, caught, tmp_path):
    d = data["rooms_packed" if packed else "rooms"]
    assert _downstream(tmp_path, "--data-dir", d, "--room-trials", "--ds-nsimroom", "1",
                       "--ntrial", "2", "--val-data-dir", data["val"],
                       "--test-data-dir", data["val"]) == 0
    with open(tmp_path / "results.json") as f:
        assert sorted(json.load(f)["cells"]) == ["trial0_bs2_lr0.001", "trial1_bs2_lr0.001"]
    args = tds_cli.build_parser().parse_args(["--room-trials", "--ds-nsimroom", "1"])
    for trial, got in enumerate(caught):
        if packed:
            pds = jsh.PackedDataset(d)
            sub = jds_cli.packed_train_subset(args, pds, 4, trial)
            want = [w[:, :2304] for w, _ in pds.iter_batches(2, shuffle=True,
                                                              seed=SEED + 1000 * trial,
                                                              subset=sub)]
        else:
            ds = jds.FixMicSigDataset(d, load_anno=True, transforms=[jds.Selecting((0, 2304))])
            rows = jds_cli.room_block_rows([jsh.room_id_of_path(p) for p in ds.data_paths], 1,
                                           trial)
            ds.data_paths = [ds.data_paths[i] for i in jds_cli.trial_subset_draw(rows, 4, SEED,
                                                                                   trial)]
            want = [w for w, _ in jds.batch_iterator(ds, 2, shuffle=True,
                                                     seed=SEED + 1000 * trial)]
        assert len(got) == len(want) == 2
        for (w, _), jw in zip(got, want):
            np.testing.assert_array_equal(w, jw)


def test_fixed_train_subset_trains_on_its_draw(data, caught, tmp_path):
    d = data["tree_packed"]
    assert _downstream(tmp_path, "--data-dir", d, "--fixed-train-subset", "--ntrial", "2",
                       "--val-data-dir", data["val"], "--test-data-dir", data["val"]) == 0
    args = tds_cli.build_parser().parse_args(["--fixed-train-subset"])
    for trial, got in enumerate(caught):
        sub = jds_cli.fixed_train_subset(args, 20, 4, trial)
        want = [w[:, :2304] for w, _ in jsh.PackedDataset(d).iter_batches(
            2, shuffle=True, seed=SEED + 1000 * trial, subset=sub)]
        for (w, _), jw in zip(got, want):
            np.testing.assert_array_equal(w, jw)


def test_subset_helpers_equal_jax(data):
    pds = tsh.PackedDataset(data["rooms_packed"])
    for flags in (["--room-trials", "--ds-nsimroom", "1"], ["--fixed-train-subset"], []):
        a_t = tds_cli.build_parser().parse_args(flags)
        a_j = jds_cli.build_parser().parse_args(flags)
        for trial in range(3):
            for num in (2, 4, 50):
                got = tds_cli.packed_train_subset(a_t, pds, num, trial)
                want = jds_cli.packed_train_subset(a_j, jsh.PackedDataset(data["rooms_packed"]),
                                                   num, trial)
                assert (got is None and want is None) or np.array_equal(got, want)
    rooms = [3, 1, 1, 0, 3, 7, 0]
    for nsim, trial in ((1, 0), (2, 1), (1, 3)):
        np.testing.assert_array_equal(tds_cli.room_block_rows(rooms, nsim, trial),
                                      jds_cli.room_block_rows(rooms, nsim, trial))
    with pytest.raises(ValueError, match="rooms"):
        tds_cli.room_block_rows(rooms, 2, 2)


def test_downstream_data_checks_raise(data, tmp_path):
    with pytest.raises(ValueError, match="no data source"):
        tds_cli.main(["--ds-train", "--cpu", "--exp-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="val-data-dir"):
        _downstream(tmp_path, "--data-dir", data["rooms"], "--room-trials")
    with pytest.raises(ValueError, match="composes"):
        _downstream(tmp_path, "--synthetic", "--room-trials")
    with pytest.raises(ValueError, match="expects >= 65792"):
        _downstream(tmp_path, "--data-dir", data["tree"], "--T", "4.112")
    assert not os.path.exists(tmp_path / "results.json")
