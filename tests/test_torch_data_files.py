"""The port's file datasets and packed shards (``sarssl_torch.data.datasets``,
``sarssl_torch.data.shards``, ``sarssl_torch.cli.pack_data``) against the JAX
package's on the same trees and seeds: the same items, the same batches in
the same row order, the same packed files, and each package reading the
other's packed directory. Every comparison is bit for bit.
"""
import json
import os

import numpy as np
import pytest

from sarssl_torch.cli import pack_data as t_pack_cli
from sarssl_torch.data import datasets as tds
from sarssl_torch.data import scene as tscene
from sarssl_torch.data import shards as tsh
from sarssl_torch.data.rooms import AcousticSamplerConfig
from sarssl_torch.data.wavio import write_wav
from sarssl_tpu.cli import pack_data as j_pack_cli
from sarssl_tpu.data import datasets as jds
from sarssl_tpu.data import native as jnative
from sarssl_tpu.data import scene as jscene
from sarssl_tpu.data import shards as jsh
from sarssl_tpu.data.rooms import AcousticSamplerConfig as JAcousticSamplerConfig

NSAMPLE = 1200
TASKS = ("TDOA", "T60", "DRR", "C50", "C80", "ABS", "SNR", "DOA", "SUR", "VOL")


def _equal(a, b, path="item"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=True), path


def _write_tree(root, rooms=None, n=14, seed=0):
    """A gen_simu-layout tree of random items: ``{i}.wav`` (some with
    ``_dp.wav``), ``{i}_info.npz`` with most labels (item 3 has none, item 5
    no T60_edc); under ``R{r}/`` subdirs when ``rooms`` is given."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root if rooms is None else root / f"R{i % rooms}"
        d.mkdir(parents=True, exist_ok=True)
        write_wav(str(d / f"{i}.wav"), rng.uniform(-0.9, 0.9, (NSAMPLE + i, 2)), 16000)
        if i % 4 == 0:
            write_wav(str(d / f"{i}_dp.wav"), rng.uniform(-0.9, 0.9, (NSAMPLE, 2)), 16000)
        if i == 3:
            continue
        info = {k: np.float32(rng.normal()) for k in TASKS if k not in ("C80", "T60")}
        info["T60_specify"] = np.float32(0.5)
        if i != 5:
            info["T60_edc"] = np.float32(rng.uniform(0.2, 1.0))
        np.savez(str(d / f"{i}_info.npz"), **info)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="module")
def room_tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("rooms"), rooms=3, n=12, seed=1)


def _items(ds):
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("load_anno", [False, True])
def test_fix_mic_sig_dataset_equals_jax(tree, load_anno):
    for data_num, cls in ((None, "FixMicSigDataset"), (6, "FixMicSigDataset"),
                          (None, "FixMicSigDatasetLOCATA")):
        kw = dict(load_anno=load_anno, data_num=data_num,
                  transforms=[tds.Selecting((0, NSAMPLE))])
        jkw = dict(kw, transforms=[jds.Selecting((0, NSAMPLE))])
        t, j = getattr(tds, cls)(tree, **kw), getattr(jds, cls)(tree, **jkw)
        assert t.data_paths == j.data_paths
        _equal(_items(t), _items(j))


def test_transforms_equal_jax():
    x = np.random.default_rng(0).standard_normal((1000, 2)).astype(np.float32)
    for args in ((100,), (100, 30), (2000,)):
        _equal(tds.Segmenting(*args)(x), jds.Segmenting(*args)(x))
    _equal(tds.Selecting((10, 500))(x), jds.Selecting((10, 500))(x))


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_iterator_equals_jax(tree, workers, shuffle, drop_last):
    tr = [tds.Selecting((0, NSAMPLE))]
    t = tds.FixMicSigDataset(tree, load_anno=True, transforms=tr)
    j = jds.FixMicSigDataset(tree, load_anno=True, transforms=[jds.Selecting((0, NSAMPLE))])
    got = list(tds.batch_iterator(t, 4, shuffle=shuffle, seed=5, drop_last=drop_last,
                                  num_workers=workers))
    want = list(jds.batch_iterator(j, 4, shuffle=shuffle, seed=5, drop_last=drop_last,
                                   num_workers=workers))
    assert len(got) == (3 if drop_last else 4)
    _equal(got, want)


def test_mp_batch_iterator_equals_the_thread_loader(tree):
    """Spawned worker processes give the batches the thread loader (and so
    JAX's) gives: an item is a function of its index."""
    ds = tds.FixMicSigDataset(tree, load_anno=True, transforms=[tds.Selecting((0, NSAMPLE))])
    _equal(list(tds.mp_batch_iterator(ds, 4, seed=2, num_workers=2)),
           list(tds.batch_iterator(ds, 4, seed=2)))


def test_random_mix_and_on_the_fly_datasets_equal_jax(tree, monkeypatch):
    from sarssl_torch.data import native
    monkeypatch.setattr(jnative, "_LIB", native.load())  # JAX's C++ path on the port's build
    monkeypatch.setattr(jnative, "_TRIED", True)
    arms_t = [tds.FixMicSigDataset(tree, load_anno=True, data_num=5),
              tds.FixMicSigDataset(tree, load_anno=True)]
    arms_j = [jds.FixMicSigDataset(tree, load_anno=True, data_num=5),
              jds.FixMicSigDataset(tree, load_anno=True)]
    _equal(_items(tds.RandomMixDataset(arms_t, 9, seed=3, probs=[1, 2])),
           _items(jds.RandomMixDataset(arms_j, 9, seed=3, probs=[1, 2])))
    rooms = ((3.0, 5.0), (3.0, 5.0), (2.5, 3.0))
    t = tds.OnTheFlyMicSigDataset(tscene.SceneSynthesizer(
        cfg=AcousticSamplerConfig(room_sz_range=rooms), T=0.3, noise_type="spatial_white"),
        3, seed=4, transforms=[tds.Selecting((0, 4000))])
    j = jds.OnTheFlyMicSigDataset(jscene.SceneSynthesizer(
        cfg=JAcousticSamplerConfig(room_sz_range=rooms), T=0.3, noise_type="spatial_white"),
        3, seed=4, transforms=[jds.Selecting((0, 4000))])
    _equal(_items(t), _items(j))


def _same_packed(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            _equal(dict(np.load(pa)), dict(np.load(pb)), f)
        else:  # the shards' .npy and the meta json: the same bytes
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("which", ["plain", "rooms", "no_anno"])
def test_pack_wav_tree_writes_jax_files_and_reads_back(which, tree, room_tree, tmp_path):
    src = room_tree if which == "rooms" else tree
    kw = dict(nsample=NSAMPLE, load_anno=which != "no_anno", items_per_shard=5)
    meta = tsh.pack_wav_tree(src, str(tmp_path / "t"), **kw)
    assert meta == jsh.pack_wav_tree(src, str(tmp_path / "j"), **kw)
    _same_packed(tmp_path / "t", tmp_path / "j")
    assert ("room" in meta["anno_keys"]) == (which == "rooms")
    # each package reads the other's directory
    for reader, path in ((tsh, tmp_path / "j"), (jsh, tmp_path / "t")):
        assert reader.is_packed(str(path))
    t, j = tsh.PackedDataset(str(tmp_path / "j")), jsh.PackedDataset(str(tmp_path / "t"))
    _equal(_items(t), _items(j))
    if which != "no_anno":
        _equal(t.annos(), j.annos())
        ds = tds.FixMicSigDataset(src, load_anno=True, transforms=[tds.Selecting((0, NSAMPLE))])
        wave, annos = ds[2]
        _equal(t[2][0], wave)  # the packed row is the tree's item
        _equal({k: v for k, v in t[2][1].items() if k != "room"}, annos)


def test_pack_data_cli_equals_jax(tree, tmp_path, capsys):
    args = ["--data-dir", tree, "--nsample", str(NSAMPLE), "--items-per-shard", "4",
            "--data-num", "9"]
    assert t_pack_cli.main(args + ["--out", str(tmp_path / "t")]) == 0
    assert j_pack_cli.main(args + ["--out", str(tmp_path / "j")]) == 0
    _same_packed(tmp_path / "t", tmp_path / "j")
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "t"), "X") == out[1].replace(str(tmp_path / "j"), "X")
    with open(tmp_path / "t" / "packed_meta.json") as f:
        assert json.load(f)["n"] == 9


@pytest.fixture(scope="module")
def packed(tree, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("packed"))
    tsh.pack_wav_tree(tree, d, nsample=NSAMPLE, items_per_shard=4)
    return d


@pytest.mark.parametrize("kw", [
    {}, {"shuffle": True, "seed": 7}, {"drop_last": False},
    {"shuffle": True, "seed": 1, "shard_i": 1, "shard_n": 2},
    {"shuffle": True, "seed": 3, "subset": np.array([1, 4, 5, 8, 9, 13])},
], ids=["in_order", "shuffled", "ragged_last", "host_shard", "subset"])
def test_batch_streams_equal_jax(packed, kw):
    t, j = tsh.PackedDataset(packed), jsh.PackedDataset(packed)
    _equal(list(t.batch_indices(3, **kw)), list(j.batch_indices(3, **kw)))
    _equal(list(t.iter_batches(3, **kw)), list(j.iter_batches(3, **kw)))
    waves = t.all_waves()
    for idx, (w, lab) in zip(t.batch_indices(3, **kw), t.iter_batches(3, **kw)):
        _equal(w, waves[idx])  # a batch is the rows batch_indices names
        _equal(lab, {k: v[idx] for k, v in t.annos().items()})


def test_resident_sources_equal_jax(packed):
    t, j = tsh.PackedDataset(packed, load_anno=False), jsh.PackedDataset(packed, load_anno=False)
    for kw in ({}, {"nsample": 700}, {"limit": 6}):
        _equal(t.all_waves(**kw), j.all_waves(**kw))
        _equal(t.all_waves_i16(**kw), j.all_waves_i16(**kw))
    q, scale = t.all_waves_i16()
    # half a quantization step, plus the f32 rounding of the scaled values
    assert np.abs(q * np.float32(scale) - t.all_waves()).max() <= scale / 2 + 1e-6


def test_too_small_subset_raises_and_room_ids(packed):
    with pytest.raises(ValueError, match="no full batch"):
        list(tsh.PackedDataset(packed).batch_indices(4, subset=np.arange(3)))
    for p in ("a/R12/3_0.wav", "R0/x.wav", "a/b/3.wav", "a/Rx/3.wav"):
        assert tsh.room_id_of_path(p) == jsh.room_id_of_path(p)
    assert tsh.room_id_of_path("a/R12/3_0.wav") == 12
