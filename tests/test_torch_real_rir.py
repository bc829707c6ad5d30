"""The port's RIR-driven downstream data (``sarssl_torch/data/sources.py``,
``data/real_rir.py``, ``utils/metrics.py::cross_validation_datadirs``)
against the JAX package's on the same trees and seeds.

Both packages draw from the same numpy generators in the same order and
convolve with the same scipy calls, so every item, label and split is held
bit for bit (``array_equal``)."""
import pickle

import numpy as np
import pytest

from sarssl_torch.data import datasets as tds
from sarssl_torch.data import real_rir as trr
from sarssl_torch.data import sources as tsrc
from sarssl_torch.data.wavio import write_wav
from sarssl_torch.utils import metrics as tmetrics
from sarssl_tpu.data import datasets as jds
from sarssl_tpu.data import real_rir as jrr
from sarssl_tpu.data import sources as jsrc
from sarssl_tpu.utils import metrics as jmetrics

FS = 16000
T = 0.5


def _decaying(rng, n, nmic, peak=60, tau=1500.0):
    rir = rng.standard_normal((n, nmic)) * 0.05 * np.exp(-np.arange(n) / tau)[:, None]
    for m in range(nmic):
        rir[peak + 3 * m, m] = 1.0
    return rir.astype(np.float32)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A speaker tree (two speakers, one file at 8 kHz), an extracted real-RIR
    tree in the extractor schema (3 rooms; matched noise beside the RIRs and
    in a sibling ``_noise`` tree), a legacy 2-D tree and a simulated-RIR tree
    (4-D and 2-D arrays, one at 48 kHz)."""
    root = tmp_path_factory.mktemp("real_rir")
    rng = np.random.default_rng(0)
    src = root / "src"
    for spk, n_utt in (("spk1", 3), ("spk2", 2)):
        (src / spk).mkdir(parents=True)
        for u in range(n_utt):
            sig = rng.standard_normal((int(0.3 * FS) + 977 * u, 1)) * 0.1
            sig[: FS // 20] *= 1e-3  # a silent lead-in for the silence gates
            write_wav(str(src / spk / f"u{u}.wav"), sig.astype(np.float32), FS)
    write_wav(str(src / "spk2" / "low.wav"),
              (rng.standard_normal((4000, 1)) * 0.1).astype(np.float32), 8000)

    rirs = root / "rirs"
    for r, room in enumerate(("RoomA", "RoomB", "RoomC")):
        d = rirs / room / "Arr"
        d.mkdir(parents=True)
        for s in range(2):
            stem = f"SP{s + 1}_MP{r + 1}-1-2"
            np.save(d / f"{stem}.npy", _decaying(rng, 2400 + 300 * s, 2).T[None, :, :, None])
            info = {"mic_pos": np.array([[0, 0, 1.0], [0.08, 0, 1.0]]), "fs": FS,
                    "room_sz": np.array([4.0 + r, 5.0, 3.0])}
            if s == 0:
                info["T60"] = 0.4 + 0.1 * r
                info["TDOA"] = np.array([3.0 / FS])
            np.savez(d / f"{stem}_info.npz", **info)
        write_wav(str(d / f"_MP{r + 1}-1-2_Ambient.wav"),
                  (rng.standard_normal((int(0.9 * FS), 2)) * 0.01).astype(np.float32), FS)
    noise = root / "rirs_noise" / "RoomA" / "Arr"
    noise.mkdir(parents=True)
    write_wav(str(noise / "_MP1-1-2_Fan.wav"),
              (rng.standard_normal((int(0.8 * FS), 2)) * 0.02).astype(np.float32), 48000)

    legacy = root / "legacy"
    legacy.mkdir()
    for i in range(2):
        np.save(legacy / f"SP{i}.npy", _decaying(rng, 2000, 2))
    write_wav(str(legacy / "SP0_noise.wav"),
              (rng.standard_normal((FS, 2)) * 0.01).astype(np.float32), FS)

    sim = root / "sim"
    sim.mkdir()
    for i in range(3):
        rir = _decaying(rng, 3000, 2)
        dp = np.zeros_like(rir)
        dp[55:70] = rir[55:70]
        arr = rir.T[None, :, :, None] if i != 1 else rir
        dpa = dp.T[None, :, :, None] if i != 1 else dp
        np.save(sim / f"{i}_rir.npy", arr)
        np.savez(sim / f"{i}_rir_info.npz", rir_dp=dpa, T60_edc=np.float32(0.3 + 0.1 * i),
                 room_sz=np.array([5.0, 4.0, 3.0]), TDOA=np.array([2.0 / FS]),
                 mic_pos=np.array([[1.0, 1.0, 1.0], [1.06, 1.0, 1.0]]),
                 fs=48000 if i == 2 else FS)
    return {k: str(v) for k, v in (("src", src), ("rirs", rirs), ("legacy", legacy),
                                   ("sim", sim))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_silence_gates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal(int(1.3 * FS)) * np.repeat(rng.uniform(0, 1, 13) ** 4, FS // 10)
    for kw in ({}, {"rel_threshold": 0.2}, {"min_keep_ratio": 0.95}):
        np.testing.assert_array_equal(tsrc.remove_silence(sig, FS, **kw),
                                      jsrc.remove_silence(sig, FS, **kw))
    for kw in ({}, {"threshold_db": -10.0}):
        np.testing.assert_array_equal(tsrc.energy_vad_trim(sig, FS, **kw),
                                      jsrc.energy_vad_trim(sig, FS, **kw))
    np.testing.assert_array_equal(tsrc.remove_silence(sig[:100], FS),
                                  jsrc.remove_silence(sig[:100], FS))


@pytest.mark.parametrize("clean", [False, True], ids=["plain", "clean_silence"])
def test_speaker_tree_sample_equals_jax(trees, clean):
    t = tsrc.SpeakerTreeDataset(trees["src"], T=T, fs=FS, num_source=2, seed=3,
                                clean_silence=clean)
    j = jsrc.SpeakerTreeDataset(trees["src"], T=T, fs=FS, num_source=2, seed=3,
                                clean_silence=clean)
    assert t.by_speaker == j.by_speaker and len(t) == len(j) == 6
    for _ in range(3):  # the instance generator, drawn in turn
        np.testing.assert_array_equal(t.sample(), j.sample())
    for i in (0, 7, 123):
        np.testing.assert_array_equal(t[i], j[i])
        rt, rj = np.random.default_rng(i), np.random.default_rng(i)
        np.testing.assert_array_equal(t.sample(rt), j.sample(rj))
        assert rt.integers(1 << 30) == rj.integers(1 << 30)  # the same draws consumed


def test_dp_from_rir_window_edges_equal_jax():
    rir = np.zeros((1000, 2), np.float32)
    rir[100, 0] = 1.0
    rir[500, 0] = 0.5
    rir[3, 1] = -1.0  # a peak near the start: the window is clipped at 0
    n0 = int(FS * 2.5 / 1000)
    rir[100 + n0, 0] = 0.25
    rir[100 + n0 + 1, 0] = 0.125
    rir[100 - n0 - 1, 0] = 0.125
    dp = trr.dp_from_rir(rir, FS)
    np.testing.assert_array_equal(dp, jrr.dp_from_rir(rir, FS))
    assert dp[100 + n0, 0] == 0.25 and dp[100 + n0 + 1, 0] == 0 and dp[100 - n0 - 1, 0] == 0
    for fs in (8000, 48000):
        np.testing.assert_array_equal(trr.dp_from_rir(rir, fs, half_ms=1.0),
                                      jrr.dp_from_rir(rir, fs, half_ms=1.0))


def _same_get(a, b):
    (ra, ia, na), (rb, ib, nb) = a, b
    np.testing.assert_array_equal(ra, rb)
    assert sorted(ia) == sorted(ib)
    for k in ia:
        np.testing.assert_array_equal(ia[k], ib[k])
    assert (na is None) == (nb is None)
    if na is not None:
        np.testing.assert_array_equal(na, nb)


@pytest.mark.parametrize("rooms", [None, ["RoomA"], ["RoomB", "RoomC"]])
def test_npy_rir_dataset_get_equals_jax(trees, rooms):
    t = trr.NpyRIRDataset(trees["rirs"], fs=FS, rooms=rooms)
    j = jrr.NpyRIRDataset(trees["rirs"], fs=FS, rooms=rooms)
    assert t.paths == j.paths and len(t) == 2 * (3 if rooms is None else len(rooms))
    for i in range(len(t)):
        assert t._noise_candidates(t.paths[i]) == j._noise_candidates(j.paths[i])
        _same_get(t.get(i), j.get(i))
        _same_get(t.get(i, np.random.default_rng(i)), j.get(i, np.random.default_rng(i)))
    if rooms is None:  # RoomA's sibling noise tree adds a 48 kHz candidate
        assert len(t._noise_candidates(t.paths[0])) == 2


def test_legacy_and_sim_rir_trees_equal_jax(trees):
    t, j = trr.NpyRIRDataset(trees["legacy"], fs=FS), jrr.NpyRIRDataset(trees["legacy"], fs=FS)
    for i in range(len(t)):
        _same_get(t[i], j[i])
    assert t[0][2] is not None and t[1][2] is None
    t, j = trr.SimRIRDataset(trees["sim"], fs=FS), jrr.SimRIRDataset(trees["sim"], fs=FS)
    assert t.paths == j.paths and len(t) == 3
    for i in range(3):
        _same_get(t.get(i), j.get(i))
        assert t.get(i)[1]["rir_dp"].ndim == 2
    with pytest.raises(AssertionError):
        trr.SimRIRDataset._to_2d(np.zeros((2, 3, 4)))


def _arm(pkg, trees, kind, noise_type="", seed=5, length=12):
    rirs = (pkg.NpyRIRDataset(trees["rirs"], fs=FS) if kind == "real"
            else pkg.SimRIRDataset(trees["sim"], fs=FS) if kind == "sim"
            else pkg.NpyRIRDataset(trees["legacy"], fs=FS))
    srcs = (tsrc if pkg is trr else jsrc).SpeakerTreeDataset(trees["src"], T=T, fs=FS)
    return pkg.MicSigFromRIRDataset(rirs, srcs, T=T, fs=FS, seed=seed, length=length,
                                    noise_type=noise_type,
                                    room_sz_for_abs=np.array([6.0, 5.0, 3.0]))


def _same_item(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].shape == (int(T * FS), 2) and a[0].dtype == np.float32
    assert sorted(a[1]) == sorted(b[1]) == ["ABS", "C50", "DRR", "SNR", "T60", "TDOA"]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])


@pytest.mark.parametrize("kind,noise_type", [
    ("real", ""), ("real", "diffuse_white"), ("legacy", ""), ("legacy", "spatial_white"),
    ("sim", "diffuse_white"), ("sim", "spatial_white"), ("sim", "")])
def test_micsig_from_rir_items_equal_jax(trees, kind, noise_type):
    t, j = _arm(trr, trees, kind, noise_type), _arm(jrr, trees, kind, noise_type)
    for i in range(len(t)):
        _same_item(t[i], j[i])
    assert np.isfinite(t[0][1]["DRR"]) and abs(np.abs(t[0][0]).max() - 0.9) < 1e-6


def test_random_mix_of_both_arms_equals_jax(trees):
    t = tds.RandomMixDataset([_arm(trr, trees, "real", seed=8), _arm(trr, trees, "sim",
                                                                     "diffuse_white", seed=9)],
                             length=10, seed=13 * 4 + 5, probs=[1, 1])
    j = jds.RandomMixDataset([_arm(jrr, trees, "real", seed=8), _arm(jrr, trees, "sim",
                                                                     "diffuse_white", seed=9)],
                             length=10, seed=13 * 4 + 5, probs=[1, 1])
    for i in range(10):
        _same_item(t[i], j[i])
    tb = list(tds.batch_iterator(t, 4, shuffle=True, seed=3, num_workers=2))
    jb = list(jds.batch_iterator(j, 4, shuffle=True, seed=3, num_workers=2))
    assert len(tb) == len(jb) == 2
    for (tw, tl), (jw, jl) in zip(tb, jb):
        np.testing.assert_array_equal(tw, jw)
        for k in jl:
            np.testing.assert_array_equal(tl[k], jl[k])


def test_datasets_pickle_to_the_same_items(trees):
    """``--mp-loader`` hands each spawned worker a pickled dataset."""
    ds = tds.RandomMixDataset([_arm(trr, trees, "real"), _arm(trr, trees, "sim")], length=4)
    again = pickle.loads(pickle.dumps(ds))
    for i in range(4):
        _same_item(again[i], ds[i])


def test_one_process_pool_serves_several_datasets(trees, tmp_path, monkeypatch):
    """``--mp-loader``'s pool is made once a run: each call pickles its
    dataset once into a file the workers load, the batches equal the
    threads', and the file is gone after the call."""
    import multiprocessing as mp
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    arms = [_arm(trr, trees, "real", seed=3, length=8), _arm(trr, trees, "sim", "spatial_white",
                                                             seed=4, length=8)]
    with mp.get_context("spawn").Pool(2) as pool:
        for ds in arms:
            want = list(tds.batch_iterator(ds, 4, seed=6, num_workers=2))
            got = list(tds.mp_batch_iterator(ds, 4, seed=6, num_workers=2, pool=pool))
            assert len(got) == len(want) == 2
            for (gw, gl), (ww, wl) in zip(got, want):
                np.testing.assert_array_equal(gw, ww)
                for k in wl:
                    np.testing.assert_array_equal(gl[k], wl[k])
            assert not list(tmp_path.glob("sarssl_loader_*"))


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("seed", [0, 100, 7])
def test_cross_validation_splits_equal_jax(with_val, seed):
    for rooms in (["a", "b", "c"], [f"R{i}" for i in range(7)]):
        got = list(tmetrics.cross_validation_datadirs(rooms, with_val=with_val, seed=seed))
        assert got == list(jmetrics.cross_validation_datadirs(rooms, with_val=with_val,
                                                               seed=seed))
        assert len(got) == len(rooms)
        for split in got:  # no room in two splits of a trial; every room in one
            parts = [split[k] for k in ("train", "val", "test") if k in split]
            assert sorted(sum(parts, [])) == sorted(rooms)
            assert len(split["test"]) == 1 and len(split.get("val", [None])) == 1
