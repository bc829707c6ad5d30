"""Both CLIs of the port on real data, on the CPU, against the JAX package's
data streams: ``run_downstream`` with ``--rir-dir``, ``--sim-rir-dir`` and
``--src-dir`` (each arm alone and both at ``--real-sim-ratio 1 1``),
``--rir-cv``, ``--real-sig-dir`` with ``--sim-sig-dir``, and ``--mp-loader``;
``run_pretrain`` with ``--real-corpora``, ``--real-data-dirs``,
``--real-data-probs`` and ``--remove-spkoverlap``.

Each run's batches are caught at the learner and held bit for bit against
the batches the JAX package's datasets draw for the same seeds, built as the
JAX CLI's ``make_batches`` builds them. The downstream runs use the flagship
model at 0.144 s clips (8 frames), the pre-training runs the smoke model."""
import json
import shutil

import numpy as np
import pytest
import torch

from sarssl_torch.cli import run_downstream as tds_cli
from sarssl_torch.cli import run_pretrain as tpre_cli
from sarssl_torch.data.wavio import write_wav
from sarssl_torch.train import learner as tlearner
from sarssl_tpu.data import corpora as jco
from sarssl_tpu.data import datasets as jds
from sarssl_tpu.data import real as jreal
from sarssl_tpu.data import real_rir as jrr
from sarssl_tpu.data import sources as jsrc
from sarssl_tpu.utils import metrics as jmetrics

FS = 16000
NS = 2304  # 0.144 s: the downstream clips and the smoke model's
SEED = 100  # both CLIs' default --seed
ROOMS = ("RoomA", "RoomB", "RoomC")


def _decaying(rng, n, nmic, peak=60):
    rir = rng.standard_normal((n, nmic)) * 0.05 * np.exp(-np.arange(n) / 1500.0)[:, None]
    for m in range(nmic):
        rir[peak + 3 * m, m] = 1.0
    return rir.astype(np.float32)


def _sig_tree(root, n, rng, locata=False):
    root.mkdir(parents=True)
    for i in range(n):
        write_wav(str(root / f"{i}.wav"), rng.uniform(-0.9, 0.9, (NS + 300, 2)), FS)
        annos = {"TDOA": np.float32(rng.uniform(-3e-4, 3e-4))}
        if not locata:
            annos.update(T60_edc=np.float32(rng.uniform(0.2, 1.0)),
                         DRR=np.float32(rng.normal(5, 3)))
        np.savez(str(root / f"{i}_info.npz"), **annos)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root, rng = tmp_path_factory.mktemp("real_cli"), np.random.default_rng(0)
    d = {k: root / k for k in ("src", "rirs", "sim_rirs", "real_sig", "sim_sig", "four",
                               "aishell4", "ami")}
    for spk in ("s1", "s2"):
        (d["src"] / spk).mkdir(parents=True)
        for u in range(2):
            write_wav(str(d["src"] / spk / f"u{u}.wav"),
                      (rng.standard_normal((3000 + 500 * u, 1)) * 0.1).astype(np.float32), FS)
    for r, room in enumerate(ROOMS):
        a = d["rirs"] / room / "Arr"
        a.mkdir(parents=True)
        for s in range(2):
            stem = f"SP{s + 1}_MP1-1-2"
            np.save(a / f"{stem}.npy", _decaying(rng, 1600, 2).T[None, :, :, None])
            np.savez(a / f"{stem}_info.npz", fs=FS, T60=0.3 + 0.1 * r, TDOA=np.array([3 / FS]),
                     room_sz=np.array([4.0 + r, 5.0, 3.0]))
        write_wav(str(a / "_MP1-1-2_Ambient.wav"),
                  (rng.standard_normal((NS + 500, 2)) * 0.01).astype(np.float32), FS)
    d["sim_rirs"].mkdir()
    for i in range(3):
        rir = _decaying(rng, 1800, 2)
        dp = np.zeros_like(rir)
        dp[55:70] = rir[55:70]
        np.save(d["sim_rirs"] / f"{i}_rir.npy", rir.T[None, :, :, None])
        np.savez(d["sim_rirs"] / f"{i}_rir_info.npz", rir_dp=dp.T[None, :, :, None],
                 T60_edc=np.float32(0.3 + 0.1 * i), TDOA=np.array([2 / FS]),
                 mic_pos=np.array([[1.0, 1.0, 1.0], [1.06, 1.0, 1.0]]),
                 room_sz=np.array([5.0, 4.0, 3.0]))
    for split in ("train", "val", "test"):
        _sig_tree(d["real_sig"] / split, 6, rng, locata=True)
    _sig_tree(d["sim_sig"], 6, rng)
    for i in range(3):  # a plain 4-channel real tree
        d["four"].mkdir(exist_ok=True)
        write_wav(str(d["four"] / f"rec{i}.wav"),
                  (rng.standard_normal((FS // 2 + 1000 * i, 4)) * 0.1).astype(np.float32), FS)
    tg = (("hello", 0.0, 0.4), ("", 0.4, 2.0), ("again", 2.0, 2.3))
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             "xmax = 3", "tiers? <exists>", "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', '        name = "SPK01"', "        xmin = 0",
             "        xmax = 3", f"        intervals: size = {len(tg)}"]
    for k, (text, a, b) in enumerate(tg):
        lines += [f"        intervals [{k + 1}]:", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{text}"']
    name = "20200707_M_R001S01C01"
    (d["aishell4"] / "train_M" / "wav").mkdir(parents=True)
    (d["aishell4"] / "train_M" / "TextGrid").mkdir()
    write_wav(str(d["aishell4"] / "train_M" / "wav" / f"{name}.wav"),
              (rng.standard_normal((3 * FS, 8)) * 0.1).astype(np.float32), FS)
    (d["aishell4"] / "train_M" / "TextGrid" / f"{name}.TextGrid").write_text("\n".join(lines))
    audio = d["ami"] / "ScenarioMeetings" / "ES2002" / "audio"
    audio.mkdir(parents=True)
    for k in range(1, 9):
        write_wav(str(audio / f"ES2002a.Array1-0{k}.wav"),
                  (rng.standard_normal((FS // 2, 1)) * 0.1).astype(np.float32), FS)
    return {k: str(v) for k, v in d.items()}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads for these small CLI runs, restored after each
    test (the suite's parallel workers share the host's cores)."""
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


def _batch(b):
    return tuple(_host(x) for x in b) if isinstance(b, (tuple, list)) else _host(b)


@pytest.fixture
def caught(monkeypatch):
    """{'train': [...], 'eval': [...]}: the batches each learner epoch was
    handed, in order (a downstream cell evaluates val, then test and val
    again), as host arrays."""
    seen = {"train": [], "eval": []}

    def wrap(cls, name):
        fn = getattr(cls, name)

        def run(self, batches, *a, **k):
            batches = list(batches)
            seen["train" if name == "train_epoch" else "eval"].append(
                [_batch(b) for b in batches])
            return fn(self, batches, *a, **k)
        monkeypatch.setattr(cls, name, run)

    for cls in (tlearner.PretrainLearner, tlearner.DownstreamLearner):
        wrap(cls, "train_epoch")
        wrap(cls, "eval_epoch")
    return seen


def _downstream(exp, *more):
    return tds_cli.main(["--ds-train", "--cpu", "--T", "0.144", "--ds-trainmode", "scratchlow",
                         "--epochs", "1", "--lr-set", "1e-3", "--bs-set", "2",
                         "--train-num", "4", "--val-num", "2", "--test-num", "2",
                         "--ds-task", "T60", "--exp-dir", str(exp), *more])


def _jax_arm(trees, kind, seed, num, rooms=None):
    srcs = jsrc.SpeakerTreeDataset(trees["src"], T=0.144, fs=FS)
    if kind == "real":
        return jrr.MicSigFromRIRDataset(jrr.NpyRIRDataset(trees["rirs"], fs=FS, rooms=rooms),
                                        srcs, T=0.144, fs=FS, seed=seed * 7 + 1, length=num)
    return jrr.MicSigFromRIRDataset(jrr.SimRIRDataset(trees["sim_rirs"], fs=FS), srcs, T=0.144,
                                    fs=FS, seed=seed * 7 + 2, length=num,
                                    noise_type="diffuse_white")


def _jax_rir_batches(trees, arms, seed, num, shuffle=True, rooms=None):
    """The JAX CLI's make_batches on its RIR arms: one arm, or the mix."""
    ds = [_jax_arm(trees, k, seed, num, rooms) for k in arms]
    ds = ds[0] if len(ds) == 1 else jds.RandomMixDataset(ds, length=num, seed=seed * 13 + 5,
                                                          probs=[1] * len(ds))
    return list(jds.batch_iterator(ds, 2, shuffle=shuffle, seed=seed))


def _same_batches(got, want, task="T60"):
    assert len(got) == len(want) > 0
    for (w, g), (jw, jl) in zip(got, want):
        assert w.shape == (2, NS, 2)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(g, np.asarray(jl[task], np.float32))


@pytest.mark.parametrize("arms", [("real",), ("sim",), ("real", "sim")],
                         ids=["rir_dir", "sim_rir_dir", "both_1_1"])
def test_downstream_rir_arms_draw_jax_batches(arms, trees, caught, tmp_path):
    flags = ["--src-dir", trees["src"], "--ntrial", "1", "--real-sim-ratio", "1", "1"]
    if "real" in arms:
        flags += ["--rir-dir", trees["rirs"]]
    if "sim" in arms:
        flags += ["--sim-rir-dir", trees["sim_rirs"]]
    assert _downstream(tmp_path, *flags) == 0
    with open(tmp_path / "results.json") as f:
        assert np.isfinite(json.load(f)["best_test_mae"])
    _same_batches(caught["train"][0], _jax_rir_batches(trees, arms, SEED, 4))
    # val and test read the real arm when there is one, in order
    ev = "real" if "real" in arms else "sim"
    _same_batches(caught["eval"][0], _jax_rir_batches(trees, [ev], 1, 2, shuffle=False))
    _same_batches(caught["eval"][1], _jax_rir_batches(trees, [ev], 2, 2, shuffle=False))


def test_downstream_rir_cv_holds_rooms_out(trees, caught, tmp_path, capsys):
    assert _downstream(tmp_path, "--rir-dir", trees["rirs"], "--src-dir", trees["src"],
                       "--rir-cv", "--real-sim-ratio", "1", "0") == 0
    assert "cross-validation over 3 rooms -> 3 trials" in capsys.readouterr().out
    with open(tmp_path / "results.json") as f:
        assert sorted(json.load(f)["cells"]) == [f"trial{t}_bs2_lr0.001" for t in range(3)]
    splits = list(jmetrics.cross_validation_datadirs(list(ROOMS), with_val=True, seed=SEED))
    assert len(caught["train"]) == 3 and len(caught["eval"]) == 9
    for t, split in enumerate(splits):
        assert split["test"] == [ROOMS[t]] and ROOMS[t] not in split["train"] + split["val"]
        _same_batches(caught["train"][t], _jax_rir_batches(trees, ["real"], SEED + 1000 * t, 4,
                                                           rooms=split["train"]))
        val, test, val_final = caught["eval"][3 * t: 3 * t + 3]
        _same_batches(val, _jax_rir_batches(trees, ["real"], 1, 2, False, split["val"]))
        for a, b in zip(val_final, val):
            np.testing.assert_array_equal(a[0], b[0])
        _same_batches(test, _jax_rir_batches(trees, ["real"], 2, 2, False, split["test"]))


def test_downstream_mp_loader_draws_the_threads_batches(trees, caught, tmp_path):
    assert _downstream(tmp_path, "--rir-dir", trees["rirs"], "--sim-rir-dir",
                       trees["sim_rirs"], "--src-dir", trees["src"], "--ntrial", "1",
                       "--mp-loader", "--workers", "2") == 0
    _same_batches(caught["train"][0], _jax_rir_batches(trees, ("real", "sim"), SEED, 4))
    _same_batches(caught["eval"][1], _jax_rir_batches(trees, ["real"], 2, 2, shuffle=False))


@pytest.mark.parametrize("ratio", [("1", "1"), ("1", "0")])
def test_downstream_real_sig_mixture_draws_jax_batches(ratio, trees, caught, tmp_path):
    assert _downstream(tmp_path, "--ds-task", "TDOA", "--real-sig-dir", trees["real_sig"],
                       "--sim-sig-dir", trees["sim_sig"], "--real-sim-ratio", *ratio,
                       "--ntrial", "1") == 0
    tr = [jds.Selecting((0, NS))]
    arms, probs = [], []
    if ratio[1] == "1":
        arms.append(jds.FixMicSigDataset(trees["sim_sig"], load_anno=True, transforms=tr))
        probs.append(1)
    arms.append(jds.FixMicSigDatasetLOCATA(trees["real_sig"] + "/train", load_anno=True,
                                           transforms=tr))
    probs.append(1)
    mix = jds.RandomMixDataset(arms, length=4, seed=SEED * 13 + 5, probs=probs)
    _same_batches(caught["train"][0], list(jds.batch_iterator(mix, 2, shuffle=True, seed=SEED)),
                  "TDOA")
    for split, got in (("val", caught["eval"][0]), ("test", caught["eval"][1])):
        ds = jds.FixMicSigDatasetLOCATA(trees["real_sig"] + "/" + split, load_anno=True,
                                        transforms=tr)
        ds.data_paths = ds.data_paths[:2]
        _same_batches(got, list(jds.batch_iterator(ds, 2, shuffle=False)), "TDOA")


@pytest.mark.parametrize("flags,match", [
    (["--rir-cv", "--data-dir", "d"], "--rir-cv needs --rir-dir"),
    (["--rir-dir", "{rirs}/RoomA", "--src-dir", "{src}", "--rir-cv"], ">= 3 room subdirs"),
    (["--rir-dir", "{rirs}"], "pass it"),
    (["--rir-dir", "{rirs}", "--src-dir", "{src}", "--real-sim-ratio", "0", "1"],
     "excludes every provided RIR arm"),
    (["--real-sig-dir", "{real_sig}"], "pass --sim-sig-dir"),
    (["--real-sig-dir", "{real_sig}", "--real-sim-ratio", "0", "0"], "no training arm"),
    (["--data-dir", "d", "--rir-dir", "{rirs}", "--src-dir", "{src}", "--room-trials",
      "--val-data-dir", "v", "--test-data-dir", "t"], "composes"),
], ids=["cv_without_rirs", "cv_two_rooms", "no_src", "ratio_excludes", "no_sim_sig",
        "ratio_0_0", "room_trials"])
def test_downstream_real_data_refusals(flags, match, trees, tmp_path):
    flags = [f.format(**trees) for f in flags]
    with pytest.raises(ValueError, match=match):
        _downstream(tmp_path / "exp", *flags)
    assert not (tmp_path / "exp" / "results.json").exists()


def test_downstream_refusals_the_jax_cli_asserts(trees, tmp_path):
    """The checks the JAX CLI asserts before it builds its model raise there
    too (``AssertionError``), where the port raises ``ValueError``."""
    from sarssl_tpu.cli import run_downstream as jds_cli
    base = ["--ds-train", "--cpu", "--exp-dir", str(tmp_path)]
    with pytest.raises(AssertionError, match="--rir-cv needs --rir-dir"):
        jds_cli.main(base + ["--rir-cv", "--data-dir", "d"])
    with pytest.raises(AssertionError, match=">= 3 room subdirs"):
        jds_cli.main(base + ["--rir-cv", "--rir-dir", trees["rirs"] + "/RoomA"])
    with pytest.raises(AssertionError, match="composes"):
        jds_cli.main(base + ["--room-trials", "--data-dir", "d", "--rir-dir", trees["rirs"]])


def _pretrain(exp, *more):
    return tpre_cli.main(["--smoke", "--cpu", "--epochs", "1", "--exp-dir", str(exp), *more])


def test_pretrain_real_corpora_draw_jax_items(trees, caught, tmp_path, capsys):
    """One epoch of the smoke model (4 train batches of 4, 2 val batches) on
    AISHELL4 with its TextGrids' single-speaker windows, AMI, and a plain
    4-channel tree, mixed 0.5 / 0.2 / 0.3."""
    assert _pretrain(tmp_path, "--real-corpora", f"AISHELL4={trees['aishell4']}",
                     f"AMI={trees['ami']}", "--real-data-dirs", trees["four"],
                     "--real-data-probs", "0.5", "0.2", "0.3", "--remove-spkoverlap",
                     "--workers", "2") == 0
    assert "SMOKE PASS" in capsys.readouterr().out
    T = NS / 16000
    sets = [jco.AISHELL4Reader(trees["aishell4"], T=T, fs=FS, stage="train", seed=SEED,
                               remove_spkoverlap=True),
            jco.AMIReader(trees["ami"], T=T, fs=FS, stage="train", seed=SEED),
            jreal.RealMicSigDataset(trees["four"], jreal.CorpusSpec("four"), T=T, fs=FS,
                                    seed=SEED)]
    assert all(it.window is not None for it in sets[0].items)
    mix = jreal.RandomRealDataset(sets, probs=[0.5, 0.2, 0.3], seed=SEED)
    for got, base, nb in ((caught["train"][0], (SEED, 0, 0, 0), 4),
                          (caught["eval"][0], (SEED, 1, 0), 2)):
        want = np.stack([mix.sample(np.random.default_rng(base + (i,))) for i in range(4 * nb)])
        assert len(got) == nb
        np.testing.assert_array_equal(np.concatenate(got), want)


def test_pretrain_real_data_dirs_alone_and_refusals(trees, caught, tmp_path):
    assert _pretrain(tmp_path, "--real-data-dirs", trees["four"]) == 0
    mix = jreal.RandomRealDataset([jreal.RealMicSigDataset(
        trees["four"], jreal.CorpusSpec("four"), T=NS / 16000, fs=FS, seed=SEED)], seed=SEED)
    want = np.stack([mix.sample(np.random.default_rng((SEED, 0, 0, 0, i))) for i in range(16)])
    np.testing.assert_array_equal(np.concatenate(caught["train"][0]), want)
    for flags, match in ((["--real-corpora", "AMI"], "NAME=DIR"),
                         (["--real-corpora", "Nope=d"], "NAME=DIR"),
                         (["--real-data-dirs", "d", "--real-data-probs", "1", "2"], "2 values"),
                         (["--real-data-dirs", "d", "--data-dir", "d", "--resident"],
                          "--resident")):
        with pytest.raises(ValueError, match=match):
            tpre_cli.main(["--pretrain", "--cpu", "--exp-dir", str(tmp_path / "x"), *flags])
    assert not (tmp_path / "x").exists()
