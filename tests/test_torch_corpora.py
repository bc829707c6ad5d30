"""The port's real-recording readers for pre-training and LOCATA
(``sarssl_torch/data/textgrid.py``, ``data/real.py``, ``data/corpora.py``,
``data/locata.py``, ``cli/gen_locata.py``) against the JAX package's on
synthetic trees in each corpus's layout.

The item tables, their weights and every crop drawn from the same seeds are
held bit for bit (``array_equal``): both packages probe the same headers,
draw from the same numpy generators in the same order and resample with the
same scipy call."""
from pathlib import Path

import numpy as np
import pytest

from sarssl_torch.cli import gen_locata as t_gen_locata
from sarssl_torch.data import corpora as tco
from sarssl_torch.data import locata as tloc
from sarssl_torch.data import real as treal
from sarssl_torch.data import textgrid as ttg
from sarssl_torch.data.wavio import write_wav
from sarssl_tpu.cli import gen_locata as j_gen_locata
from sarssl_tpu.data import corpora as jco
from sarssl_tpu.data import locata as jloc
from sarssl_tpu.data import real as jreal
from sarssl_tpu.data import textgrid as jtg

FS = 16000
T = 0.5

TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 12
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "SPK01"
        xmin = 0
        xmax = 12
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 0.4
            text = "hello"
        intervals [2]:
            xmin = 0.4
            xmax = 6
            text = ""
        intervals [3]:
            xmin = 6
            xmax = 6.5
            text = "again"
    item [2]:
        class = "IntervalTier"
        name = "SPK02"
        xmin = 0
        xmax = 12
        intervals: size = 3
        intervals [1]:
            xmin = 0.2
            xmax = 1.1
            text = "over"
        intervals [2]:
            xmin = 1.1
            xmax = 8
            text = ""
        intervals [3]:
            xmin = 8
            xmax = 9.5
            text = "reply"
"""

SHORT_TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"

0
10
<exists>
2
"IntervalTier"
"a"
0
10
3
0
2
"x"
2
5
""
5
8
"y"
"IntervalTier"
"b"
0
10
2
0
1
""
1
3
"z"
"""


def _wav(rng, path, seconds, nch, fs=FS):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(str(path), (rng.standard_normal((int(seconds * fs), nch)) * 0.1
                          ).astype(np.float32), fs)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A tree per reader, each in its corpus's layout, with train and val
    parts where the corpus has them."""
    root, rng = tmp_path_factory.mktemp("corpora"), np.random.default_rng(0)
    d = {}
    r = root / "realman"
    for scene, sec in (("LivingRoom1", 1.2), ("LivingRoom2", 0.9)):
        for k in range(32):
            _wav(rng, r / "ma_speech" / scene / "static" / "spk1" / f"utt1.CH{k}.wav", sec, 1)
    d["RealMAN"] = r
    r = root / "locata_reader"
    _wav(rng, r / "eval" / "task1" / "recording1" / "dicit" / "audio_array_dicit.wav", 1.0, 15,
         fs=48000)
    _wav(rng, r / "dev" / "task1" / "recording2" / "benchmark2" /
         "audio_array_benchmark2.wav", 0.8, 12)
    d["LOCATA"] = r
    r = root / "mcwsj"
    for k in range(1, 9):
        _wav(rng, r / "MC_WSJ_AV_Dev" / "audio" / "stat" / "T7" / "array1" / "adap" /
             f"spk_u1-{k}_T.wav", 0.9, 1)
    d["MCWSJ"] = r
    r = root / "libricss"
    for s in range(3):
        _wav(rng, r / "exp" / "data" / "7ch" / "utterances" /
             f"overlap_ratio_0.0_sil0.1_1.0_session{s}_actual0.0" / "segment_0.wav",
             0.6 + 0.2 * s, 7)
    d["LibriCSS"] = r
    r = root / "ami"
    for session in ("ES2002", "IS1000", "XX9999"):
        for k in range(1, 9):
            _wav(rng, r / "ScenarioMeetings" / session / "audio" /
                 f"{session}a.Array1-0{k}.wav", 0.7, 1)
    d["AMI"] = r
    r = root / "aishell4"
    for ds, room in (("train_M", "M_R001"), ("test", "M_R003"), ("test", "S_R003")):
        name = f"20200707_{room}S01C01"
        _wav(rng, r / ds / "wav" / f"{name}.wav", 12, 8)
        (r / ds / "TextGrid").mkdir(parents=True, exist_ok=True)
        (r / ds / "TextGrid" / f"{name}.TextGrid").write_text(TEXTGRID)
    d["AISHELL4"] = r
    r = root / "m2met"
    for ds, room in (("Train_Ali/Train_Ali_far", "R0003"), ("Test_Ali/Test_Ali_far", "R8002")):
        _wav(rng, r / ds / "audio_dir" / f"{room}_M8001_MS801.wav", 12, 8)
        (r / ds / "textgrid_dir").mkdir(parents=True)
        (r / ds / "textgrid_dir" / f"{room}_M8001.TextGrid").write_text(TEXTGRID)
    d["M2MeT"] = r
    r = root / "chime3"
    for ds in ("tr05_bus_real", "dt05_bth"):
        for k in range(6):
            _wav(rng, r / "data" / "audio" / "16kHz" / "isolated" / ds /
                 f"F01_22GC010X_BTH.CH{k}.wav", 0.8, 1)
    d["CHiME3"] = r
    return {k: str(v) for k, v in d.items()}


def _items(reader):
    return [(it.paths, it.mic_idxes, it.duration, it.fs, it.frames, it.window)
            for it in reader.items]


def _same_reader(t, j, draws=4):
    assert _items(t) == _items(j) and t.items
    np.testing.assert_array_equal(t._cum, j._cum)
    assert len(t) == len(j)
    for _ in range(2):  # the instance generators, drawn in turn
        np.testing.assert_array_equal(t.sample(), j.sample())
    for i in range(draws):
        np.testing.assert_array_equal(t[i], j[i])
        a = t.sample(np.random.default_rng((3, i)))
        np.testing.assert_array_equal(a, j.sample(np.random.default_rng((3, i))))
        assert a.shape == (int(t.T * t.fs), 2) and a.dtype == np.float32


CASES = [("RealMAN", "train", {}), ("RealMAN", "val", {}), ("LOCATA", "train", {}),
         ("LOCATA", "test", {"arrays": ("benchmark2",)}), ("MCWSJ", "train", {}),
         ("LibriCSS", "train", {}), ("AMI", "train", {}),
         ("AISHELL4", "train", {}), ("AISHELL4", "val", {"remove_spkoverlap": True}),
         ("AISHELL4", "train", {"remove_spkoverlap": True, "prob_mode": ("duration",)}),
         ("M2MeT", "train", {"remove_spkoverlap": True}), ("M2MeT", "val", {}),
         ("CHiME3", "train", {}), ("CHiME3", "val", {"prob_mode": ()})]


@pytest.mark.parametrize("name,stage,kw", CASES,
                         ids=[f"{n}-{s}-{i}" for i, (n, s, _) in enumerate(CASES)])
def test_reader_items_and_crops_equal_jax(corpora, name, stage, kw):
    t = tco.REAL_CORPORA[name](corpora[name], T=T, fs=FS, stage=stage, seed=5, **kw)
    j = jco.REAL_CORPORA[name](corpora[name], T=T, fs=FS, stage=stage, seed=5, **kw)
    _same_reader(t, j)
    if kw.get("remove_spkoverlap"):
        assert all(it.window is not None for it in t.items)


def test_reader_geometry_pairs_and_splits_equal_jax(corpora):
    np.testing.assert_array_equal(tco.realman_high_resolution_array(),
                                  jco.realman_high_resolution_array())
    for geo in ("MCWSJ_ARRAY", "LIBRICSS_ARRAY", "AISHELL4_ARRAY", "M2MET_ARRAY",
                "CHIME3_ARRAY"):
        np.testing.assert_array_equal(getattr(tco, geo), getattr(jco, geo))
        assert tco.select_pairs(getattr(tco, geo)) == jco.select_pairs(getattr(jco, geo))
    for a in tco.LOCATA_ARRAYS:
        np.testing.assert_array_equal(tco.LOCATA_ARRAYS[a], jco.LOCATA_ARRAYS[a])
    np.testing.assert_array_equal(tco.circular_array(0.05, 6, center=True),
                                  jco.circular_array(0.05, 6, center=True))
    assert sorted(tco.REAL_CORPORA) == sorted(jco.REAL_CORPORA)
    for name in tco.REAL_CORPORA:
        for attr in ("SCENES", "SPLITS", "ROOMS"):
            assert getattr(tco.REAL_CORPORA[name], attr, None) == \
                getattr(jco.REAL_CORPORA[name], attr, None)
    # a stage with nothing in the tree raises in both
    for pkg in (tco, jco):
        with pytest.raises(AssertionError, match="no usable items"):
            pkg.REAL_CORPORA["AMI"](corpora["AMI"], T=T, stage="val")


@pytest.mark.parametrize("text", [TEXTGRID, SHORT_TEXTGRID], ids=["long", "short"])
def test_textgrid_parsing_and_overlap_equal_jax(text, tmp_path):
    path = tmp_path / "a.TextGrid"
    path.write_text(text)
    for src in (text, str(path)):
        tt, jt = ttg.parse_textgrid(src), jtg.parse_textgrid(src)
        assert {k: [(i.xmin, i.xmax, i.text) for i in v] for k, v in tt.items()} == \
            {k: [(i.xmin, i.xmax, i.text) for i in v] for k, v in jt.items()}
        assert len(tt) == 2
    assert ttg.speech_segments(tt) == jtg.speech_segments(jt)
    assert ttg.speech_intervals(tt) == jtg.speech_intervals(jt)
    for min_dur in (0.0, 0.5, 2.0):
        assert ttg.non_overlapped_regions(tt, min_dur) == jtg.non_overlapped_regions(jt, min_dur)
        for dur in (5.0, 40.0):
            ivals = ttg.speech_intervals(tt)
            assert ttg.single_speaker_windows(ivals, min_dur, dur) == \
                jtg.single_speaker_windows(ivals, min_dur, dur)
    assert ttg.non_overlapped_regions(ttg.parse_textgrid(TEXTGRID)) == [
        (0.0, 0.2), (0.4, 1.1), (6.0, 6.5), (8.0, 9.5)]


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """Plain multichannel wav trees: a 4-channel one (locata_dummy geometry),
    one at 8 kHz, and a channel-per-file one."""
    root, rng = tmp_path_factory.mktemp("plain"), np.random.default_rng(1)
    for i in range(3):
        _wav(rng, root / "four" / f"rec{i}.wav", 0.6 + 0.3 * i, 4)
    _wav(rng, root / "four" / "short.wav", 0.3, 4)  # shorter than T: left out
    _wav(rng, root / "low" / "a.wav", 1.0, 3, fs=8000)
    for ch in range(3):
        _wav(rng, root / "perfile" / "m1" / f"headset{ch}.wav", 0.9, 1)
    return root


@pytest.mark.parametrize("tree,spec", [
    ("four", dict(geometry="locata_dummy")), ("four", {}),
    ("four", dict(geometry="locata_dummy", exclude=("rec1",))),
    ("low", {}), ("perfile", dict(channel_per_file=True))])
def test_real_micsig_dataset_equals_jax(plain, tree, spec):
    def make(pkg):
        s = dict(spec)
        if "geometry" in s:
            s["geometry"] = pkg.ARRAY_GEOMETRIES[s["geometry"]]
        return pkg.RealMicSigDataset(str(plain / tree), pkg.CorpusSpec(tree, **s), T=T, fs=FS,
                                     seed=4)
    t, j = make(treal), make(jreal)
    assert t.items == j.items and len(t) == len(j)
    np.testing.assert_array_equal(t.probs, j.probs)
    for i in range(5):
        np.testing.assert_array_equal(t[i], j[i])
        np.testing.assert_array_equal(t.sample(np.random.default_rng(i)),
                                      j.sample(np.random.default_rng(i)))
    np.testing.assert_array_equal(t[None], j[None])


def test_random_real_mixture_equals_jax(plain, corpora):
    def make(pkg, co):
        sets = [co.REAL_CORPORA["AISHELL4"](corpora["AISHELL4"], T=T, fs=FS, seed=2,
                                            remove_spkoverlap=True),
                pkg.RealMicSigDataset(str(plain / "four"), pkg.CorpusSpec("four"), T=T, fs=FS,
                                      seed=2)]
        return pkg.RandomRealDataset(sets, probs=[0.3, 0.7], dataset_sz=6, seed=2)
    t, j = make(treal, tco), make(jreal, jco)
    np.testing.assert_array_equal(t.probs, j.probs)
    for i in range(6):
        np.testing.assert_array_equal(t[i], j[i])
        base = (100, 0, 1, 0, i)  # run_pretrain's per-item seed
        np.testing.assert_array_equal(t.sample(np.random.default_rng(base)),
                                      j.sample(np.random.default_rng(base)))
    np.testing.assert_array_equal(t[None], j[None])
    with pytest.raises(ValueError, match="no mic pairs"):
        treal.select_mic_pairs(np.array([[0, 0, 0], [1.0, 0, 0]]))
    assert treal.select_mic_pairs(treal.ARRAY_GEOMETRIES["locata_dicit"]) is not None


# ------------------------------------------------------------------ LOCATA

LOCATA_FS = 48000


def _make_locata(root: Path, rng, subset, task, array, nch, src, dur_s=3.0, rec=1):
    adir = root / subset / f"task{task}" / f"recording{rec}" / array
    adir.mkdir(parents=True)
    sig = rng.standard_normal((int(dur_s * LOCATA_FS), nch)).astype(np.float32) * 0.1
    sig[: LOCATA_FS // 2] *= 0.001  # 0.5 s of silence first
    write_wav(str(adir / f"audio_array_{array}.wav"), sig, LOCATA_FS)
    npt = 30
    t = np.linspace(0, dur_s, npt)

    def tsv(name, cols):
        with open(adir / name, "w") as f:
            f.write("\t".join(cols) + "\n")
            for i in range(npt):
                f.write("\t".join(f"{v:.6f}" if isinstance(v, np.floating) else str(v)
                                   for v in (cols[c][i] for c in cols)) + "\n")
    tsv("required_time.txt", {"year": np.full(npt, 2017), "hour": np.zeros(npt, int),
                              "minute": np.zeros(npt, int), "second": t})
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    cols = {"x": 1.0 + 0.1 * t * (task == 5), "y": np.full(npt, 1.2), "z": np.full(npt, 1.0)}
    for i in range(3):
        for j in range(3):
            cols[f"rotation_{i + 1}{j + 1}"] = np.full(npt, rot[i, j])
    tsv(f"position_array_{array}.txt", cols)
    tsv("position_source_talker1.txt", {"x": src[0] + 0.2 * np.sin(t), "y": np.full(npt, src[1]),
                                        "z": np.full(npt, src[2])})


@pytest.fixture(scope="module")
def locata(tmp_path_factory):
    root, rng = tmp_path_factory.mktemp("locata"), np.random.default_rng(2)
    _make_locata(root, rng, "eval", 1, "dicit", 15, (3.0, 4.0, 1.5))
    _make_locata(root, rng, "eval", 5, "benchmark2", 12, (2.0, -1.0, 1.2))
    _make_locata(root, rng, "dev", 3, "dicit", 15, (-2.0, 3.0, 1.0), rec=2)
    return str(root)


@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_locata_dataset_items_and_tdoa_equal_jax(locata, stage):
    t = tloc.LOCATADataset(locata, T=1.04, fs=FS, stage=stage, seed=3)
    j = jloc.LOCATADataset(locata, T=1.04, fs=FS, stage=stage, seed=3)
    assert [it[:4] + (it[5],) for it in t.items] == [it[:4] + (it[5],) for it in j.items]
    for a, b in zip(t.items, j.items):
        np.testing.assert_array_equal(a[4], b[4])
    for i in list(range(4)) + [None, None]:
        (sa, aa), (sb, ab) = t[i], j[i]
        np.testing.assert_array_equal(sa, sb)
        assert sa.shape == (int(1.04 * FS), 2)
        assert aa == ab and np.isfinite(aa["TDOA"]) and abs(aa["TDOA"]) <= 0.2 / 343 + 1e-6
    sig = np.zeros((LOCATA_FS * 2, 2), np.float32)
    sig[LOCATA_FS:] = 1.0
    assert tloc.silence_onset(sig, LOCATA_FS) == jloc.silence_onset(sig, LOCATA_FS) == 1.0
    assert tloc.SPLIT_SUBSETS == jloc.SPLIT_SUBSETS and tloc.SPLIT_RATIO == jloc.SPLIT_RATIO


def test_locata_without_anno_and_missing_stage(locata, tmp_path):
    t = tloc.LOCATADataset(locata, stage="val", load_anno=False, arrays=("benchmark2",))
    j = jloc.LOCATADataset(locata, stage="val", load_anno=False, arrays=("benchmark2",))
    np.testing.assert_array_equal(t[2], j[2])
    with pytest.raises(AssertionError, match="no LOCATA items"):
        tloc.LOCATADataset(str(tmp_path), stage="test")


@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_gen_locata_tree_equals_jax(locata, tmp_path, stage):
    for name, mod in (("torch", t_gen_locata), ("jax", j_gen_locata)):
        assert mod.main(["--data-dir", locata, "--save-dir", str(tmp_path / name), "--stage",
                         stage, "--num", "5", "--seed", "1"]) == 0
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 10
    for n in names:
        if n.endswith(".wav"):
            assert (tmp_path / "torch" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
        else:
            a, b = np.load(tmp_path / "torch" / n), np.load(tmp_path / "jax" / n)
            assert a.files == b.files == ["TDOA"] and a["TDOA"] == b["TDOA"]
