"""The port's real-RIR extractors and generation CLIs
(``sarssl_torch/data/extractors.py``, ``data/tables.py``,
``cli/gen_real_rir.py``, ``cli/gen_sig_from_real_rir.py``) against the JAX
package's on synthetic trees in each corpus's on-disk layout.

Each extractor writes its tree from the same corpus tree in both packages;
the trees are held file for file: the same names, ``.npy`` and ``.wav`` files
byte for byte, ``_info.npz`` bundles key for key with equal arrays. The
tables the JAX package reads with pandas are held against pandas' reading."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from sarssl_torch.cli import gen_real_rir as t_gen_rir
from sarssl_torch.cli import gen_sig_from_real_rir as t_gen_sig
from sarssl_torch.data import extractors as tex
from sarssl_torch.data import real_rir as trr
from sarssl_torch.data.sources import SpeakerTreeDataset
from sarssl_torch.data.tables import read_table
from sarssl_torch.data.wavio import read_wav, write_wav
from sarssl_tpu.cli import gen_real_rir as j_gen_rir
from sarssl_tpu.cli import gen_sig_from_real_rir as j_gen_sig
from sarssl_tpu.data import extractors as jex
from sarssl_tpu.data import locata as jlocata

FS = 16000


def _decaying_rir(rng, n, nmic, peak_at=100, fs=16000):
    rir = rng.standard_normal((n, nmic)) * 0.01
    rir *= np.exp(-np.arange(n) / (0.1 * fs))[:, None]
    for m in range(nmic):
        rir[peak_at + m, m] = 1.0
    return rir


def _cell(v):
    """A table cell at the corpora's precision: floats to 6 decimals."""
    return f"{v:.6f}" if isinstance(v, (float, np.floating)) else str(v)


def _same_tree(a, b):
    """Two trees hold the same files with the same contents."""
    fa = sorted(str(p.relative_to(a)) for p in Path(a).rglob("*") if p.is_file())
    fb = sorted(str(p.relative_to(b)) for p in Path(b).rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        pa, pb = Path(a) / rel, Path(b) / rel
        if rel.endswith(".npz"):  # a zip: its members, not its timestamps
            za, zb = np.load(pa, allow_pickle=True), np.load(pb, allow_pickle=True)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel
    return fa


def _extract_both(name, src, tmp, **kw):
    out_t, out_j = tmp / "out_torch", tmp / "out_jax"
    ct = tex.EXTRACTORS[name](str(src), **kw).extract(str(out_t))
    cj = jex.EXTRACTORS[name](str(src), **kw).extract(str(out_j))
    assert ct == cj
    return ct, _same_tree(out_t, out_j), out_t


# ---------------------------------------------------------------------- ACE

ACE_ROOMS = ("Office_1", "Office_2", "Meeting_Room_1")


def _make_ace_tree(root: Path, rng, rooms=ACE_ROOMS, arrays=("Lin8Ch", "Chromebook")):
    rows = ["Mic config:, Room decode:, Room config:, Chan:, FB T60:, FB DRR:"]
    nmic = {"Lin8Ch": 8, "Chromebook": 2, "Mobile": 3}
    for r, room in enumerate(rooms):
        for array in arrays:
            for pos in ("1", "2"):
                d = root / "RIRN" / array / room / pos
                d.mkdir(parents=True)
                n = nmic[array]
                write_wav(str(d / f"{room}_{pos}_RIR.wav"),
                          _decaying_rir(rng, 4000, n, peak_at=90 + r).astype(np.float32), 16000)
                write_wav(str(d / f"{room}_{pos}_Noise_Ambient.wav"),
                          (rng.standard_normal((8000, n)) * 0.01).astype(np.float32), 16000)
                write_wav(str(d / f"{room}_{pos}_Noise_Fan.wav"),
                          (rng.standard_normal((6000, n - 1 if n > 2 else n)) * 0.01
                           ).astype(np.float32), 16000)
                for ch in range(1, n + 1):
                    rows.append(f"{array}, {room}, {pos}, {ch}, {0.3 + 0.1 * r + 0.01 * ch:.2f}, "
                                f"{-2.5 + ch:.1f}")
    data = root / "Data"
    data.mkdir(parents=True)
    (data / jex.ACEExtractor.ANNO_CSV).write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def ace(tmp_path_factory):
    return _make_ace_tree(tmp_path_factory.mktemp("ace"), np.random.default_rng(1))


def test_ace_tree_equals_jax(ace, tmp_path):
    counts, files, out = _extract_both("ACE", ace, tmp_path)
    assert counts["rir"] > 0 and counts["noise"] > 0
    assert "Office_1/Lin8Ch/SP1_MP1-1-4.npy" in files
    assert "Office_1/Lin8Ch/SP1_MP1-1-5.npy" not in files  # 0.24 m apart
    info = np.load(out / "Office_1" / "Lin8Ch" / "SP1_MP2-1-2_info.npz")
    assert {"T60fromDataset", "DRRfromDataset", "DRR", "C50", "ABS", "fs"} <= set(info.files)
    # the channel-mismatched Fan noise falls back to zeros, as in the JAX package
    assert (out / "Office_1" / "Lin8Ch" / "_MP1-1-2_Fan.wav").exists()


def test_ace_csv_reads_as_pandas_reads_it(ace):
    pd = pytest.importorskip("pandas")
    path = ace / "Data" / jex.ACEExtractor.ANNO_CSV
    table = read_table(str(path), sep=", ")
    df = pd.read_csv(path, sep=", ", engine="python")
    assert list(table) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy()
        assert table[c].dtype.kind == ("O" if want.dtype.kind in "OUT" else want.dtype.kind), c
        assert list(table[c]) == list(want), c
    got, want = tex.ACEExtractor(str(ace))._load_annos(), jex.ACEExtractor(str(ace))._load_annos()
    assert sorted(got) == sorted(want) and len(got) == 2 * 2 * len(ACE_ROOMS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_tables_type_columns_as_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    rows = ["a\tb\tc\td\te", "1\t2.5\tx\t\t-3", "2\tnan\ty\t4\t7", "30\t1e-3\tNA\t5\t+8"]
    path = tmp_path / "t.tsv"
    path.write_text("\n".join(rows) + "\n\n")
    table, df = read_table(str(path), "\t"), pd.read_csv(path, sep="\t")
    assert list(table) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy()
        if want.dtype.kind == "f":
            assert table[c].dtype == np.float64
            np.testing.assert_array_equal(table[c], want)
        elif want.dtype.kind == "i":
            assert table[c].dtype == np.int64
            np.testing.assert_array_equal(table[c], want)
        else:  # strings, a missing cell as NaN
            assert [x if isinstance(x, str) else "nan" for x in table[c]] == \
                [x if isinstance(x, str) else "nan" for x in want]
    (tmp_path / "bad.tsv").write_text("a\tb\n1\n")
    with pytest.raises(ValueError, match="cells"):
        read_table(str(tmp_path / "bad.tsv"), "\t")


@pytest.mark.parametrize("engine", ["c", "python"])
def test_numbers_read_as_pandas_reads_them(engine, tmp_path):
    """Cells at the corpora's precision (at most 15 significant digits, a
    decimal exponent within +-22) read to the same double as pandas reads
    them, bit for bit."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(11)
    cells = []
    for k in rng.integers(0, 4, 3000):
        cells.append(
            f"{rng.uniform(-1e3, 1e3):.{rng.integers(0, 12)}f}" if k == 0
            else f"{rng.uniform(-10, 10):.{rng.integers(0, 7)}f}e{rng.integers(-15, 16)}" if k == 1
            else f"{rng.integers(0, 10 ** 6)}.{rng.integers(0, 10 ** 6):06d}" if k == 2
            else f"{0.3 + 0.1 * rng.integers(5) + 0.01 * rng.integers(9):.2f}")
    sep = "\t" if engine == "c" else ", "
    path = tmp_path / "n.txt"
    path.write_text(sep.join(["a", "b"]) + "\n" + "".join(f"{c}{sep}1\n" for c in cells))
    want = pd.read_csv(path, sep=sep, engine=engine)["a"].to_numpy()
    got = read_table(str(path), sep)["a"]
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_locata_tsv_reads_as_pandas_reads_it(tmp_path):
    pytest.importorskip("pandas")
    npt, rng = 12, np.random.default_rng(2)
    cols = {"year": np.full(npt, 2017), "hour": np.zeros(npt, int), "second":
            np.linspace(0, 5, npt), "x": rng.uniform(0, 5, npt), "rotation_11": np.ones(npt)}
    path = tmp_path / "position_array_dicit.txt"
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for i in range(npt):
            f.write("\t".join(_cell(cols[c][i]) for c in cols) + "\n")
    from sarssl_torch.data import locata as tlocata
    got, want = tlocata._read_tsv(str(path)), jlocata._read_tsv(str(path))
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c])


def test_find_dp_and_window_metrics_equal_jax():
    rng = np.random.default_rng(3)
    rir = np.zeros(1000)
    rir[100], rir[300], rir[50] = 0.8, 1.0, 0.2
    assert tex.find_dp_index(rir) == jex.find_dp_index(rir) == 100
    assert tex.find_dp_index(-np.ones(10)) is None
    for _ in range(4):
        pair = _decaying_rir(rng, 3000, 2, peak_at=int(rng.integers(20, 80))).T
        assert tex.dp_window_metrics(pair, FS) == jex.dp_window_metrics(pair, FS)
        pos = rng.uniform(-0.2, 0.2, (2, 3))
        assert tex.pair_in_range(pos, (0.03, 0.2)) == jex.pair_in_range(pos, (0.03, 0.2))
    sph = rng.uniform(0, 3, (5, 3))
    np.testing.assert_array_equal(tex.sph2cart(sph), jex.sph2cart(sph))


def test_strip_noise_silence_equals_jax():
    fs, rng = 1000, np.random.default_rng(4)
    n = np.zeros((10 * fs, 2))
    n[2 * fs:8 * fs] = rng.standard_normal((6 * fs, 2))
    np.testing.assert_array_equal(tex.strip_noise_silence(n, fs), jex.strip_noise_silence(n, fs))
    with pytest.raises(ValueError):
        tex.strip_noise_silence(np.zeros((10 * fs, 2)) + 1e-12, fs)


# ---------------------------------------------------------------- BUTReverb

def _make_but_tree(root: Path, rng):
    mic_xyz = [(0.0, 0.0, 1.0), (0.05, 0.0, 1.0), (0.10, 0.0, 1.0), (0.40, 0.0, 1.0)]
    for room in ("VUT_FIT_L207", "VUT_FIT_E112"):
        for spk in ("SpkID01_20170901_S", "SpkID02_20170901_S"):
            for i, (x, y, z) in enumerate(mic_xyz, start=1):
                d = root / "RIRs" / room / "MicID01" / spk / f"{i:02d}"
                (d / "RIR").mkdir(parents=True)
                (d / "silence").mkdir()
                meta = [f"$EnvMicID {i}", f"$EnvMic{i}TypeID 01-{i}",
                        f"$EnvMic{i}RelRT60 {0.5 + 0.05 * i}", f"$EnvMic{i}Depth {x}",
                        f"$EnvMic{i}Width {y}", f"$EnvMic{i}Height {z}",
                        "$EnvSpk1Depth 2.0", "$EnvSpk1Width 1.5", "$EnvSpk1Height 1.2",
                        "$EnvDepth 4.0", "$EnvWidth 6.0", "$EnvHeight 2.6"]
                (d / "mic_meta.txt").write_text("\n".join(meta) + "\n")
                write_wav(str(d / "RIR" / "ir.wav"),
                          _decaying_rir(rng, 3000, 1).astype(np.float32), 16000)
                for k in (1, 2):
                    write_wav(str(d / "silence" / f"n{k}.wav"),
                              (rng.standard_normal((4000, 1)) * 0.01).astype(np.float32), 16000)
    return root


def test_butreverb_tree_equals_jax(tmp_path):
    src = _make_but_tree(tmp_path / "but", np.random.default_rng(5))
    counts, files, _ = _extract_both("BUTReverb", src, tmp_path)
    assert counts == {"rir": 12, "noise": 12}
    assert "VUT_FIT_E112/spherical/SPSpkID02_MP-2-3_silence.wav" in files


# ------------------------------------------------------------------ MeshRIR

def test_meshrir_tree_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    sess = tmp_path / "mesh" / "S32-M441_npy"
    sess.mkdir(parents=True)
    np.save(sess / "pos_mic.npy", np.stack([np.arange(3) * 0.08, np.zeros(3), np.zeros(3)], 1))
    np.save(sess / "pos_src.npy", np.array([[1.0, 1.0, 1.0], [2.0, 1.0, 1.0]]))
    for m in range(3):
        np.save(sess / f"ir_{m}.npy", rng.standard_normal((2, 4800)).astype(np.float32) * 0.1)
    (sess / "data.json").write_text(json.dumps({"samplerate": 48000}))
    counts, files, _ = _extract_both("MeshRIR", tmp_path / "mesh", tmp_path)
    assert counts["rir"] == 6 and "R1/A1/SP2_MP-1-3_info.npz" in files


# ---------------------------------------------------------------- dEchorate

def _make_dechorate_tree(root: Path, rng):
    h5py = pytest.importorskip("h5py")
    mics = np.zeros((3, 30))
    for a in range(6):
        for m in range(5):
            mics[0, a * 5 + m] = a * 1.0 + m * 0.04
    root.mkdir(parents=True)
    with h5py.File(root / "dEchorate_annotations.h5", "w") as f:
        f["room_size"] = np.array([5.7, 5.9, 2.3])
        f["microphones"] = mics
        f["sources_directional_position"] = np.zeros((3, 6))
        f["sources_omnidirection_position"] = np.arange(9.0).reshape(3, 3)
    with h5py.File(root / "dEchorate_rir.h5", "w") as f:
        f.attrs["sampling_rate"] = 48000
        g = f.create_group("rir").create_group("011000")
        for s in range(9):
            g[f"0{s}"] = _decaying_rir(rng, 4800, 31, fs=48000)
    with h5py.File(root / "dEchorate_silence_gzip7.hdf5", "w") as f:
        f.attrs["sampling_rate"] = 48000
        f.create_group("silence").create_group("011000")["00"] = \
            rng.standard_normal((48000 * 4, 31)) * 0.01
    with h5py.File(root / "dEchorate_noise_gzip7.hdf5", "w") as f:
        f.attrs["sampling_rate"] = 48000
        sig = np.zeros((48000 * 10, 31))
        sig[48000 * 2:48000 * 8] = rng.standard_normal((48000 * 6, 31))
        f.create_group("noise").create_group("011000")["00"] = sig
    return root


def test_dechorate_tree_equals_jax(tmp_path):
    src = _make_dechorate_tree(tmp_path / "dech", np.random.default_rng(7))
    counts, files, _ = _extract_both("dEchorate", src, tmp_path)
    assert counts["rir"] == 6 * 3 * 10
    assert "011000/A2/_MP-1-2_sil_1.wav" in files and "011000/A6/_MP-4-5_noisrc_1.wav" in files


def test_v73_mat_without_h5py_names_h5py_and_the_file(tmp_path, monkeypatch):
    """A v7.3 .mat (HDF5) is read through h5py; without it the read raises an
    ImportError that names h5py and the file, and nothing is skipped."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "rirs.mat"
    with h5py.File(path, "w", userblock_size=512) as f:
        f["x"] = np.arange(6.0).reshape(2, 3)
    with open(path, "r+b") as f:  # MATLAB's v7.3 header in the user block
        f.write(b"MATLAB 7.3 MAT-file".ljust(116) + bytes(8) + b"\x00\x02IM")
    np.testing.assert_array_equal(tex.load_mat_any(str(path))["x"],
                                  jex.load_mat_any(str(path))["x"])
    real = tex.importlib.import_module

    def no_h5py(name, *a):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a)
    monkeypatch.setattr(tex.importlib, "import_module", no_h5py)
    with pytest.raises(ImportError) as e:
        tex.load_mat_any(str(path))
    assert "h5py" in str(e.value) and str(path) in str(e.value)


# -------------------------------------------------------------------- DCASE

DCASE_ROOMS = ("bomb_shelter", "gym", "tb103")


def _make_dcase_tree(root: Path, rng, rooms=DCASE_ROOMS):
    base = root / "TAU-SRIR_DB"
    base.mkdir(parents=True)
    ntraj, nhei, npoint, nmic, nsamp = 2, 1, 2, 4, 2400
    azel = np.array([[45.0, 35.0], [-45.0, 145.0], [135.0, 145.0], [-135.0, 35.0]])
    traj_cell = np.empty((ntraj, 1), object)
    for t in range(ntraj):
        hei_cell = np.empty((nhei, 1), object)
        for h in range(nhei):
            hei_cell[h, 0] = np.stack([np.linspace(0, np.pi / 2, npoint),
                                       np.full(npoint, np.pi / 3), np.full(npoint, 1.5)], 1)
        traj_cell[t, 0] = hei_cell
    room = np.zeros((1,), dtype=[("name", object), ("nrirs", object), ("rirs", object)])
    room[0]["name"], room[0]["nrirs"], room[0]["rirs"] = "r", np.full((ntraj, nhei), npoint), \
        traj_cell
    rooms_cell = np.empty((1, 10), object)
    for i in range(10):
        rooms_cell[0, i] = room
    scipy.io.savemat(base / "rirdata.mat", {"rirdata": {
        "room": rooms_cell, "fs": 24000.0, "tetra_mic_radius_m": 0.042,
        "tetra_mic_azel_deg": azel}})
    dims, poss = np.empty((1, 10), object), np.empty((1, 10), object)
    for i in range(10):
        dims[0, i] = np.array([10.0 + i, 8.0, 3.0])
        poss[0, i] = np.array([5.0, 4.0 + 0.1 * i, 1.5])
    scipy.io.savemat(base / "measinfo.mat", {"measinfo": {"dimensions": dims,
                                                          "micPosition": poss}})
    for name in rooms:
        rank = f"{jex.DCASEExtractor.ROOMS_ALL.index(name) + 1:02d}"
        mic_cell = np.empty((ntraj, 1), object)
        for t in range(ntraj):
            hei_cell = np.empty((nhei, 1), object)
            for h in range(nhei):
                hei_cell[h, 0] = rng.standard_normal((nsamp, nmic, npoint)).astype(
                    np.float32) * 0.05
            mic_cell[t, 0] = hei_cell
        scipy.io.savemat(base / f"rirs_{rank}_{name}.mat", {"rirs": {"mic": mic_cell}})
        noise_dir = root / "TAU-SNoise_DB" / f"{rank}_{name}"
        noise_dir.mkdir(parents=True)
        write_wav(str(noise_dir / "ambience_tetra_24k_edited.wav"),
                  (rng.standard_normal((24000, 4)) * 0.01).astype(np.float32), 24000)
    return root


@pytest.fixture(scope="module")
def dcase(tmp_path_factory):
    return _make_dcase_tree(tmp_path_factory.mktemp("dcase"), np.random.default_rng(8))


def test_dcase_tree_equals_jax(dcase, tmp_path):
    counts, files, _ = _extract_both("DCASE", dcase, tmp_path)
    assert counts == {"rir": 3 * 2 * 2 * 6, "noise": 3 * 6}
    assert "gym/tetra/SP2-1-2_MP-3-4.npy" in files


# ---------------------------------------------------------------------- MIR

def test_mir_tree_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    d = tmp_path / "mir" / "Impulse_response_Acoustic_Lab_Bar-Ilan_University"
    d.mkdir(parents=True)
    spacing = np.array([4.0, 4.0, 4.0, 8.0, 4.0, 4.0, 4.0])
    for t60, angle in (("0.160", "000"), ("0.360", "015")):
        name = ("Impulse_response_Acoustic_Lab_Bar-Ilan_University_"
                f"(Reverberation_{t60}s)_4-4-4-8-4-4-4_1m_{angle}.mat")
        scipy.io.savemat(d / name, {
            "impulse_response": _decaying_rir(rng, 40000, 8, fs=48000),
            "simpar": {"fs": 48000.0},
            "metapar": {"reverberation": float(t60), "mic_spacing": spacing,
                        "mic_position": "pos: 030 deg, 150 deg"}})
    counts, files, _ = _extract_both("MIR", tmp_path / "mir", tmp_path)
    assert counts["rir"] > 0 and any(f.startswith("R2/") for f in files)
    np.testing.assert_array_equal(tex.MIRExtractor.geometry(spacing, (30.0, 150.0)),
                                  jex.MIRExtractor.geometry(spacing, (30.0, 150.0)))


# ------------------------------------------------------------- room splits

@pytest.mark.parametrize("corpus", sorted(jex.ROOM_SPLITS) + ["LOCATA"])
def test_rooms_for_stage_equals_jax(corpus):
    for stage in ("pretrain", "preval", "train"):
        try:
            want = jex.rooms_for_stage(corpus, stage)
        except ValueError:
            with pytest.raises(ValueError, match="no rooms assigned"):
                tex.rooms_for_stage(corpus, stage)
            continue
        assert tex.rooms_for_stage(corpus, stage) == want
    if corpus in ("DCASE", "BUTReverb"):
        assert set(tex.rooms_for_stage(corpus, "pretrain")).isdisjoint(
            tex.rooms_for_stage(corpus, "preval"))


# ---------------------------------------------------------- generation CLIs

def _gen_both(tmp, argv_fn):
    for name, mod in (("torch", t_gen_sig), ("jax", j_gen_sig)):
        assert mod.main(argv_fn(tmp / name)) == 0
    return _same_tree(tmp / "torch", tmp / "jax")


def test_gen_real_rir_cli_equals_jax(ace, tmp_path):
    for name, mod in (("torch", t_gen_rir), ("jax", j_gen_rir)):
        assert mod.main(["--corpus", "ACE", "--data-dir", str(ace), "--save-dir",
                         str(tmp_path / name), "--data-type", "rir"]) == 0
    files = _same_tree(tmp_path / "torch", tmp_path / "jax")
    assert not any(f.endswith(".wav") for f in files)
    assert t_gen_rir.main(["--corpus", "MIR", "--data-dir", str(tmp_path / "none"),
                           "--save-dir", str(tmp_path / "empty")]) == 1


@pytest.fixture(scope="module")
def src_tree(tmp_path_factory):
    root, rng = tmp_path_factory.mktemp("src"), np.random.default_rng(10)
    for spk in ("s1", "s2"):
        (root / spk).mkdir()
        for u in range(2):
            write_wav(str(root / spk / f"u{u}.wav"),
                      (rng.standard_normal((5000 + 300 * u, 1)) * 0.1).astype(np.float32), FS)
    return str(root)


def test_gen_sig_from_real_rir_cli_equals_jax(ace, src_tree, tmp_path):
    tex.ACEExtractor(str(ace)).extract(str(tmp_path / "rirs"))
    files = _gen_both(tmp_path, lambda d: [
        "--rir-dir", str(tmp_path / "rirs"), "--src-dir", src_tree, "--save-dir", str(d),
        "--num", "6", "--corpus", "ACE", "--T", "0.25", "--stage", "pretrain"])
    assert len(files) == 12 and "5_info.npz" in files
    # the seed: the stage's, offset by the corpus's place (float arithmetic)
    assert t_gen_sig.CORPUS_ORDER == j_gen_sig.CORPUS_ORDER
    ds = trr.MicSigFromRIRDataset(trr.NpyRIRDataset(str(tmp_path / "rirs")),
                                  SpeakerTreeDataset(src_tree, T=0.25, fs=FS), T=0.25,
                                  seed=int(1 + 5 * 10e6), length=6)
    np.testing.assert_array_equal(read_wav(str(tmp_path / "torch" / "3.wav"))[0], ds[3][0])


@pytest.mark.parametrize("stage", ["pretrain", "preval"])
def test_room_splits_hold_rooms_out_of_other_stages(dcase, src_tree, tmp_path, stage):
    """A DCASE tree of 3 rooms (2 pre-training, 1 held out): each stage's
    generation reads only its rooms, in both packages."""
    tex.DCASEExtractor(str(dcase)).extract(str(tmp_path / "rirs"))
    rooms = tex.rooms_for_stage("DCASE", stage)
    ds = trr.NpyRIRDataset(str(tmp_path / "rirs"), rooms=rooms)
    used = {Path(p).relative_to(tmp_path / "rirs").parts[0] for p in ds.paths}
    assert used == ({"bomb_shelter", "gym"} if stage == "pretrain" else {"tb103"})
    files = _gen_both(tmp_path, lambda d: [
        "--rir-dir", str(tmp_path / "rirs"), "--src-dir", src_tree, "--save-dir", str(d),
        "--num", "3", "--corpus", "DCASE", "--T", "0.25", "--stage", stage])
    assert len(files) == 6
    with pytest.raises(ValueError, match="no rooms assigned"):
        t_gen_sig.main(["--rir-dir", str(tmp_path / "rirs"), "--src-dir", src_tree,
                        "--save-dir", str(tmp_path / "x"), "--num", "1", "--corpus", "ACE",
                        "--stage", "preval"])
    assert not os.path.exists(tmp_path / "x")
