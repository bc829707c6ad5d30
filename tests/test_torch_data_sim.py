"""The port's host simulation (``sarssl_torch.data``: rooms, the image-source
engine and its C++ core, annotations, noise, scene synthesis, and the
``gen_simu`` / ``gen_simu_certain_room`` CLIs) against the JAX package's on
the same seeds.

Tolerances: every comparison is bit for bit (``np.array_equal``), except the
C++ core against the numpy image loop, which sums the same taps in another
order: within 1e-6 of the RIR's largest magnitude. Where the JAX package runs
its C++ path, it runs it on the port's build of the same source (its library
handle is pointed at the port's for the test), so both packages compute the
same sums; its numpy path is taken by pointing the handle at nothing.
"""
import os

import numpy as np
import pytest

from sarssl_torch.cli import gen_simu as t_gen
from sarssl_torch.cli import gen_simu_certain_room as t_gen_room
from sarssl_torch.data import annotations as tann
from sarssl_torch.data import ism as tism
from sarssl_torch.data import native as tnative
from sarssl_torch.data import noise as tnoise
from sarssl_torch.data import rooms as trooms
from sarssl_torch.data import scene as tscene
from sarssl_torch.data.wavio import read_wav
from sarssl_tpu.cli import gen_simu as j_gen
from sarssl_tpu.cli import gen_simu_certain_room as j_gen_room
from sarssl_tpu.data import annotations as jann
from sarssl_tpu.data import ism as jism
from sarssl_tpu.data import native as jnative
from sarssl_tpu.data import noise as jnoise
from sarssl_tpu.data import rooms as jrooms
from sarssl_tpu.data import scene as jscene

FS = 16000
ROOMS = ((3.0, 6.0), (3.0, 6.0), (2.5, 3.0))  # small rooms keep the RIRs short
T = 0.5
SEEDS = (0, 1, 7)
SMALL = ["--T", str(T), "--room-x", "3", "6", "--room-y", "3", "6", "--room-z", "2.5", "3"]


def _cfg(mod, **kw):
    return mod.AcousticSamplerConfig(room_sz_range=ROOMS, **kw)


def _equal(a, b, path="item"):
    """Equal dicts / tuples / arrays / scalars, recursively, bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


@pytest.fixture(scope="session")
def ism_lib():
    """The port's C++ core, built (or found built) once per test process."""
    return tnative.load()


@pytest.fixture
def jax_native(monkeypatch, ism_lib):
    """The JAX package's C++ path, on the port's build of the same source."""
    monkeypatch.setattr(jnative, "_LIB", ism_lib)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's numpy image loop."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.mark.parametrize("kw", [
    {}, {"num_source_range": (1, 3)},
    {"source_state": "moving", "nb_points": 5},
    {"source_state": "moving", "traj_pt_mode": "distance_line"},
    {"source_state": "moving", "traj_pt_mode": "distance_sin"},
    {"mic_array": "4ch"},
], ids=["static", "three_sources", "moving_time", "moving_line", "moving_sin",
        "circular_4ch"])
def test_sample_acoustic_scene_equals_jax(kw):
    for seed in SEEDS:
        tk, jk = dict(kw), dict(kw)
        if kw.get("mic_array") == "4ch":
            tk["mic_array"] = dict(trooms.MIC_ARRAY_4CH_CIRCULAR)
            jk["mic_array"] = dict(jrooms.MIC_ARRAY_4CH_CIRCULAR)
        _equal(trooms.sample_acoustic_scene(seed, _cfg(trooms, **tk)),
               jrooms.sample_acoustic_scene(seed, _cfg(jrooms, **jk)))
    _equal(trooms.beta_sabine([5.0, 4.0, 3.0], 0.6, [0.7, 1, 0.8, 1, 0.9, 1]),
           jrooms.beta_sabine([5.0, 4.0, 3.0], 0.6, [0.7, 1, 0.8, 1, 0.9, 1]))


def _rir_args(seed, t60=None):
    s = trooms.sample_acoustic_scene(seed, _cfg(trooms))
    return dict(room_sz=s["room_sz"], beta=s["beta"], src_traj_pts=s["src_traj_pts"],
                mic_pos=s["mic_pos"], fs=FS, T60=t60 or s["T60_sabine"])


@pytest.mark.parametrize("t60", [None, 0.12], ids=["sampled_t60", "full_ism_below_0.15"])
def test_simulate_rir_numpy_equals_jax(t60, jax_numpy):
    for seed in SEEDS:
        a = _rir_args(seed, t60)
        for dp in (False, True):
            got = tism.simulate_rir(**a, dp_only=dp, rng=np.random.default_rng(seed),
                                    impl="numpy")
            want = jism.simulate_rir(**a, dp_only=dp, rng=np.random.default_rng(seed))
            _equal(got, want)


@pytest.mark.parametrize("t60", [None, 0.12], ids=["sampled_t60", "full_ism_below_0.15"])
def test_simulate_rir_native_equals_jax_and_numpy(t60, jax_native):
    for seed in SEEDS:
        a = _rir_args(seed, t60)
        got = tism.simulate_rir(**a, rng=np.random.default_rng(seed))
        _equal(got, jism.simulate_rir(**a, rng=np.random.default_rng(seed)))
        plain = tism.simulate_rir(**a, rng=np.random.default_rng(seed), impl="numpy")
        assert np.abs(got - plain).max() <= 1e-6 * np.abs(plain).max()


def test_native_core_builds_into_the_build_dir(ism_lib):
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert not (tnative.SRC.parent / "libism.so").exists()  # nothing next to the source
    with pytest.raises(ValueError, match="impl"):
        tism.simulate_rir_single([5, 4, 3], [0.9] * 6, [1, 1, 1], [[2, 2, 2]], FS, 0.3,
                                 impl="cuda")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; it never falls back to numpy."""
    bad = tmp_path / "ism.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "hashed_target", lambda stem, key: tmp_path / "libism.so")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build()


def test_annotations_equal_jax(jax_native):
    for seed in SEEDS:
        s = trooms.sample_acoustic_scene(seed, _cfg(trooms))
        a = _rir_args(seed)
        rir = tism.simulate_rir(**a, rng=np.random.default_rng(seed))
        dp = tism.simulate_rir(**a, dp_only=True)
        for name in ("drr", "c50", "c80"):
            _equal(getattr(tann, name)(rir, dp, FS), getattr(jann, name)(rir, dp, FS))
        _equal(tann.edc(rir[0, 0, :, 0]), jann.edc(rir[0, 0, :, 0]))
        _equal(tann.t60_from_rir(rir[0, 0, :, 0], FS), jann.t60_from_rir(rir[0, 0, :, 0], FS))
        _equal(tann.check_rir_envelope(rir, s["T60_specify"], FS),
               jann.check_rir_envelope(rir, s["T60_specify"], FS))
        _equal(tann.tdoa_from_geometry(s["src_traj_pts"], s["mic_pos"]),
               jann.tdoa_from_geometry(s["src_traj_pts"], s["mic_pos"]))
        _equal(tann.doa_from_geometry(s["src_traj_pts"], s["array_pos"]),
               jann.doa_from_geometry(s["src_traj_pts"], s["array_pos"]))
        _equal(tann.mean_absorption(s["room_sz"], 0.4), jann.mean_absorption(s["room_sz"], 0.4))
        s["T60_edc"] = 0.41
        _equal(tann.annotate_scene(s, rir, dp, FS), jann.annotate_scene(s, rir, dp, FS))
    sig = np.random.default_rng(0).standard_normal((4000, 2))
    _equal(tann.mic_vad_dp_ratio(sig, sig[:, :] * 0.5, FS),
           jann.mic_vad_dp_ratio(sig, sig[:, :] * 0.5, FS))


def test_noise_generators_equal_jax():
    n, mics = 6000, np.array([[0.0, 0, 0], [0.08, 0, 0], [0.0, 0.08, 0]])

    def speech(r):
        x = r.standard_normal(3000)
        x[1:] += 0.8 * x[:-1]
        return x

    rec = speech(np.random.default_rng(9))
    calls = [
        lambda m, r: m.spatial_white(r, n, 3),
        lambda m, r: m.diffuse_noise(r, n, mics, FS),
        lambda m, r: m.diffuse_noise(r, n, mics, FS, field="cylindrical"),
        lambda m, r: m.babble_noise(r, n, mics, FS, speech, nspeech=3),
        lambda m, r: m.xsrc_noise(r, n, mics, FS, rec, 8000),
        lambda m, r: m.real_world_noise(r, n, 3, np.stack([rec] * 3, 1), 8000, FS),
        lambda m, r: m.pad_cut_same(rec, 5000, r),
        lambda m, r: m.measured_coherence(m.diffuse_noise(r, n, mics[:2], FS)),
        lambda m, r: m.add_noise(r.standard_normal((n, 2)), r.standard_normal((n, 2)), 12.0,
                                 mic_sig_dp=r.standard_normal((n, 2))),
    ]
    for call in calls:
        _equal(call(tnoise, np.random.default_rng(4)), call(jnoise, np.random.default_rng(4)))


@pytest.mark.parametrize("kind", ["diffuse_white", "spatial_white", "diffuse_babble", "none",
                                  "dp_ratio_vad", "src_energy_vad", "rir_mode"])
def test_scene_synthesizer_equals_jax(kind, jax_native):
    kw = {"noise_type": "" if kind == "none" else kind}
    if kind.endswith("_vad"):
        kw = {"noise_type": "spatial_white", "mic_vad": kind[:-4]}
    if kind == "rir_mode":
        kw = {}
    t = tscene.SceneSynthesizer(cfg=_cfg(trooms), T=T, **kw)
    j = jscene.SceneSynthesizer(cfg=_cfg(jrooms), T=T, **kw)
    for seed in SEEDS[:2]:
        if kind == "rir_mode":
            _equal(t.generate_rir(seed), j.generate_rir(seed))
        else:
            _equal(t.generate(seed), j.generate(seed))


def test_scene_with_recorded_noise_equals_jax(tmp_path, jax_native):
    """'diffuse_xsrc' and 'real_world' noise read wav recordings through the
    port's own wavio."""
    from sarssl_torch.data.wavio import write_wav
    rng = np.random.default_rng(3)
    for i, nch in enumerate((1, 2, 2)):
        write_wav(str(tmp_path / f"n{i}.wav"), rng.standard_normal((20000, nch)) * 0.1, 8000)
    paths = tuple(sorted(str(p) for p in tmp_path.glob("*.wav")))
    for noise in ("diffuse_xsrc", "real_world"):
        t = tscene.SceneSynthesizer(cfg=_cfg(trooms), T=T, noise_type=noise, noise_paths=paths)
        j = jscene.SceneSynthesizer(cfg=_cfg(jrooms), T=T, noise_type=noise, noise_paths=paths)
        _equal(t.generate(5), j.generate(5))


def test_scene_numpy_impl_matches_native():
    """The plain image loop as the scene's engine gives the same item within
    the core's tolerance (same rng sequence: the same scene is drawn)."""
    nat = tscene.SceneSynthesizer(cfg=_cfg(trooms), T=T).generate(2)
    plain = tscene.SceneSynthesizer(cfg=_cfg(trooms), T=T, ism_impl="numpy").generate(2)
    assert nat[1]["room_sz"].tolist() == plain[1]["room_sz"].tolist()
    assert np.abs(nat[0] - plain[0]).max() <= 1e-5


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    files = _tree(a)
    assert files == _tree(b) and files
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            _equal(dict(za), dict(zb), f)
        else:  # wav and npy: the same bytes
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f
    return files


@pytest.mark.parametrize("extra", [["--save-dp"], ["--mode", "rir", "--idx0", "3"],
                                   ["--noise", "spatial_white", "--mic-vad", "dp_ratio",
                                    "--stage", "test"]],
                         ids=["sig_with_dp", "rir_mode", "spatial_white_vad"])
def test_gen_simu_tree_equals_jax(extra, tmp_path, jax_native, capsys):
    args = ["--data-num", "3", "--workers", "1", *SMALL, *extra]
    assert t_gen.main(args + ["--save-dir", str(tmp_path / "t")]) == 0
    assert j_gen.main(args + ["--save-dir", str(tmp_path / "j")]) == 0
    files = _same_tree(tmp_path / "t", tmp_path / "j")
    if "rir" in extra:
        assert "3_rir.npy" in files and "5_rir_info.npz" in files
    else:
        sig, fs = read_wav(str(tmp_path / "t" / "0.wav"))
        assert fs == FS and sig.shape == (int(T * FS), 2)


def test_gen_simu_worker_pool_writes_the_in_process_tree(tmp_path, jax_native):
    """Spawned workers (which touch no CUDA) write the same files as one
    process, and as the JAX CLI."""
    args = ["--data-num", "4", "--stage", "val", *SMALL]
    assert t_gen.main(args + ["--workers", "2", "--save-dir", str(tmp_path / "pool")]) == 0
    assert j_gen.main(args + ["--workers", "1", "--save-dir", str(tmp_path / "j")]) == 0
    _same_tree(tmp_path / "pool", tmp_path / "j")


def test_gen_simu_certain_room_tree_equals_jax(tmp_path, jax_native):
    args = ["--room-num", "2", "--rir-per-room", "2", "--sig-per-rir", "1", "--workers", "1",
            "--T", str(T), "--noise", "spatial_white"]
    assert t_gen_room.main(args + ["--save-dir", str(tmp_path / "t")]) == 0
    assert j_gen_room.main(args + ["--save-dir", str(tmp_path / "j")]) == 0
    files = _same_tree(tmp_path / "t", tmp_path / "j")
    assert {f.split(os.sep)[0] for f in files} == {"R0", "R1"}


def test_generation_parsers_match_jax():
    for t, j in ((t_gen, j_gen), (t_gen_room, j_gen_room)):
        ta = {a.dest: (a.default, a.choices, a.nargs) for a in t.build_parser()._actions}
        ja = {a.dest: (a.default, a.choices, a.nargs) for a in j.build_parser()._actions}
        ta.pop("workers"), ja.pop("workers")  # both default to the host's cores
        assert ta == ja
    assert t_gen.STAGE_SEEDS == j_gen.STAGE_SEEDS

