"""Random spatial-acoustics sampler: rooms, arrays, source trajectories (the
port's own copy of ``sarssl_tpu/data/rooms.py``: the same rng calls in the
same order, so both packages draw the same scene from the same seed).

Math follows reference ``SpatialAcoustics``
(``data_generation/utils_simu_rir_sig.py:17-376``):
uniform room dims, target T60 with Sabine-consistency rejection, per-wall
reflection coefficients from inverse-Sabine optimization, array placement by
room-ratio with uniform scale/azimuth-rotation, and static or 3-D sinusoidal
moving source positions respecting array/boundary distances.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import minimize


# 2-channel linear array template (reference utils_array.py:3-17)
MIC_ARRAY_2CH = {
    "array_type": "planar_linear",
    "mic_pos_relative": np.array([[-0.05, 0.0, 0.0], [0.05, 0.0, 0.0]]),
    "mic_orV": np.array([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
    "array_orV": np.array([0.0, 1.0, 0.0]),
    "mic_pattern": "omni",
    "array_scale_range": (0.3, 2.0),
    "array_rotate_azi_range": (0.0, 360.0),
}

# 4-channel circular array template (reference utils_array.py:19-29)
_circ = np.array([[np.cos(a), np.sin(a), 0.0]
                  for a in np.deg2rad([0, 90, 180, 270])]) * 0.05
MIC_ARRAY_4CH_CIRCULAR = {
    "array_type": "planar_linear",
    "mic_pos_relative": _circ,
    "mic_orV": _circ / np.linalg.norm(_circ, axis=1, keepdims=True),
    "array_orV": np.array([0.0, 0.0, 1.0]),
    "mic_pattern": "omni",
    "array_scale_range": (1.0, 1.0),
    "array_rotate_azi_range": (0.0, 360.0),
}


@dataclass
class AcousticSamplerConfig:
    room_sz_range: Sequence = ((3.0, 15.0), (3.0, 10.0), (2.5, 6.0))
    T60_range: Tuple[float, float] = (0.2, 1.3)
    abs_weights_range: Sequence = ((0.5, 1.0),) * 6
    c: float = 343.0
    fs: int = 16000
    ism_db: float = 12.0
    array_pos_ratio_range: Sequence = ((0.3, 0.7), (0.3, 0.7), (0.2, 0.5))
    num_source_range: Tuple[int, int] = (1, 1)
    source_state: str = "static"
    traj_pt_mode: str = "time"  # 'time' | 'distance_line' | 'distance_sin'
    # (reference utils_simu_rir_sig.py:323-361: adaptive point counts, one
    # point per ~10 cm of line / arc length)
    min_src_array_dist: float = 0.5
    min_src_boundary_dist: float = 0.3
    nb_points: int = 1
    mic_array: Dict = field(default_factory=lambda: dict(MIC_ARRAY_2CH))


def beta_sabine(room_sz, T60, abs_weights=(1.0,) * 6) -> np.ndarray:
    """Per-wall reflection coefficients for a target Sabine T60
    (reference utils_simu_rir_sig.py:100-114)."""
    aw = np.asarray(abs_weights, np.float64)
    aw = aw / aw.max()

    def t60err(x):
        alpha = x * aw
        Sa = ((alpha[0] + alpha[1]) * room_sz[1] * room_sz[2]
              + (alpha[2] + alpha[3]) * room_sz[0] * room_sz[2]
              + (alpha[4] + alpha[5]) * room_sz[0] * room_sz[1])
        V = float(np.prod(room_sz))
        if Sa == 0:
            return T60
        return abs(T60 - 0.161 * V / Sa)

    res = minimize(t60err, 0.5, bounds=[[0, 1]])
    return np.sqrt(1 - res.x * aw).astype(np.float32)


def sabine_t60(room_sz, alpha, eps: float = 1e-4) -> float:
    Sa = ((alpha[0] + alpha[1]) * room_sz[1] * room_sz[2]
          + (alpha[2] + alpha[3]) * room_sz[0] * room_sz[2]
          + (alpha[4] + alpha[5]) * room_sz[0] * room_sz[1])
    V = float(np.prod(room_sz))
    return 0.161 * V / (Sa + eps)


def t60_is_valid(room_sz, T60, alpha, c, ism_db, th: float = 0.005):
    """Sabine-consistency + non-sparse-reflection checks
    (reference utils_simu_rir_sig.py:116-131)."""
    Sa = ((alpha[0] + alpha[1]) * room_sz[1] * room_sz[2]
          + (alpha[2] + alpha[3]) * room_sz[0] * room_sz[2]
          + (alpha[4] + alpha[5]) * room_sz[0] * room_sz[1])
    if Sa == 0:
        return False, np.inf
    T60_sab = sabine_t60(room_sz, alpha)
    ok = abs(T60 - T60_sab) < th
    beta_prod = float(np.prod(1 - np.asarray(alpha)))
    max_dist = float(np.linalg.norm(room_sz))
    ism_time = ism_db / 60 * T60_sab
    return bool(ok) and beta_prod != 0 and (ism_time >= 3 * max_dist / c), T60_sab


def sample_room(rng: np.random.Generator, cfg: AcousticSamplerConfig) -> Dict:
    room_sz = np.array([rng.uniform(*r) for r in cfg.room_sz_range])
    while True:
        T60_spec = rng.uniform(*cfg.T60_range)
        aw = [rng.uniform(*r) for r in cfg.abs_weights_range]
        beta = beta_sabine(room_sz, T60_spec, aw)
        ok, T60_sab = t60_is_valid(room_sz, T60_spec, 1 - beta ** 2,
                                   cfg.c, cfg.ism_db)
        if ok:
            return {"room_sz": room_sz, "beta": beta,
                    "T60_specify": T60_spec, "T60_sabine": T60_sab}


def sample_array(rng: np.random.Generator, cfg: AcousticSamplerConfig,
                 room_sz) -> Dict:
    mic = cfg.mic_array
    array_pos = np.array([
        rng.uniform(r[0] * room_sz[i], r[1] * room_sz[i])
        for i, r in enumerate(cfg.array_pos_ratio_range)])
    scale = rng.uniform(*mic["array_scale_range"])
    rot_deg = rng.uniform(*mic["array_rotate_azi_range"])
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    mic_pos = array_pos + (R @ mic["mic_pos_relative"].T).T * scale
    return {"array_type": mic["array_type"], "mic_pos": mic_pos,
            "array_pos": array_pos, "array_scale": scale,
            "array_rotate_azi": rot_deg,
            "mic_orV": (R @ mic["mic_orV"].T).T,
            "array_orV": R @ mic["array_orV"],
            "mic_pattern": mic["mic_pattern"]}


def sample_trajectory(rng: np.random.Generator, cfg: AcousticSamplerConfig,
                      room_sz, array: Dict) -> np.ndarray:
    """Returns traj_pts (nb_points, 3, num_source)."""
    num_source = int(rng.integers(cfg.num_source_range[0],
                                  cfg.num_source_range[1] + 1))
    trajs: List[np.ndarray] = []
    b = cfg.min_src_boundary_dist
    for _ in range(num_source):
        lo = np.full(3, b)
        hi = np.asarray(room_sz, float) - b
        if array["array_type"] == "planar_linear":
            # half-plane on the array-orientation side (ref :182-190)
            orv = array["array_orV"]
            nz = np.nonzero(orv)[0]
            if orv.sum() > 0:
                lo[nz] = array["array_pos"][nz]
                lo = lo + cfg.min_src_array_dist * np.abs(orv)
            else:
                hi[nz] = array["array_pos"][nz]
                hi = hi - cfg.min_src_array_dist * np.abs(orv)
        assert np.all(lo <= hi), f"source range empty: {lo} > {hi}"
        if cfg.source_state == "static":
            pos = lo + rng.random(3) * (hi - lo)
            trajs.append(np.ones((cfg.nb_points, 1)) * pos)
        elif cfg.source_state == "moving":
            p0 = lo + rng.random(3) * (hi - lo)
            p1 = lo + rng.random(3) * (hi - lo)
            Amax = np.min(np.stack([p0 - lo, hi - p0, p1 - lo, hi - p1]), axis=0)
            A = rng.random(3) * np.minimum(Amax, 1.0)
            if cfg.traj_pt_mode == "time":
                npt = cfg.nb_points
                w = 2 * np.pi / npt * rng.random(3) * 2
                line = np.stack([np.linspace(a, bb, npt)
                                 for a, bb in zip(p0, p1)], axis=1)
                osc = A * np.sin(w * np.arange(npt)[:, None])
                trajs.append(line + osc)
            elif cfg.traj_pt_mode == "distance_line":
                # adaptive point count: one point per ~10 cm of straight-line
                # distance (utils_simu_rir_sig.py:329-335; the reference's
                # distance expression reduces to |sum(p1-p0)| — we use the
                # intended Euclidean norm)
                desired = 0.1
                npt = int(np.linalg.norm(p1 - p0) // desired + 1)
                w = 2 * np.pi / npt * rng.random(3) * 2
                line = np.stack([np.linspace(a, bb, npt)
                                 for a, bb in zip(p0, p1)], axis=1)
                osc = A * np.sin(w * np.arange(npt)[:, None])
                trajs.append(line + osc)
            elif cfg.traj_pt_mode == "distance_sin":
                # walk the sinusoid so ADJACENT points are ~10 cm apart in
                # arc length (utils_simu_rir_sig.py:336-361): successive
                # deltas along the line direction solved by bounded 1-D
                # minimization of the point-to-point distance error
                desired = 0.1
                dist = float(np.linalg.norm(p1 - p0))
                dirv = (p1 - p0) / max(dist, 1e-9)
                w = 2 * np.pi / max(dist, 1e-9) * rng.random(3) * 2
                pts, lines = [], []
                t = 0.0
                while t < dist:
                    line = p0 + dirv * t
                    pos0 = line + A * np.sin(w * t)
                    pts.append(pos0)
                    lines.append(line)

                    def err(dt, t=t, pos0=pos0):
                        pn = (p0 + dirv * (t + dt[0])
                              + A * np.sin(w * (t + dt[0])))
                        return abs(np.linalg.norm(pn - pos0) - desired)

                    for factor in (1.0, 1.5, 3.0):
                        res = minimize(err, x0=[desired / 10],
                                       bounds=[(0, desired * factor)],
                                       tol=desired / 100)
                        if res.fun < desired / 100:
                            break
                    t += max(float(res.x[0]), desired / 100)
                trajs.append(np.asarray(pts))
            else:
                raise ValueError(cfg.traj_pt_mode)
        else:
            raise ValueError(cfg.source_state)
    npt_min = min(t.shape[0] for t in trajs)
    trajs = [t[:npt_min] for t in trajs]
    return np.stack(trajs, axis=-1)  # (npt, 3, nsrc)


def sample_acoustic_scene(rng_or_seed, cfg: AcousticSamplerConfig,
                          room_cfg: Optional[Dict] = None) -> Dict:
    """One full random scene config (room + array + trajectory)."""
    rng = (rng_or_seed if isinstance(rng_or_seed, np.random.Generator)
           else np.random.default_rng(rng_or_seed))
    room = room_cfg or sample_room(rng, cfg)
    array = sample_array(rng, cfg, room["room_sz"])
    traj = sample_trajectory(rng, cfg, room["room_sz"], array)
    return {**room, **array, "src_traj_pts": traj}
