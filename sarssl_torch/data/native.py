"""ctypes bridge to the C++/OpenMP image-source core ``csrc/ism.cpp`` (the
port's counterpart of ``sarssl_tpu/data/native.py``).

The library is built at first use with ``g++ -O3 -march=native -fopenmp
-shared -fPIC`` into the git-ignored ``sarssl_torch/_build/``, keyed by a hash
of the source and the flags (``kernels/_build.py::hashed_target``), never
next to the source, and loaded with ``ctypes``. A build or load that fails
raises: the numpy image loop of ``ism.py`` runs only when a caller asks for it
(``impl="numpy"``). Build ahead of time with
``python -m sarssl_torch.data.build_native``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

from ..kernels._build import hashed_target

SRC = Path(__file__).resolve().parent / "csrc" / "ism.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]


def library_path() -> Path:
    """Where the build of the current source lies (built or not)."""
    return hashed_target("ism", SRC.read_bytes() + " ".join(CXX_FLAGS).encode())


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ism.cpp`` unless a build of this source exists; returns
    the library's path. Raises ``RuntimeError`` if the compiler is missing or
    fails. Concurrent builds each write their own file and rename it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd), flush=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the image-source core needs g++ to build "
                           f"({SRC}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, its ``ism_core`` typed; builds it first if needed."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"the image-source core {path} does not load: {e}") from e
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.ism_core.restype = None
    lib.ism_core.argtypes = [dbl, dbl, ctypes.c_int, dbl, dbl, ctypes.c_int,
                             dbl, dbl, ctypes.c_int, dbl, ctypes.c_int,
                             dbl, ctypes.c_int,
                             ctypes.c_double, ctypes.c_double, ctypes.c_double]
    return lib


def ism_core(cx, ax, cy, ay, cz, az, mics, nsamp: int, fs: int, c: float,
             t_lim: float) -> np.ndarray:
    """C++ image accumulation: per-axis image coordinates and amplitudes and
    the (nmic, 3) mic positions -> (nmic, nsamp) float64 RIRs up to
    ``t_lim`` seconds. The same contract as the numpy loop in ``ism.py``."""
    lib = load()
    arrays = [np.ascontiguousarray(a, np.float64) for a in (cx, ax, cy, ay, cz, az, mics)]
    cx, ax, cy, ay, cz, az, mics = arrays
    if not (len(cx) == len(ax) and len(cy) == len(ay) and len(cz) == len(az)
            and mics.ndim == 2 and mics.shape[1] == 3):
        raise ValueError("ism_core: image coordinates and amplitudes must pair up "
                         "per axis, and mics be (nmic, 3)")
    rir = np.zeros((mics.shape[0], nsamp), np.float64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.ism_core(ptr(cx), ptr(ax), len(cx), ptr(cy), ptr(ay), len(cy), ptr(cz), ptr(az),
                 len(cz), ptr(mics), mics.shape[0], ptr(rir), nsamp, float(fs), float(c),
                 float(t_lim))
    return rir
