"""Build and load the port's hand-written kernels, and count their launches.

CUDA sources in ``sarssl_torch/csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``sarssl_torch/_build/`` (git-ignored), keyed by a hash of the source,
the sources it includes, the headers beside it (``csrc/*.cuh``) and the
flags, and loaded with
``ctypes``. Triton keeps its cache in the same
directory. Nothing is built when a module is imported.

``launches`` counts kernel launches by name (the attention kernels by head
dim, e.g. ``attention_fwd_d128`` for every forward launch,
``attention_fwd_tc_d128`` for those of the bf16 tensor-core kernels,
``attention_fwd_tf32x3_d128`` for those of the f32 ones and
``attention_fwd_fma_d128`` for the FMA kernels'; a padded head dim counts
at its instance's, e.g. D = 8 as ``d16``; the conv
launches likewise, ``conv3x3_fwd`` and ``conv3x3_fwd_tc``): each wrapper adds
one where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()

# the blocks a launch grid's y or z dimension holds (x: 2**31 - 1); the
# wrappers cover more (b, h) pairs or images in several launches, and more
# lanes on both dimensions
GRID_YZ = 65535


def reset_launches() -> None:
    launches.clear()


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``), or None."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    return str(cand) if cand.exists() else None


def _nvcc() -> str:
    found = cuda_tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def hashed_target(stem: str, key: bytes) -> Path:
    """``_build/lib<stem>_<hash of key>.so``: a build keyed by what made it
    (sources and flags), so an edited source never loads an old build."""
    return BUILD_DIR / f"lib{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def _target(src: Path) -> Path:
    # every header counts for every source, and a source a source includes
    # (attention_f32_mma_psum.cu builds attention_f32_mma.cu) for that one: an
    # edited file never loads a library built from the old one
    text = src.read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    included = b"".join((CSRC_DIR / m).read_bytes()
                        for m in re.findall(r'#include "([^"]+\.cu)"', text.decode()))
    return hashed_target(src.stem, text + included + headers + " ".join(NVCC_FLAGS).encode())


def build_all(names=None) -> dict[str, str]:
    """Compile ``csrc/<name>.cu`` for each name (default: every source) that
    has no build of the same source yet, one ``nvcc`` process per source,
    all started together. Returns each name's compiler output (empty when
    the build was already there)."""
    srcs = ([CSRC_DIR / f"{n}.cu" for n in names] if names is not None
            else sorted(CSRC_DIR.glob("*.cu")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    for src in srcs:
        out = _target(src)
        if out.exists():
            logs[src.stem] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu\n{logs[n]}" for n in failed))
    return logs


def built_library(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lies (after :func:`build_all`)."""
    return _target(CSRC_DIR / f"{name}.cu")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(built_library(name)))


def import_triton():
    """Import Triton with its cache under the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return triton, tl


def raw_stream(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it, without
    making a ``Stream`` object each call (the handle Triton's launcher
    takes)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_cuda_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error; each library exports
    ``error_string(int)`` (``cudaGetErrorString``)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.error_string(code).decode()})")
