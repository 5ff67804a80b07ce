"""Build and load the port's CUDA sources (gfalign_torch/csrc/*.cu).

Each source becomes one shared library with a plain C interface, compiled
with nvcc for sm_90a at first use into build/gfalign_torch/ and loaded with
ctypes.  `build(stem)` compiles explicitly and returns nvcc's register and
spill report; `start_build(stem)` starts the compiler without waiting, so
that several sources compile side by side; `load(stem)` builds if needed
and returns the library.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
from typing import Optional, Tuple

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "gfalign_torch"


def source_path(stem: str) -> pathlib.Path:
    return _CSRC / f"{stem}.cu"


def lib_path(stem: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{stem}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _up_to_date(stem: str) -> bool:
    lib, src = lib_path(stem), source_path(stem)
    return lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime


def start_build(stem: str) -> Optional[Tuple[subprocess.Popen, pathlib.Path]]:
    """Start nvcc on csrc/<stem>.cu unless an up-to-date library is already
    built; returns (process, temporary output) for `finish_build`, or None
    when there is nothing to do."""
    if _up_to_date(stem):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = lib_path(stem)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(source_path(stem))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp


def finish_build(stem: str, started) -> str:
    """Wait for a build started by `start_build`; returns nvcc's
    -Xptxas -v report ('' when nothing was built)."""
    if started is None:
        return ""
    proc, tmp = started
    _, report = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{report}")
    os.replace(tmp, lib_path(stem))  # atomic: a concurrent loader never sees half a file
    return report


def build(stem: str) -> str:
    """Compile csrc/<stem>.cu for sm_90a unless an up-to-date library is
    already built; returns nvcc's -Xptxas -v report ('' when cached)."""
    return finish_build(stem, start_build(stem))


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    build(stem)
    return ctypes.CDLL(str(lib_path(stem)))
