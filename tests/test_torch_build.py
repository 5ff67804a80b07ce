"""How the port is packaged and where it compiles: the wheel carries the
sources the port builds at first use (the native host runtime, the CUDA
sources and the host shim); a source checkout builds into build/, an
installed package into a 0o700 directory of the user's cache keyed by the
compiler flags; and processes that ask for one library together compile
it once."""

from __future__ import annotations

import os
import pathlib
import shutil
import stat
import subprocess
import sys
import zipfile

from gfalign_torch.io import native
from gfalign_torch.ops import cuda_build
from gfalign_torch.utils import build_dir as bd

ROOT = pathlib.Path(__file__).resolve().parent.parent
WANTED = ("gfalign_torch/native/gfalign_host.cpp", "gfalign_torch/native/Makefile",
          "gfalign_torch/csrc/host_shim/cuda_runtime.h", "gfalign_torch/csrc/nw_path.cu",
          "gfalign_torch/csrc/seqalign.cu")


def build_wheel(tmp_path) -> pathlib.Path:
    """A wheel of a copy of the package sources, built offline with the
    installed setuptools (the copy keeps build/ and *.egg-info out of the
    checkout)."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(ROOT / "pyproject.toml", src)
    for pkg in ("gfalign_tpu", "gfalign_torch"):
        shutil.copytree(ROOT / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    done = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                           "--no-build-isolation", "--no-index", "-q", "-w",
                           str(tmp_path / "dist"), str(src)],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    return wheel


def test_installed_wheel_builds_its_native_library_in_the_user_cache(tmp_path):
    wheel = build_wheel(tmp_path)
    names = set(zipfile.ZipFile(wheel).namelist())
    missing = [n for n in WANTED if n not in names]
    assert not missing, missing
    (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
    scripts = zipfile.ZipFile(wheel).read(entry_points).decode()
    for line in ("gfalign-torch = gfalign_torch.cli.main:main",
                 "gfalign-torch-validate = gfalign_torch.cli.validate:main"):
        assert line in scripts.splitlines(), scripts
    site = tmp_path / "site"
    with zipfile.ZipFile(wheel) as z:
        z.extractall(site)
    cache = tmp_path / "cache"
    code = ("from gfalign_torch.io import native\n"
            "from gfalign_torch.ops import cuda_build\n"
            "native.build()\n"
            "assert native.available()\n"
            "print(native.LIB_PATH)\n"
            "print(cuda_build.BUILD_DIR)\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(site),
                               "XDG_CACHE_HOME": str(cache)})
    assert done.returncode == 0, done.stderr[-2000:]
    lib, cuda_dir = (pathlib.Path(p) for p in done.stdout.split())
    assert lib.is_file() and lib.parent.parent == cache / "gfalign_torch"
    assert lib.parent.name.startswith("native-")
    assert cuda_dir.parent == cache / "gfalign_torch" and cuda_dir.name.startswith("cuda-")
    for level in (lib.parent, lib.parent.parent):
        assert stat.S_IMODE(level.stat().st_mode) == 0o700, level
    assert not (site / "build").exists()


def test_build_directory_rule(tmp_path, monkeypatch):
    """A checkout keeps build/gfalign_torch/; an installed package gets the
    user's cache, one directory per flag set, made (or tightened) 0o700."""
    assert bd.in_checkout()
    assert native.BUILD_DIR == ROOT / "build" / "gfalign_torch" / "native"
    assert cuda_build.BUILD_DIR == ROOT / "build" / "gfalign_torch"
    installed = tmp_path / "site" / "gfalign_torch"
    installed.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    root = tmp_path / "cache" / "gfalign_torch"
    a = bd.build_dir("native", ["g++", "-O3"], package=installed)
    b = bd.build_dir("native", ["g++", "-O2"], package=installed)
    assert a.parent == b.parent == root and a != b
    assert a == bd.build_dir("native", ["g++", "-O3"], package=installed)
    assert not root.exists()                       # naming a directory creates nothing
    root.mkdir(parents=True, mode=0o755)
    os.chmod(root, 0o755)
    bd.make_dir(a)
    for level in (a, root):
        assert stat.S_IMODE(level.stat().st_mode) == 0o700, level


def test_processes_building_one_host_library_together_compile_once(tmp_path):
    """Two processes call build_host("nw_path") at once into an empty build
    directory: the file lock and the freshness check inside it let one
    compile and the other reuse its library."""
    log = tmp_path / "compiles.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho run >> {log}\nexec g++ \"$@\"\n")
    cxx.chmod(0o755)
    code = ("import pathlib, sys\n"
            "from gfalign_torch.ops import cuda_build\n"
            "cuda_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "print(cuda_build.build_host('nw_path'))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CXX": str(cxx)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-800:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and pathlib.Path(paths.pop()).is_file()
    assert log.read_text().splitlines() == ["run"]


def test_processes_building_one_cuda_library_together_run_nvcc_once(tmp_path):
    """The nvcc route (cuda_build.build: start_build, finish_build) with a
    stub nvcc under CUDA_HOME that counts its runs and writes its -o file:
    two processes building one source into an empty directory at once run
    the compiler once (the flock and the freshness check under it), and a
    third finds the library up to date and runs nothing."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n"
                    f"echo run >> {log}\n"
                    "sleep 1\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    code = ("import pathlib, sys\n"
            "from gfalign_torch.ops import cuda_build\n"
            "cuda_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "cuda_build.build('nw_path')\n"
            "print(cuda_build.lib_path('nw_path'))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_HOME": str(tmp_path / "cuda")}

    def start():
        return subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env)

    procs = [start() for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-800:] for o in outs]
    (lib,) = {o[0].strip() for o in outs}
    assert pathlib.Path(lib).read_text() == "lib\n"
    assert log.read_text().splitlines() == ["run"]
    third = start()
    assert third.communicate(timeout=120)[0].strip() == lib and third.returncode == 0
    assert log.read_text().splitlines() == ["run"]
