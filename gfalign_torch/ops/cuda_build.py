"""Build and load the port's CUDA sources (gfalign_torch/csrc/*.cu).

Each source becomes one shared library with a plain C interface, compiled
with nvcc for sm_90a at first use into build/gfalign_torch/ (the user's
cache for an installed package, utils/build_dir.py), one process at a
time under a file lock, and loaded with ctypes.  `build(stem)` compiles explicitly and returns nvcc's register and
spill report; `start_build(stem)` starts the compiler without waiting, so
that several sources compile side by side; `load(stem)` builds if needed
and returns the library.  `sass_inner_loops(stem)` disassembles a built
library with cuobjdump and counts the instructions of every innermost loop,
which is how the instructions a DP cell costs are read off the machine code.

`build_host(stem)` builds a source for the CPU with a C++20 host compiler
and csrc/host_shim/cuda_runtime.h (blocks one after another in launch
order, a block's threads as OS threads; the shim knows the intrinsics of
nw_path.cu and seqalign.cu): the library has the same C interface, so the
launchers of ops/nw_cuda.py and ops/seqalign_cuda.py can drive it with CPU
tensors.  It exists
for the tests, which thereby run a kernel's indexing, barriers and
shuffles where there is no card; no entry point of the package uses it.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from ..utils.build_dir import build_dir, make_dir

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread"]
BUILD_DIR = build_dir("cuda", ["nvcc", *NVCC_FLAGS, "g++", *HOST_FLAGS])


def source_path(stem: str) -> pathlib.Path:
    return _CSRC / f"{stem}.cu"


def lib_path(stem: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{stem}.so"


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", name), shutil.which(name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put {name} on PATH)")


def _nvcc() -> str:
    return _tool("nvcc")


def _up_to_date(stem: str) -> bool:
    lib, src = lib_path(stem), source_path(stem)
    return lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime


def _locked(lib: pathlib.Path):
    """An exclusive flock on `lib`'s lock file (held until the returned
    file is closed; a dead holder releases it): one compiler a library at
    a time across processes, such as the ranks of a distributed run
    starting together."""
    make_dir(lib.parent)
    lock = open(lib.parent / f".{lib.name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    return lock


def start_build(stem: str) -> Optional[Tuple[subprocess.Popen, pathlib.Path, object]]:
    """Start nvcc on csrc/<stem>.cu unless an up-to-date library is already
    built; returns (process, temporary output, lock) for `finish_build`,
    or None when there is nothing to do.  The library's lock is held from
    here to `finish_build`, and freshness is checked again under it, so
    processes starting together compile a source once."""
    if _up_to_date(stem):
        return None
    lib = lib_path(stem)
    lock = _locked(lib)
    if _up_to_date(stem):                  # another process built it
        lock.close()
        return None
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source_path(stem))],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    except BaseException:
        lock.close()
        raise
    return proc, tmp, lock


def finish_build(stem: str, started) -> str:
    """Wait for a build started by `start_build`; returns nvcc's
    -Xptxas -v report ('' when nothing was built)."""
    if started is None:
        return ""
    proc, tmp, lock = started
    with lock:
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


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_inner_loops(stem: str) -> List[Dict]:
    """Innermost loops of the machine code of a built library: for every
    backward branch that encloses no other, the kernel's (mangled) name, the
    loop's instruction count and a histogram of its opcodes (predicates and
    modifiers dropped: `@P0 VIADDMNMX.U32` counts as VIADDMNMX)."""
    dump = subprocess.run([_tool("cuobjdump"), "-sass", str(lib_path(stem))],
                          capture_output=True, text=True, check=True).stdout
    functions, name = collections.OrderedDict(), None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            functions[name] = []
        elif name is not None:
            hit = _SASS_LINE.search(line)
            if hit:
                functions[name].append((int(hit.group(1), 16), hit.group(2)))
    loops = []
    for name, code in functions.items():
        spans = []
        for addr, text in code:
            hit = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if hit and int(hit.group(1), 16) <= addr:
                spans.append((int(hit.group(1), 16), addr))
        for lo, hi in spans:
            if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in spans):
                continue
            ops = collections.Counter(
                re.sub(r"^@!?U?P\d+\s+", "", text).split()[0].split(".")[0]
                for addr, text in code if lo <= addr <= hi)
            loops.append(dict(function=name, instructions=sum(ops.values()),
                              opcodes=dict(ops)))
    return loops


def host_source(stem: str) -> str:
    """csrc/<stem>.cu rewritten for a host compiler: each `extern __shared__`
    array becomes a pointer to the running block's shared memory, and each
    kernel<<<grid, threads, bytes, stream>>>(args) a host_launch(...)."""
    src = source_path(stem).read_text()
    src = re.sub(r"extern __shared__ int32_t (\w+)\[\];", r"int32_t* \1 = host_shared;", src)
    out, pos = [], 0
    while (k := src.find("<<<", pos)) >= 0:
        start, depth = k, 0
        while src[start - 1] == ">" or depth:    # template arguments
            start -= 1
            depth += {">": 1, "<": -1}.get(src[start], 0)
        while src[start - 1].isalnum() or src[start - 1] == "_":
            start -= 1
        cfg_end = src.index(">>>(", k)
        grid, threads, nbytes = (c.strip() for c in src[k + 3:cfg_end].split(",")[:3])
        depth, end = 1, cfg_end + 4
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        out += [src[pos:start], f"host_launch({grid}, {threads}, {nbytes}, [=]() "
                f"{{ {src[start:k]}({src[cfg_end + 4:end - 1]}); }})"]
        pos = end
    return "".join(out) + src[pos:]


def build_host(stem: str) -> pathlib.Path:
    """Build csrc/<stem>.cu for the CPU (see the module docstring) into
    build/gfalign_torch/host/ and return the library's path; a library at
    least as new as the source, the shim and this file is reused.  The
    compile runs under the library's lock with freshness checked again
    inside it, so processes asking together compile once.  Raises
    RuntimeError when there is no C++ compiler (CXX, default g++) or the
    compile fails."""
    name = os.environ.get("CXX", "g++")
    compiler = shutil.which(name)
    if compiler is None:
        raise RuntimeError(f"{name} not found")
    lib = BUILD_DIR / "host" / f"lib{stem}_host.so"
    deps = [source_path(stem), pathlib.Path(__file__), *(_CSRC / "host_shim").glob("*.h")]

    def fresh() -> bool:
        return lib.exists() and lib.stat().st_mtime >= max(d.stat().st_mtime for d in deps)

    if fresh():
        return lib
    with _locked(lib):
        if fresh():
            return lib
        cpp = lib.with_name(f"{stem}.{os.getpid()}.cpp")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cpp.write_text(host_source(stem))
        try:
            done = subprocess.run([compiler, *HOST_FLAGS, "-I", str(_CSRC / "host_shim"),
                                   "-o", str(tmp), str(cpp)], capture_output=True, text=True)
        finally:
            cpp.unlink(missing_ok=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{name} failed on {stem}.cu ({done.returncode}):\n{done.stderr}")
        os.replace(tmp, lib)
    return lib
