"""ctypes bindings for the port's native host runtime (libgfalign_host.so).

The C++ source is the port's own copy, gfalign_torch/native/gfalign_host.cpp:
multithreaded GFA/GAF/FASTA/FASTQ parsers, the Smith-Waterman tracebacks of
`align`, k-mer index build and anchor voting, the path-space NW walk and
its batched host scorer, and the tangle-search driver.  It is compiled
with g++ at first use into build/gfalign_torch/native/ (never the source
tree) with the flags of native/Makefile, and rebuilt when the source is
newer than the library.  A compile goes to a temporary name under a file
lock and is renamed into place, so that concurrent processes neither race
on one file nor build twice.

There is no quiet fallback: when g++ is missing or the compile fails,
`available()` and every entry point raise with the compiler's message.
The Python versions of what the library computes stay beside their
callers as oracles; tests reach them by monkeypatching `available`.
An entry point returns None only where the C++ function declines its
input (a k-mer size above 15, a parse it cannot open, a traceback whose
parity gate fails), as documented on each.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import platform
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "gfalign_host.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "gfalign_torch" / "native"
LIB_PATH = BUILD_DIR / "libgfalign_host.so"
_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def _compile_flags() -> List[str]:
    """native/Makefile's flags: x86-64-v3 (AVX2) on x86_64, plain -O3
    elsewhere."""
    arch = ["-march=x86-64-v3"] if platform.machine() == "x86_64" else []
    return ["-O3", *arch, "-std=c++17", "-fPIC", "-Wall", "-pthread"]


def build(source: pathlib.Path = SOURCE, lib: pathlib.Path = LIB_PATH) -> float:
    """Compile `source` into `lib` unless `lib` is at least as new; returns
    the seconds the compile took (0.0 when the library was up to date).
    Raises RuntimeError with the compiler's stderr when g++ is missing or
    the compile fails."""
    def fresh() -> bool:
        return lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime

    if fresh():
        return 0.0
    name = os.environ.get("CXX", "g++")
    compiler = shutil.which(name)
    if compiler is None:
        raise RuntimeError(f"the native host runtime needs a C++ compiler: "
                           f"{name} (CXX, default g++) not found on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / f".{lib.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # one compiler at a time; a dead holder releases it
        if fresh():                           # another process built it
            return 0.0
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        done = subprocess.run([compiler, *_compile_flags(), "-shared", "-o",
                               str(tmp), str(source), "-lz"],
                              capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {source} ({done.returncode}):\n"
                               f"{done.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    """The bound library, built first if needed (raises on a failed build)."""
    global _lib
    with _load_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.gfalign_set_threads.restype = None
    lib.gfalign_set_threads.argtypes = [ctypes.c_int]
    lib.gaf_open.restype = ctypes.c_void_p
    lib.gaf_open.argtypes = [ctypes.c_char_p]
    lib.gaf_count.restype = ctypes.c_int64
    lib.gaf_count.argtypes = [ctypes.c_void_p]
    lib.gaf_numeric.restype = ctypes.POINTER(ctypes.c_int64)
    lib.gaf_numeric.argtypes = [ctypes.c_void_p]
    lib.gaf_strings.restype = ctypes.c_void_p
    lib.gaf_strings.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.gaf_close.argtypes = [ctypes.c_void_p]
    lib.gaf_step_count.restype = ctypes.c_int64
    lib.gaf_step_count.argtypes = [ctypes.c_void_p]
    lib.gaf_step_ids.restype = ctypes.POINTER(ctypes.c_int32)
    lib.gaf_step_ids.argtypes = [ctypes.c_void_p]
    lib.gaf_step_orients.restype = ctypes.POINTER(ctypes.c_int8)
    lib.gaf_step_orients.argtypes = [ctypes.c_void_p]
    lib.gaf_path_offsets.restype = ctypes.POINTER(ctypes.c_int32)
    lib.gaf_path_offsets.argtypes = [ctypes.c_void_p]
    lib.gaf_dict_names.restype = ctypes.c_void_p
    lib.gaf_dict_names.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gfa_open.restype = ctypes.c_void_p
    lib.gfa_open.argtypes = [ctypes.c_char_p]
    for fn in ("gfa_seg_count", "gfa_link_count", "gfa_dict_size"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.gfa_seg_uids.restype = ctypes.POINTER(ctypes.c_int32)
    lib.gfa_seg_uids.argtypes = [ctypes.c_void_p]
    lib.gfa_seg_lens.restype = ctypes.POINTER(ctypes.c_int64)
    lib.gfa_seg_lens.argtypes = [ctypes.c_void_p]
    lib.gfa_link_ids.restype = ctypes.POINTER(ctypes.c_int32)
    lib.gfa_link_ids.argtypes = [ctypes.c_void_p]
    lib.gfa_link_orients.restype = ctypes.POINTER(ctypes.c_int8)
    lib.gfa_link_orients.argtypes = [ctypes.c_void_p]
    lib.gfa_blob.restype = ctypes.c_void_p
    lib.gfa_blob.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int64)]
    lib.gfa_close.argtypes = [ctypes.c_void_p]
    lib.fq_open.restype = ctypes.c_void_p
    lib.fq_open.argtypes = [ctypes.c_char_p]
    lib.fq_count.restype = ctypes.c_int64
    lib.fq_count.argtypes = [ctypes.c_void_p]
    lib.fq_names.restype = ctypes.c_void_p
    lib.fq_names.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fq_seq_blob.restype = ctypes.c_void_p
    lib.fq_seq_blob.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fq_close.argtypes = [ctypes.c_void_p]
    lib.seq_local_traceback.restype = ctypes.c_int64
    lib.seq_local_traceback.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64]
    lib.nw_path_traceback.restype = ctypes.c_int64
    lib.nw_path_traceback.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int64]
    lib.nw_best_scores_batch.restype = None
    lib.nw_best_scores_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.search_native.restype = ctypes.c_int32
    lib.search_native.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64)]
    lib.search_free.restype = None
    lib.search_free.argtypes = [ctypes.c_char_p]
    lib.search_profile.restype = None
    lib.search_profile.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.gfalign_free.restype = None
    lib.gfalign_free.argtypes = [ctypes.c_void_p]
    lib.anchor_votes.restype = ctypes.c_int32
    lib.anchor_votes.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    lib.seq_banded_pairs.restype = None
    lib.seq_banded_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.kmer_index_build.restype = ctypes.c_int64
    lib.kmer_index_build.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.nw_evaluate_frontier.restype = None
    lib.nw_evaluate_frontier.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    lib.seq_banded_traceback.restype = ctypes.c_int64
    lib.seq_banded_traceback.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64]


def available() -> bool:
    """True once the library is built and bound; raises when it cannot be
    built.  The dispatchers ask this before calling an entry point, so a
    test that monkeypatches it to False runs their Python versions."""
    _load()
    return True


_USER_THREADS = [0]


def set_threads(n: int) -> None:
    """Cap the native runtime's worker count (CLI -j/--threads; reference
    sizes its thread pool with it, src/main.cpp:658).  0 restores the
    default, the CPUs of the process's affinity mask."""
    _USER_THREADS[0] = int(n)
    _load().gfalign_set_threads(int(n))


def user_threads() -> int:
    """The last explicit set_threads value (0 = never set / default)."""
    return _USER_THREADS[0]


def anchor_votes(uniq: np.ndarray, csr_starts: np.ndarray,
                 sids: np.ndarray, orients: np.ndarray, offs: np.ndarray,
                 reads_codes, k: int, max_anchors: int):
    """Per-read ranked (sid, orient, diag, votes) anchors over the CSR
    k-mer postings — the native form of
    engine/seeding.anchors_with_diag_batch (bit-exact semantics; see the
    C++ docstring).  Returns (sid, orient, diag, votes, roff, dropped)
    numpy arrays (roff: n_reads + 1 offsets), or None when k > 15 or the
    index dtype is not the native int32 layout."""
    if k > 15 or uniq.dtype != np.int32:
        return None
    lib = _load()
    n_reads = len(reads_codes)
    read_off = np.zeros(n_reads + 1, np.int64)
    for i, c in enumerate(reads_codes):
        read_off[i + 1] = read_off[i] + len(c)
    blob = (np.concatenate([np.ascontiguousarray(c, np.int8)
                            for c in reads_codes])
            if n_reads and read_off[-1] else np.zeros(1, np.int8))
    uq = np.ascontiguousarray(uniq, np.int32)
    st = np.ascontiguousarray(csr_starts, np.int64)
    sd = np.ascontiguousarray(sids, np.int32)
    orc = np.ascontiguousarray(orients, np.int8)
    of = np.ascontiguousarray(offs, np.int32)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    p_sid = i32()
    p_or = i8()
    p_diag = i64()
    p_votes = i64()
    p_roff = i64()
    p_drop = i64()
    rc = lib.anchor_votes(
        uq.ctypes.data_as(i32), st.ctypes.data_as(i64), len(uq),
        sd.ctypes.data_as(i32), orc.ctypes.data_as(i8),
        of.ctypes.data_as(i32), blob.ctypes.data_as(i8),
        read_off.ctypes.data_as(i64), n_reads, k, max_anchors,
        ctypes.byref(p_sid), ctypes.byref(p_or), ctypes.byref(p_diag),
        ctypes.byref(p_votes), ctypes.byref(p_roff), ctypes.byref(p_drop))
    if rc != 0:
        return None
    try:
        roff = np.ctypeslib.as_array(p_roff, (n_reads + 1,)).copy()
        total = int(roff[-1]) if n_reads else 0
        nz = max(1, total)
        out = (np.ctypeslib.as_array(p_sid, (nz,))[:total].copy(),
               np.ctypeslib.as_array(p_or, (nz,))[:total].copy(),
               np.ctypeslib.as_array(p_diag, (nz,))[:total].copy(),
               np.ctypeslib.as_array(p_votes, (nz,))[:total].copy(),
               roff,
               np.ctypeslib.as_array(p_drop, (max(1, n_reads),))[:n_reads].copy())
    finally:
        for p in (p_sid, p_or, p_diag, p_votes, p_roff, p_drop):
            lib.gfalign_free(p)
    return out


def search_profile():
    """(total_s, eval_s, wait_s, waits) accumulated by the native search
    driver since the last call (counters reset on read).  commit/walk
    time is total - eval - wait; wait is 0 in a single-process search."""
    lib = _load()
    t = ctypes.c_double()
    e = ctypes.c_double()
    w = ctypes.c_double()
    n = ctypes.c_int64()
    lib.search_profile(ctypes.byref(t), ctypes.byref(e), ctypes.byref(w),
                       ctypes.byref(n))
    return (t.value, e.value, w.value, n.value)


def _blob_to_list(ptr: int, length: int) -> List[str]:
    if length == 0:
        return []
    raw = ctypes.string_at(ptr, length).decode("utf-8", errors="replace")
    parts = raw.split("\n")
    if parts and parts[-1] == "":
        parts.pop()
    return parts


class RaggedStrings:
    """Lazy blob-backed string column: one bytes blob plus (starts, ends)
    int64 offset arrays.  Indexing decodes a single entry; permutation and
    subsetting just index the offset arrays (zero string copies) — eagerly
    splitting a 10M-record GAF's paths column into Python strings cost
    ~10 s and a few GB, almost all of it never looked at."""

    __slots__ = ("blob", "starts", "ends")

    def __init__(self, blob: bytes, starts: np.ndarray, ends: np.ndarray):
        self.blob = blob
        self.starts = starts
        self.ends = ends

    @classmethod
    def from_blob(cls, blob: bytes, count: int) -> "RaggedStrings":
        """blob = count '\\n'-terminated lines."""
        arr = np.frombuffer(blob, np.uint8)
        nl = np.flatnonzero(arr == 10)[:count]
        starts = np.empty(count, np.int64)
        if count:
            starts[0] = 0
            starts[1:] = nl[:count - 1] + 1
        return cls(blob, starts, nl.astype(np.int64))

    @classmethod
    def from_list(cls, parts) -> "RaggedStrings":
        blob = ("\n".join(parts) + "\n").encode() if len(parts) else b""
        return cls.from_blob(blob, len(parts))

    def __len__(self) -> int:
        return len(self.starts)

    def __getitem__(self, i) -> str:
        return self.blob[self.starts[i]:self.ends[i]].decode()

    def __iter__(self):
        blob = self.blob
        for s, e in zip(self.starts, self.ends):
            yield blob[s:e].decode()

    def take(self, order) -> "RaggedStrings":
        order = np.asarray(order, np.int64)
        return RaggedStrings(self.blob, self.starts[order], self.ends[order])

    def as_bytes_array(self) -> np.ndarray:
        """Fixed-width 'S' array (NUL-padded; byte order == str order for
        UTF-8), for vectorized compare/sort."""
        n = len(self.starts)
        lens = self.ends - self.starts
        w = int(lens.max()) if n else 1
        w = max(w, 1)
        arr = np.frombuffer(self.blob, np.uint8)
        cols = np.arange(w, dtype=np.int64)
        idx = self.starts[:, None] + cols[None, :]
        np.minimum(idx, len(arr) - 1, out=idx)
        out = arr[idx]                       # one flat gather
        out[cols[None, :] >= lens[:, None]] = 0
        return np.ascontiguousarray(out).reshape(n * w).view(f"S{w}")


class GafTokens:
    """Columnar path tokens: flat dictionary ids + orientations with
    per-record offsets, plus the dictionary name list."""

    def __init__(self, step_ids, step_orients, offsets, names):
        self.step_ids = step_ids        # (total,) int32 dictionary ids
        self.step_orients = step_orients  # (total,) int8 0='+', 1='-'
        self.offsets = offsets          # (n_records+1,) int32
        self.names = names              # dictionary id -> node name

    def subset(self, order: np.ndarray) -> "GafTokens":
        """Reorder/subset records (after sort/filter) — one vectorized
        gather.  The gather index is built as a cumsum of per-step deltas
        (1 within a record, a jump at each record boundary): np.repeat
        with per-element counts cost ~40 s at 77M steps on this box,
        the delta-cumsum runs in ~2 s."""
        order = np.asarray(order, np.int64)
        lengths = np.diff(self.offsets)[order].astype(np.int64)
        new_offsets = np.zeros(len(order) + 1, dtype=np.int32)
        np.cumsum(lengths, out=new_offsets[1:])
        total = int(new_offsets[-1])
        if total == 0:
            return GafTokens(self.step_ids[:0], self.step_orients[:0],
                             new_offsets, self.names)
        nz = lengths > 0
        o_nz = self.offsets[order].astype(np.int64)[nz]
        l_nz = lengths[nz]
        pos = np.zeros(len(l_nz), np.int64)
        np.cumsum(l_nz[:-1], out=pos[1:])
        idx = np.ones(total, np.int64)
        idx[pos[0]] = o_nz[0]
        idx[pos[1:]] = o_nz[1:] - (o_nz[:-1] + l_nz[:-1]) + 1
        np.cumsum(idx, out=idx)
        return GafTokens(np.ascontiguousarray(self.step_ids)[idx],
                         np.ascontiguousarray(self.step_orients)[idx],
                         new_offsets, self.names)


class _GafHandle:
    """Owns a native GafData*; numeric/step arrays returned by parse_gaf
    are zero-copy views into it (copying the 800 MB numeric block alone
    cost ~6 s on this box), so the handle must outlive them — the views
    are tied to it via _OwnedArray."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    def __del__(self):
        try:
            self._lib.gaf_close(self._handle)
        except Exception:
            pass


class _OwnedArray(np.ndarray):
    """ndarray subclass that can carry an owner reference."""


def _view_owned(ptr, shape, owner) -> np.ndarray:
    a = np.ctypeslib.as_array(ptr, shape=shape).view(_OwnedArray)
    a._owner = owner
    return a


def parse_gaf(path: str, want_tokens: bool = False):
    """(numeric (N,10) int64, qnames, paths, tagtails[, tokens]) or None.

    numeric columns: qlen qstart qend strand plen pstart pend matches
    blocklen mapq (strand: 0='+', 1='-').  The string columns come back
    as RaggedStrings (lazy, blob-backed); numeric/step arrays are
    zero-copy views owned by the parse handle."""
    lib = _load()
    handle = lib.gaf_open(str(path).encode())
    if not handle:
        return None
    owner = _GafHandle(lib, handle)
    count = lib.gaf_count(handle)
    if count == 0:
        empty_tokens = GafTokens(np.zeros(0, np.int32), np.zeros(0, np.int8),
                                 np.zeros(1, np.int32), [])
        empty = RaggedStrings(b"", np.zeros(0, np.int64), np.zeros(0, np.int64))
        if want_tokens:
            return np.zeros((0, 10), np.int64), empty, empty, empty, empty_tokens
        return np.zeros((0, 10), np.int64), empty, empty, empty
    numeric = _view_owned(lib.gaf_numeric(handle), (count, 10), owner)
    out_len = ctypes.c_int64()

    def blob(which):
        p = lib.gaf_strings(handle, which, ctypes.byref(out_len))
        return RaggedStrings.from_blob(ctypes.string_at(p, out_len.value),
                                       count)

    qnames, paths, tails = blob(0), blob(1), blob(2)
    if not want_tokens:
        return numeric, qnames, paths, tails
    total = lib.gaf_step_count(handle)
    step_ids = _view_owned(lib.gaf_step_ids(handle), (max(total, 1),),
                           owner)[:total]
    step_orients = _view_owned(lib.gaf_step_orients(handle),
                               (max(total, 1),), owner)[:total]
    offsets = np.ctypeslib.as_array(lib.gaf_path_offsets(handle),
                                    shape=(count + 1,)).astype(np.int32)
    names = _blob_to_list(lib.gaf_dict_names(handle, ctypes.byref(out_len)),
                          out_len.value)
    tokens = GafTokens(step_ids, step_orients, offsets, names)
    return numeric, qnames, paths, tails, tokens


def parse_gfa(path: str):
    """Columnar GFA parse (threaded C++), or None when the file cannot be
    opened or inflated.

    Returns (dict_names, seg_uids, seg_lens, seg_seqs, seg_tags, link_ids,
    link_orients, link_overlaps, link_tags, other_lines): uIds follow the
    sequential parser's first-mention-in-any-record order; rare records
    (H/J/G/P/O) come back as raw lines for the Python layer."""
    lib = _load()
    handle = lib.gfa_open(str(path).encode())
    if not handle:
        return None
    try:
        ns = lib.gfa_seg_count(handle)
        nl = lib.gfa_link_count(handle)
        out_len = ctypes.c_int64()

        def blob(which):
            return _blob_to_list(lib.gfa_blob(handle, which,
                                              ctypes.byref(out_len)),
                                 out_len.value)

        seg_uids = (np.ctypeslib.as_array(lib.gfa_seg_uids(handle),
                                          shape=(ns,)).copy()
                    if ns else np.zeros(0, np.int32))
        seg_lens = (np.ctypeslib.as_array(lib.gfa_seg_lens(handle),
                                          shape=(ns,)).copy()
                    if ns else np.zeros(0, np.int64))
        link_ids = (np.ctypeslib.as_array(lib.gfa_link_ids(handle),
                                          shape=(nl, 2)).copy()
                    if nl else np.zeros((0, 2), np.int32))
        link_orients = (np.ctypeslib.as_array(lib.gfa_link_orients(handle),
                                              shape=(nl, 2)).copy()
                        if nl else np.zeros((0, 2), np.int8))
        return (blob(5), seg_uids, seg_lens, blob(0), blob(1), link_ids,
                link_orients, blob(2), blob(3), blob(4))
    finally:
        lib.gfa_close(handle)


def local_traceback(read_codes: np.ndarray, path_codes: np.ndarray,
                    end_i: int, end_j: int, match: int, mismatch: int,
                    gap: int, pad: int, block: int):
    """(score, qstart, pstart, matches, nm, ops_str) or None.

    Exact-semantics C++ port of ops/seqalign.traceback's matrix + walk
    (see seq_local_traceback in native/gfalign_host.cpp)."""
    lib = _load()
    rd = np.ascontiguousarray(read_codes, dtype=np.int8)
    pt = np.ascontiguousarray(path_codes, dtype=np.int8)
    ops_cap = int(end_i) + int(end_j) + 2
    ops = ctypes.create_string_buffer(ops_cap)
    out5 = (ctypes.c_int32 * 5)()
    n_ops = lib.seq_local_traceback(
        rd.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(rd),
        pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(pt),
        int(end_i), int(end_j), match, mismatch, gap, pad, block,
        out5, ops, ops_cap)
    if n_ops < 0:
        return None
    return (int(out5[0]), int(out5[1]), int(out5[2]), int(out5[3]),
            int(out5[4]), ops.raw[:n_ops].decode())


def nw_path_walk(a_keys: np.ndarray, b_keys: np.ndarray,
                 match: int = 0, mismatch: int = -1, gap: int = -1):
    """(walk-recomputed score, ops string) for the path-space NW alignment
    (reference src/alignments.cpp:499-554 semantics; ops 'M'/'U'/'L'), or
    None when the walk fails."""
    lib = _load()
    ak = np.ascontiguousarray(a_keys, dtype=np.int64)
    bk = np.ascontiguousarray(b_keys, dtype=np.int64)
    ops_cap = len(ak) + len(bk) + 2
    ops = ctypes.create_string_buffer(ops_cap)
    score = ctypes.c_int64()
    n_ops = lib.nw_path_traceback(
        ak.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ak),
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(bk),
        match, mismatch, gap, ctypes.byref(score), ops, ops_cap)
    if n_ops < 0:
        return None
    return int(score.value), ops.raw[:n_ops].decode()


def nw_best_scores_batch(a_keys: np.ndarray, a_len: np.ndarray,
                         b_keys: np.ndarray, b_len: np.ndarray,
                         match: int = 0, mismatch: int = -1,
                         gap: int = -1, with_rc: bool = True):
    """(C, R) best-of-{fw, rc} walk-recomputed path-space NW scores on the
    host (CPU fast path for the search engine's frontier scoring — exact
    vs nw_align_oracle and the K1/K2 path).  a_keys (C, n) / b_keys (R, m) use
    the id*4+orient int32 key encoding; lengths bound each row."""
    lib = _load()
    ak = np.ascontiguousarray(a_keys, dtype=np.int32)
    al = np.ascontiguousarray(a_len, dtype=np.int32)
    bk = np.ascontiguousarray(b_keys, dtype=np.int32)
    bl = np.ascontiguousarray(b_len, dtype=np.int32)
    C = ak.shape[0]
    R = bk.shape[0]
    out = np.empty((C, R), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nw_best_scores_batch(
        ak.ctypes.data_as(i32p), al.ctypes.data_as(i32p),
        C, ak.shape[1] if ak.ndim == 2 else 0,
        bk.ctypes.data_as(i32p), bl.ctypes.data_as(i32p),
        R, bk.shape[1] if bk.ndim == 2 else 0,
        match, mismatch, gap, 1 if with_rc else 0,
        out.ctypes.data_as(i32p))
    return out


def native_search(adj_off, adj_nid, adj_or0, adj_or1, n_segments, budget,
                  rec_uids, rec_counts, node_count, source_uid, dest_uid,
                  b_keys, b_len, max_steps, min_nodes, return_all,
                  spec_depth, speculate, name_blob: bytes, name_off):
    """Run the native tangle-search driver in this process alone; returns
    the output bytes, or None when the driver declines.  Arrays follow
    engine/search.py's encodings (orientation codes 0/1/2; read keys
    id*4+orient).  The C function's frontier-sharded mode (pid, nproc and
    the shared-memory tally ring) is not bound here."""
    lib = _load()
    i32 = ctypes.POINTER(ctypes.c_int32)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    # keep arrays alive across the call
    keep = [np.ascontiguousarray(a, np.int32) for a in
            (adj_off, adj_nid, budget, rec_uids, rec_counts, b_keys, b_len)]
    ko0 = np.ascontiguousarray(adj_or0, np.int8)
    ko1 = np.ascontiguousarray(adj_or1, np.int8)
    koff = np.ascontiguousarray(name_off, np.int64)
    out_text = ctypes.c_char_p()
    out_len = ctypes.c_int64()
    bk = keep[5]
    rc = lib.search_native(
        keep[0].ctypes.data_as(i32), keep[1].ctypes.data_as(i32),
        ko0.ctypes.data_as(i8), ko1.ctypes.data_as(i8),
        int(n_segments), keep[2].ctypes.data_as(i32),
        keep[3].ctypes.data_as(i32), keep[4].ctypes.data_as(i32),
        len(keep[3]), int(node_count), int(source_uid), int(dest_uid),
        bk.ctypes.data_as(i32), keep[6].ctypes.data_as(i32),
        bk.shape[0], bk.shape[1] if bk.ndim == 2 else 0,
        0, -1, -1, int(max_steps), int(min_nodes),
        1 if return_all else 0, int(spec_depth), int(speculate),
        name_blob, koff.ctypes.data_as(i64),
        0, 1, ctypes.c_void_p(None), 0, 0, 0,
        ctypes.byref(out_text), ctypes.byref(out_len))
    if rc != 0:
        return None
    text = ctypes.string_at(out_text, out_len.value)
    lib.search_free(out_text)
    return text


def seq_banded_pairs(reads_blob: np.ndarray, read_off: np.ndarray,
                     read_len: np.ndarray, paths_blob: np.ndarray,
                     path_off: np.ndarray, path_len: np.ndarray,
                     rid: np.ndarray, pid: np.ndarray, deltas: np.ndarray,
                     width: int, match: int, mismatch: int, gap: int,
                     pad_code: int, block: int):
    """(best, bi, bj, edge) banded local scores for pairs
    (rid[n], pid[n]) at band `width` around deltas[n] — bit-exact vs
    ops/seqalign._banded_forward."""
    lib = _load()
    rb = np.ascontiguousarray(reads_blob, np.int8)
    pb = np.ascontiguousarray(paths_blob, np.int8)
    ro = np.ascontiguousarray(read_off, np.int64)
    rl = np.ascontiguousarray(read_len, np.int64)
    po = np.ascontiguousarray(path_off, np.int64)
    pl = np.ascontiguousarray(path_len, np.int64)
    ri = np.ascontiguousarray(rid, np.int32)
    pi = np.ascontiguousarray(pid, np.int32)
    dl = np.ascontiguousarray(deltas, np.int32)
    n = len(ri)
    best = np.empty(n, np.int32)
    bi = np.empty(n, np.int32)
    bj = np.empty(n, np.int32)
    edge = np.empty(n, np.uint8)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.seq_banded_pairs(
        rb.ctypes.data_as(i8), ro.ctypes.data_as(i64),
        rl.ctypes.data_as(i64),
        pb.ctypes.data_as(i8), po.ctypes.data_as(i64),
        pl.ctypes.data_as(i64),
        ri.ctypes.data_as(i32), pi.ctypes.data_as(i32),
        dl.ctypes.data_as(i32), n, width, match, mismatch, gap,
        pad_code, block,
        best.ctypes.data_as(i32), bi.ctypes.data_as(i32),
        bj.ctypes.data_as(i32),
        edge.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return best, bi, bj, edge.astype(bool)


def kmer_index_build(codes: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray, k: int, sample_thresh: int = 0):
    """(kmers, blks, offs) int32 postings sorted stably by k-mer code, or
    None when k > 15.  codes: concatenated int8 base codes;
    starts/lens delimit the oriented-segment blocks."""
    if k > 15:
        return None
    lib = _load()
    cd = np.ascontiguousarray(codes, np.int8)
    st = np.ascontiguousarray(starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    i8 = ctypes.POINTER(ctypes.c_int8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n_blocks = len(st)
    total = lib.kmer_index_build(
        cd.ctypes.data_as(i8), len(cd), st.ctypes.data_as(i64),
        ln.ctypes.data_as(i64), n_blocks, k, sample_thresh,
        None, None, None)
    if total < 0:
        return None
    kmers = np.empty(total, np.int32)
    blks = np.empty(total, np.int32)
    offs = np.empty(total, np.int32)
    got = lib.kmer_index_build(
        cd.ctypes.data_as(i8), len(cd), st.ctypes.data_as(i64),
        ln.ctypes.data_as(i64), n_blocks, k, sample_thresh,
        kmers.ctypes.data_as(i32), blks.ctypes.data_as(i32),
        offs.ctypes.data_as(i32))
    if got != total:
        return None
    return kmers, blks, offs


def nw_evaluate_frontier(a_keys: np.ndarray, a_len: np.ndarray,
                         b_keys: np.ndarray, b_len: np.ndarray,
                         filter_alignments: bool = True,
                         match: int = 0, mismatch: int = -1,
                         gap: int = -1):
    """(C, 3) int64 [bad, good, unaligned] per candidate — fused
    filter + fw/rc scoring + tally (reference evaluatePath semantics,
    src/eval.cpp:63-108)."""
    lib = _load()
    ak = np.ascontiguousarray(a_keys, dtype=np.int32)
    al = np.ascontiguousarray(a_len, dtype=np.int32)
    bk = np.ascontiguousarray(b_keys, dtype=np.int32)
    bl = np.ascontiguousarray(b_len, dtype=np.int32)
    C = ak.shape[0]
    R = bk.shape[0]
    out = np.empty((C, 3), dtype=np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nw_evaluate_frontier(
        ak.ctypes.data_as(i32p), al.ctypes.data_as(i32p),
        C, ak.shape[1] if ak.ndim == 2 else 0,
        bk.ctypes.data_as(i32p), bl.ctypes.data_as(i32p),
        R, bk.shape[1] if bk.ndim == 2 else 0,
        match, mismatch, gap, 1 if filter_alignments else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def banded_local_traceback(read_codes: np.ndarray, path_codes: np.ndarray,
                           end_i: int, end_j: int, delta: int, width: int,
                           expected: int, match: int, mismatch: int,
                           gap: int, pad: int, block: int):
    """Banded traceback with parity gates (seq_banded_traceback).

    Returns (score, qstart, pstart, matches, nm, ops_str), or None when a
    parity gate failed (banded end value != expected device score / walk
    touched the band edge) — the caller falls back to the full-matrix
    traceback."""
    lib = _load()
    rd = np.ascontiguousarray(read_codes, dtype=np.int8)
    pt = np.ascontiguousarray(path_codes, dtype=np.int8)
    ops_cap = int(end_i) + int(end_j) + 2
    ops = ctypes.create_string_buffer(ops_cap)
    out5 = (ctypes.c_int32 * 5)()
    n_ops = lib.seq_banded_traceback(
        rd.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(rd),
        pt.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(pt),
        int(end_i), int(end_j), int(delta), int(width), int(expected),
        match, mismatch, gap, pad, block, out5, ops, ops_cap)
    if n_ops < 0:
        return None
    return (int(out5[0]), int(out5[1]), int(out5[2]), int(out5[3]),
            int(out5[4]), ops.raw[:n_ops].decode())


def parse_fastx(path: str) -> Optional[List[Tuple[str, str]]]:
    lib = _load()
    handle = lib.fq_open(str(path).encode())
    if not handle:
        return None
    try:
        out_len = ctypes.c_int64()
        names = _blob_to_list(lib.fq_names(handle, ctypes.byref(out_len)),
                              out_len.value)
        seqs = _blob_to_list(lib.fq_seq_blob(handle, ctypes.byref(out_len)),
                             out_len.value)
        if len(names) != len(seqs):
            return None
        return list(zip(names, seqs))
    finally:
        lib.fq_close(handle)
