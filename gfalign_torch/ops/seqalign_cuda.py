"""CUDA kernels K3, K4 and K5 of the align-mode scorer, and the exact
full-matrix traceback (csrc/seqalign.cu).

K3 (`sa_banded_fwd`) replaces gfalign_tpu/ops/seqalign_pallas.py
`_banded_kernel_factory` together with the strip assembly in front of it;
K4 (`sa_pairs_fwd`, read i against path i) and K5 (`sa_local_fwd`, every
read against every path) replace `_kernel_factory`.  The walk (`sa_walk`:
the walk codes of one pair's rectangle, then the walk over them) replaces
no TPU kernel: the JAX package walks on the host.  The wrappers check
device, dtype, shape and contiguity, launch on PyTorch's current stream
without synchronising, and count their launches in `LAUNCHES` (the
registry's counters kernels.seqalign.<kernel>).  They never
fall back to the plain versions of ops/seqalign.py: a CUDA tensor launches a
kernel or raises.  The launch geometry is chosen by the small pure
functions `banded_layout`, `pairs_layout` and `walk_layout`, which run
anywhere; the `_launch_*` functions take the library as an argument, so
that the host build of the source (cuda_build.build_host) runs them on
CPU tensors.

The library is built at first use with nvcc into build/gfalign_torch/ by
ops/cuda_build.py, whose `build("seqalign")` does it explicitly and returns
nvcc's register/spill report.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build

SCRATCH_BYTES = 1 << 30   # K4 workspace / K5 strip hand-over per launch
HOST_SMS = 132            # SMs assumed by the host build (an H100's count)
GROUP_MAX = 32            # K3 threads a pair in the group kernel (one warp)
WALK_K = 8                # columns a thread of the walk's forward kernel
WALK_FWD_THREADS = 64     # threads a block of the walk's forward kernel
WALK_HEAD = 8             # int32 words of the walk's result before its ops

LAUNCHES = profiling.view(profiling.COUNTS, "kernels.seqalign.",
                         ("banded", "pairs", "cross", "walk"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of csrc/seqalign.cu on a loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sa_banded_rows.argtypes = [vp, ci, ci, vp, vp, ci, vp]
    lib.sa_banded_fwd.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp, ci, ci,
                                  vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sa_local_strip.argtypes = [ci]
    lib.sa_local_fwd.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp, vp]
    lib.sa_pairs_workspace.argtypes = [ci, ci, ci]
    lib.sa_pairs_workspace.restype = ctypes.c_longlong
    lib.sa_pairs_fwd.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, vp]
    lib.sa_walk_workspace.argtypes = [ci, ci]
    lib.sa_walk_workspace.restype = ctypes.c_longlong
    lib.sa_walk.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci, vp]
    for fn in (lib.sa_banded_rows, lib.sa_banded_fwd,
               lib.sa_local_strip, lib.sa_local_fwd, lib.sa_pairs_fwd,
               lib.sa_walk, lib.sa_walk_k, lib.sa_walk_head):
        fn.restype = ci
    if (lib.sa_walk_k(), lib.sa_walk_head()) != (WALK_K, WALK_HEAD):
        raise RuntimeError(f"the walk kernel's layout (WALK_K, WALK_HEAD) = "
                           f"{(lib.sa_walk_k(), lib.sa_walk_head())} differs "
                           f"from this module's {(WALK_K, WALK_HEAD)}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(cuda_build.load("seqalign"))


def banded_layout(width: int) -> Tuple[int, int]:
    """(lanes a thread, threads a pair) of K3 for a band of `width` lanes.
    A multiple of 16 up to 512 fits in one warp and takes the group kernel:
    G threads of 16 lanes a pair, G the power of two that covers the band,
    32 / G pairs a warp.  Other widths take the block-per-pair kernel
    (threads 0): 16 lanes a thread for multiples of 16 up to 8192, else 4
    for multiples of 4 up to 2048.  Raises for a width that no kernel
    serves."""
    if width >= 16 and width % 16 == 0:
        if width <= GROUP_MAX * 16:
            return 16, 1 << (width // 16 - 1).bit_length()
        if width <= 16 * 512:
            return 16, 0
    if width >= 4 and width % 4 == 0 and width <= 4 * 512:
        return 4, 0
    raise ValueError(f"band width {width} is not served by the CUDA kernel "
                     "(a multiple of 4 up to 2048, or of 16 up to 8192)")


def pairs_layout(lp: int, pairs: int, sms: int) -> Tuple[int, int, int]:
    """(columns a thread K, threads a block T, blocks a pair) of K4 for
    `pairs` paths of lp columns on a card of `sms` SMs.  A pair's columns
    are split over as many blocks as keep the launch to one block an SM
    (a dozen pairs still fill the card, many pairs take a block each and
    skip the hand-over between blocks), each block at least 4 warps of 8
    columns a thread, and at most 512 threads of 8 or 16 columns."""
    parts = max(1, min(-(-lp // 1024), sms // pairs))
    cols = -(-lp // parts)
    K = 8 if cols <= 8 * 512 else 16
    T = min(512, 32 * -(-cols // (32 * K)))
    return K, T, -(-lp // (K * T))


def walk_layout(cols: int) -> Tuple[int, int]:
    """(threads a block T, blocks) of the walk's forward kernel over `cols`
    columns: two warps a block of WALK_K columns a thread, 512 columns a
    block (the fastest of 4, 8 or 16 columns a thread and one to four warps
    a block at clr.align's sizes, PERF.md section 6)."""
    return WALK_FWD_THREADS, max(1, -(-cols // (WALK_K * WALK_FWD_THREADS)))


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors")
    return t.device


def _launch_banded(lib, arena, cum_off, base_ptr, plen, read_pool, read_idx,
                   path_idx, deltas, width: int, stream) -> torch.Tensor:
    """K3 on checked tensors of any one device (N > 0): each pair's live
    rows (sa_banded_rows), the pairs sorted longest first, then the scores,
    (4, N) int32 in the caller's order."""
    lanes, group = banded_layout(width)
    N = read_idx.shape[0]
    (R, lr), (P, S) = read_pool.shape, cum_off.shape
    device = read_idx.device
    rows = torch.empty((N,), dtype=torch.int32, device=device)
    err = lib.sa_banded_rows(read_pool.data_ptr(), R, lr, read_idx.data_ptr(),
                             rows.data_ptr(), N, stream)
    if err != 0:
        raise RuntimeError(f"sa_banded_rows launch failed: cudaError {err} (N={N})")
    order = torch.argsort(rows, descending=True, stable=True).to(torch.int32)
    out = torch.empty((4, N), dtype=torch.int32, device=device)
    err = lib.sa_banded_fwd(arena.data_ptr(), arena.numel(), cum_off.data_ptr(),
                            base_ptr.data_ptr(), plen.data_ptr(), P, S,
                            read_pool.data_ptr(), R, lr, read_idx.data_ptr(),
                            path_idx.data_ptr(), deltas.data_ptr(),
                            order.data_ptr(), rows.data_ptr(), out.data_ptr(),
                            N, int(width), lanes, group, stream)
    if err != 0:
        raise RuntimeError(f"sa_banded_fwd launch failed: cudaError {err} "
                           f"(N={N}, lr={lr}, width={width}, S={S}, "
                           f"lanes={lanes}, group={group})")
    profiling.count("kernels.seqalign.banded")
    return out


def banded_arena_scores_cuda(arena, cum_off, base_ptr, plen, read_pool,
                             read_idx, path_idx, deltas, width: int):
    """(best, bi, bj, edge) of N banded pairs, each (N,) on the device (int32
    and a bool flag): pair n aligns read_pool[read_idx[n]] against the path
    registered in row path_idx[n] of the step tables, in a band of `width`
    lanes around diagonal deltas[n].

    arena (A,) int8; cum_off, base_ptr (P, S) int32 (cum_off rows
    non-decreasing, padded with INT32_MAX); plen (P,) int32; read_pool
    (R, lr) int8; read_idx, path_idx, deltas (N,) int32; all contiguous on
    one CUDA device.  Indices clamp into their pools."""
    device = _cuda_device(arena, "banded_arena_scores_cuda")
    _check("arena", arena, torch.int8, 1, device)
    _check("cum_off", cum_off, torch.int32, 2, device)
    _check("base_ptr", base_ptr, torch.int32, 2, device)
    _check("plen", plen, torch.int32, 1, device)
    _check("read_pool", read_pool, torch.int8, 2, device)
    _check("read_idx", read_idx, torch.int32, 1, device)
    _check("path_idx", path_idx, torch.int32, 1, device)
    _check("deltas", deltas, torch.int32, 1, device)
    P, S = cum_off.shape
    if tuple(base_ptr.shape) != (P, S) or tuple(plen.shape) != (P,):
        raise ValueError("cum_off, base_ptr and plen disagree on their shapes")
    N = read_idx.shape[0]
    if tuple(path_idx.shape) != (N,) or tuple(deltas.shape) != (N,):
        raise ValueError("read_idx, path_idx and deltas disagree on N")
    R, lr = read_pool.shape
    banded_layout(int(width))          # raises for a width no kernel serves
    if N == 0:
        out = torch.empty((4, 0), dtype=torch.int32, device=device)
        return out[0], out[1], out[2], out[3].bool()
    if arena.numel() == 0 or P == 0 or S == 0 or R == 0 or lr == 0:
        raise ValueError("banded_arena_scores_cuda needs non-empty pools")
    stream = torch.cuda.current_stream(device).cuda_stream
    out = _launch_banded(_lib(), arena, cum_off, base_ptr, plen, read_pool,
                         read_idx, path_idx, deltas, int(width), stream)
    return out[0], out[1], out[2], out[3].bool()


def _launch_pairs(lib, read_codes, path_codes, stream) -> torch.Tensor:
    """K4 on checked (N, lr) and (N, lp) codes of any one device (all
    dimensions > 0): (3, N) int32.  Pairs are launched in chunks whose
    workspace stays within SCRATCH_BYTES."""
    (N, lr), lp = read_codes.shape, path_codes.shape[1]
    device = read_codes.device
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else HOST_SMS)
    K, T, parts = pairs_layout(lp, N, sms)
    per_pair = 4 * (lib.sa_pairs_workspace(2, lr, parts)
                    - lib.sa_pairs_workspace(1, lr, parts))
    step = max(1, min(N, SCRATCH_BYTES // per_pair))
    work = torch.empty((lib.sa_pairs_workspace(step, lr, parts),),
                       dtype=torch.int32, device=read_codes.device)
    out = torch.empty((3, N), dtype=torch.int32, device=read_codes.device)
    for r0 in range(0, N, step):
        n = min(step, N - r0)
        part = out if n == N else torch.empty((3, n), dtype=torch.int32,
                                              device=read_codes.device)
        err = lib.sa_pairs_fwd(read_codes[r0].data_ptr(), n, lr,
                               path_codes[r0].data_ptr(), lp, part.data_ptr(),
                               work.data_ptr(), K, T, parts, stream)
        if err != 0:
            raise RuntimeError(f"sa_pairs_fwd launch failed: cudaError {err} "
                               f"(N={n}, lr={lr}, lp={lp}, K={K}, T={T}, "
                               f"parts={parts})")
        profiling.count("kernels.seqalign.pairs")
        if part is not out:
            out[:, r0:r0 + n] = part
    return out


def _launch_cross(lib, read_codes, path_codes, stream) -> torch.Tensor:
    """K5 on checked codes of any one device (all dimensions > 0): every
    read against every path, (3, R, P).  A path wider than one strip of
    columns hands columns on through scratch planes (2 x R x P x lr int32);
    reads are chunked to bound them."""
    R, lr = read_codes.shape
    P, lp = path_codes.shape
    device = read_codes.device
    out = torch.empty((3, R, P), dtype=torch.int32, device=device)
    step, scratch = R, None
    if lp > lib.sa_local_strip(lp):
        per_read = 2 * P * lr * 4
        step = max(1, min(R, SCRATCH_BYTES // per_read))
        scratch = torch.empty(step * per_read // 4, dtype=torch.int32, device=device)
    for r0 in range(0, R, step):
        n = min(step, R - r0)
        # one launch writes (3, n, P); a chunk of the reads gets its own
        # buffer so that the three planes stay contiguous
        part = out if n == R else torch.empty((3, n, P), dtype=torch.int32,
                                              device=device)
        err = lib.sa_local_fwd(read_codes[r0:r0 + n].data_ptr(), n, lr,
                               path_codes.data_ptr(), P, lp, part.data_ptr(),
                               None if scratch is None else scratch.data_ptr(),
                               stream)
        if err != 0:
            raise RuntimeError(f"sa_local_fwd launch failed: cudaError {err} "
                               f"(R={n}, P={P}, lr={lr}, lp={lp})")
        profiling.count("kernels.seqalign.cross")
        if part is not out:
            out[:, r0:r0 + n] = part
    return out


def local_forward_cuda(read_codes, path_codes, pairwise: bool):
    """(best, bi, bj) of the full local alignment, int32 on the device:
    pairwise, read i against path i, each (N,) (K4); otherwise every read
    against every path, each (R, P) (K5).

    read_codes (R, lr) int8 and path_codes (P, lp) int8, contiguous on one
    CUDA device."""
    device = _cuda_device(read_codes, "local_forward_cuda")
    _check("read_codes", read_codes, torch.int8, 2, device)
    _check("path_codes", path_codes, torch.int8, 2, device)
    R, lr = read_codes.shape
    P, lp = path_codes.shape
    if pairwise and P != R:
        raise ValueError(f"pairwise scoring needs as many paths as reads, "
                         f"got {R} and {P}")
    shape = (R,) if pairwise else (R, P)
    if R == 0 or P == 0 or lr == 0 or lp == 0:
        zero = torch.zeros(shape, dtype=torch.int32, device=device)
        return zero, zero.clone(), zero.clone()
    if not pairwise and P > 65535:
        raise ValueError(f"cross-product scoring takes at most 65535 paths, got {P}")
    stream = torch.cuda.current_stream(device).cuda_stream
    if pairwise:
        out = _launch_pairs(_lib(), read_codes, path_codes, stream)
    else:
        out = _launch_cross(_lib(), read_codes, path_codes, stream)
    return out[0], out[1], out[2]


def _launch_walk(lib, read_codes, path_codes, stream):
    """The walk (sa_walk) on checked (rows,) and (cols,) codes of any one
    device, from their last cell: its result words, (WALK_HEAD + (rows +
    cols + 3) // 4,) int32 (walk_result reads them), and its walk codes
    (walk_codes reads them), both on that device.  Every buffer is
    allocated here: the codes (cells / 4 bytes), the hand-over columns and
    the result."""
    rows, cols = read_codes.shape[0], path_codes.shape[0]
    device = read_codes.device
    T, parts = walk_layout(cols)
    codes = torch.empty((parts * T * rows,), dtype=torch.int16, device=device)
    work = torch.empty((lib.sa_walk_workspace(rows, parts),),
                       dtype=torch.int32, device=device)
    out = torch.empty((WALK_HEAD + (rows + cols + 3) // 4,), dtype=torch.int32,
                      device=device)
    err = lib.sa_walk(read_codes.data_ptr(), rows, path_codes.data_ptr(), cols,
                      codes.data_ptr(), work.data_ptr(), out.data_ptr(), T,
                      parts, stream)
    if err != 0:
        raise RuntimeError(f"sa_walk launch failed: cudaError {err} "
                           f"(rows={rows}, cols={cols}, T={T}, parts={parts})")
    profiling.count("kernels.seqalign.walk")
    return out, codes


def walk_result(out: torch.Tensor, rows: int, cols: int):
    """(score, qstart, pstart, matches, nm, ops) from the walk's result
    words `out` on the host, for a rectangle of rows x cols."""
    words = out.numpy()
    score, qstart, pstart, matches, nm, n = (int(x) for x in words[:6])
    ops = words[WALK_HEAD:].view(np.uint8)[rows + cols - n:rows + cols]
    return score, qstart, pstart, matches, nm, ops.tobytes().decode()


def walk_codes(codes: torch.Tensor, rows: int, cols: int) -> np.ndarray:
    """The moves of a walk's code words `codes` on the host (_launch_walk's,
    rows x cols cells) as a (rows, cols) uint8 array laid out as
    seqalign.walk_codes_ref's codes[1:, 1:]: 0 stop, 1 diagonal, 2 up,
    3 left.  For checks: the walk reads the words where they are."""
    if rows == 0 or cols == 0:
        return np.zeros((rows, cols), np.uint8)
    words = codes.numpy().view(np.uint16).reshape(-1, rows)[:-(-cols // WALK_K)]
    shifts = 2 * np.arange(WALK_K, dtype=np.uint16)
    moves = (words.T[:, :, None] >> shifts) & 3
    return moves.reshape(rows, -1)[:, :cols].astype(np.uint8)


def full_walk_cuda(read_codes, path_codes):
    """(score, qstart, pstart, matches, nm, ops) of the exact full-matrix
    traceback of read_codes (rows,) against path_codes (cols,), int8 and
    contiguous on one CUDA device, from the rectangle's last cell
    (rows, cols): one sa_walk launch and one copy to the host, which waits
    for it."""
    device = _cuda_device(read_codes, "full_walk_cuda")
    _check("read_codes", read_codes, torch.int8, 1, device)
    _check("path_codes", path_codes, torch.int8, 1, device)
    rows, cols = read_codes.shape[0], path_codes.shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    out, _ = _launch_walk(_lib(), read_codes, path_codes, stream)
    return walk_result(out.cpu(), rows, cols)
