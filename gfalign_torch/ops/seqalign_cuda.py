"""CUDA kernels K3, K4 and K5 of the align-mode scorer, and the exact
full-matrix traceback (csrc/seqalign.cu).

K3 (`sa_banded_fwd`) replaces gfalign_tpu/ops/seqalign_pallas.py
`_banded_kernel_factory` together with the strip assembly in front of it;
K4 (`sa_pairs_fwd`, read i against path i) and K5 (`sa_local_fwd`, every
read against every path) replace `_kernel_factory`.  The walk (`sa_walk`:
the walk codes of one pair's rectangle, then the walk over them; for a
large rectangle `sa_walk_rows`, `sa_walk_tiles` and `sa_walk_trace`, the
same walk in row blocks) and the banded walk (`sa_bandtrace`: the banded
tracebacks of a wave of pairs, their band's move codes and then each walk
over them) replace no TPU kernel: the JAX package walks on the host.  The
wrappers check
device, dtype, shape and contiguity, launch on PyTorch's current stream
without synchronising, and count their launches in `LAUNCHES` (the
registry's counters kernels.seqalign.<kernel>).  They never
fall back to the plain versions of ops/seqalign.py: a CUDA tensor launches a
kernel or raises.  The launch geometry is chosen by the small pure
functions `banded_layout`, `pairs_layout`, `walk_layout`, `walk_plan`
and `bandtrace_layout`, which run anywhere; the `_launch_*` functions take the
library as an argument, so that the host build of the source
(cuda_build.build_host) runs them on CPU tensors.

The library is built at first use with nvcc into build/gfalign_torch/ by
ops/cuda_build.py, whose `build("seqalign")` does it explicitly and returns
nvcc's register/spill report.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build
from .seqalign import PAD, walk_gaps

SCRATCH_BYTES = 1 << 30   # K4 workspace / K5 strip hand-over per launch
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may take (sm_90)
HOST_SMS = 132            # SMs assumed by the host build (an H100's count)
GROUP_MAX = 32            # K3 threads a pair in the group kernel (one warp)
WALK_K = 8                # columns a thread of the walk's forward kernel
WALK_FWD_THREADS = 64     # threads a block of the walk's forward kernel
WALK_HEAD = 8             # int32 words of the walk's result before its ops
WALK_TILE_WORDS = 6       # int64 words of a tile of the walk
WALK_BAND_ROWS = 1024     # rows of a row block of the walk's band, at most


# Device bytes of walk codes that one tile or one whole-width row block of
# the walk may hold.  walk_plan and walk_band size the rest from it: the
# boundary rows within 5/4 of it, the forward pass's hand-over columns
# within 3/4, the band's codes within 7/4.  The default walks clr.align's
# largest rectangle (0.84 G cells) as one tile and keeps a walk of
# 300 k x 600 k cells under 1 GiB.
WALK_BUDGET = 256 << 20

# The banded walk's launch layout (csrc/seqalign.cu, checked against the
# library in _bind): int64 words of a walk in a launch's table, int32 words
# of a block in it, int32 words of a walk's result before its ops, threads
# of a block of the forward pass, and the widest band it takes.
BT_TABLE_WORDS = 16
BT_BLOCK_WORDS = 4
BT_HEAD = 8
BT_THREADS = 128
BT_MAX_WIDTH = 8192

# Device bytes of band codes (2 bits a cell) that one banded-walk launch
# may hold.  A wave whose codes pass it runs as several launches, its
# longest walks first, and a walk whose codes alone pass it as a launch of
# its own; ont_r10.align's largest walk (201.6 k rows at band 2,048) holds
# 103 MB.  On an H100, 128 MiB aligned as many reads a second as 512 MiB
# in the align cells, at 193 MB of peak device memory in hifi.align
# against 516 MB (PERF.md).
BANDTRACE_BUDGET = 128 << 20

LAUNCHES = profiling.view(profiling.COUNTS, "kernels.seqalign.",
                         ("banded", "pairs", "cross", "walk", "bandtrace"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of csrc/seqalign.cu on a loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sa_banded_rows.argtypes = [vp, ci, ci, vp, vp, ci, vp]
    lib.sa_banded_fwd.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp, ci, ci,
                                  vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                  vp]
    lib.sa_local_strip.argtypes = [ci]
    lib.sa_local_fwd.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp, vp]
    lib.sa_pairs_workspace.argtypes = [ci, ci, ci]
    lib.sa_pairs_workspace.restype = ctypes.c_longlong
    lib.sa_pairs_fwd.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, ci, ci, vp]
    ll = ctypes.c_longlong
    lib.sa_walk_workspace.argtypes = [ci, ci]
    lib.sa_walk_workspace.restype = ll
    lib.sa_walk.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci, vp]
    lib.sa_walk_rows.argtypes = [vp, ci, vp, ci, ci, ci, vp, ll, vp, vp, ci,
                                 ci, vp]
    lib.sa_walk_tiles.argtypes = [vp, vp, vp, ci, ci, vp, ll, vp, vp, ci, ci,
                                  vp]
    lib.sa_walk_trace.argtypes = [vp, vp, ci, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sa_bandtrace.argtypes = [vp, vp, ci, vp, ci, vp, vp, ci, vp]
    for fn in (lib.sa_banded_rows, lib.sa_banded_fwd,
               lib.sa_local_strip, lib.sa_local_fwd, lib.sa_pairs_fwd,
               lib.sa_walk, lib.sa_walk_rows, lib.sa_walk_tiles,
               lib.sa_walk_trace, lib.sa_walk_k, lib.sa_walk_head,
               lib.sa_walk_tile_words, lib.sa_bandtrace,
               lib.sa_bandtrace_table_words, lib.sa_bandtrace_block_words,
               lib.sa_bandtrace_head):
        fn.restype = ci
    got = (lib.sa_walk_k(), lib.sa_walk_head(), lib.sa_walk_tile_words())
    if got != (WALK_K, WALK_HEAD, WALK_TILE_WORDS):
        raise RuntimeError(f"the walk kernel's layout (WALK_K, WALK_HEAD, "
                           f"WALK_TILE_WORDS) = {got} differs from this "
                           f"module's {(WALK_K, WALK_HEAD, WALK_TILE_WORDS)}")
    got = (lib.sa_bandtrace_table_words(), lib.sa_bandtrace_block_words(),
           lib.sa_bandtrace_head())
    if got != (BT_TABLE_WORDS, BT_BLOCK_WORDS, BT_HEAD):
        raise RuntimeError(f"the banded walk's layout (BT_TABLE_WORDS, "
                           f"BT_BLOCK_WORDS, BT_HEAD) = {got} differs from "
                           f"this module's "
                           f"{(BT_TABLE_WORDS, BT_BLOCK_WORDS, BT_HEAD)}")
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


def walk_layout(cols: int, threads: int = WALK_FWD_THREADS) -> Tuple[int, int]:
    """(threads a block T, blocks) of the walk's forward kernel over `cols`
    columns: by default two warps a block of WALK_K columns a thread, 512
    columns a block (the fastest of 4, 8 or 16 columns a thread and one to
    four warps a block at clr.align's sizes, PERF.md section 6)."""
    return threads, max(1, -(-cols // (WALK_K * threads)))


def walk_groups(cols: int) -> int:
    """Column groups of WALK_K columns over `cols` columns."""
    return -(-cols // WALK_K)


class WalkPlan(NamedTuple):
    """How a walk of rows x cols cells runs (walk_plan)."""
    whole: bool        # one tile: codes of the whole rectangle
    every: int         # rows of a row block (boundary rows every `every`)
    rows_threads: int  # threads a block of the forward pass
    block_rows: int    # rows of a whole-width row block (a multiple of every)


def walk_plan(rows: int, cols: int, budget: int = WALK_BUDGET) -> WalkPlan:
    """The walk's sizes for a rectangle of rows x cols cells under
    `budget` (WALK_BUDGET): one tile when its codes fit the budget;
    otherwise row blocks of `every` rows (at most WALK_BAND_ROWS, at least
    what keeps the boundary rows within 5/4 of the budget), a forward pass
    of as few threads a block as keep its hand-over columns within 3/4 of
    it (WALK_FWD_THREADS to 512), and whole-width blocks of as many row
    blocks as fit the budget (one at least)."""
    per_row = 2 * walk_groups(cols)            # code bytes of a row
    if rows * per_row <= budget:
        return WalkPlan(True, rows, WALK_FWD_THREADS, rows)
    every = max(-(-rows * (cols + 1) * 4 // (budget * 5 // 4)),
                min(WALK_BAND_ROWS, budget // per_row), 1)
    every = min(every, rows)
    threads = WALK_FWD_THREADS
    while threads < 512 and (walk_layout(cols, threads)[1] * rows * 4
                             > budget * 3 // 4):
        threads *= 2
    return WalkPlan(False, every, threads,
                    every * max(1, budget // (per_row * every)))


def walk_band(rows: int, cols: int, score: int, every: int,
              budget: int = WALK_BUDGET) -> Optional[List[Tuple[int, int, int, int]]]:
    """(r0, rows, c0, cols) of each row block of `every` rows, cut to the
    band that holds every walk from (rows, cols) with that score (its
    cells lie on diagonals j - i within cols - rows - D .. cols - rows + I,
    seqalign.walk_gaps), or None where the band's codes pass 7/4 of the
    budget."""
    D, I = walk_gaps(rows, score)
    d_lo, d_hi = cols - rows - D, cols - rows + I
    out = []
    for r0 in range(0, rows, every):
        r1 = min(rows, r0 + every)
        c0 = min(cols, max(0, r0 + d_lo))
        c1 = max(c0, min(cols, r1 + d_hi))
        out.append((r0, r1 - r0, c0, c1 - c0))
    if sum(walk_groups(c) * n for _, n, _, c in out) * 2 > budget * 7 // 4:
        return None
    return out


def bandtrace_layout(width: int) -> Tuple[int, int]:
    """(lanes a thread L, threads a team G) of the banded walk's forward
    pass for a band of `width` lanes: L the least power of two from 4 with
    which BT_THREADS threads cover the band, G the power of two that covers
    it with L lanes each, at least four (the codes of a row are whole
    32-bit words).  A row's latency falls with the lanes a thread, so a
    band takes up to 128 threads before more lanes: 128 lanes are one warp
    of 4 lanes a thread, 512 four warps of 4, 2,048 four warps of 16.
    Raises for a band it does not take (K3 scores none of them on CUDA)."""
    if not 4 <= width <= BT_MAX_WIDTH:
        raise ValueError(f"band width {width} is not served by the banded walk "
                         f"(4 to {BT_MAX_WIDTH})")
    lanes = max(4, 1 << (-(-width // BT_THREADS) - 1).bit_length())
    return lanes, max(16 // lanes, 1 << (-(-width // lanes) - 1).bit_length())


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
    # the block kernel stages a pair's strip (its rows and the band) in
    # shared memory: sized by the pool's width, or where that passes the
    # card's limit by the launch's longest read (which waits for the rows)
    max_rows = lr
    band = -(-(width // lanes) // 32) * 32 * lanes     # the block's lanes
    if group == 0 and 8 * S + lr + band + 12 > SMEM_MAX:
        max_rows = int(rows.max())
    err = lib.sa_banded_fwd(arena.data_ptr(), arena.numel(), cum_off.data_ptr(),
                            base_ptr.data_ptr(), plen.data_ptr(), P, S,
                            read_pool.data_ptr(), R, lr, read_idx.data_ptr(),
                            path_idx.data_ptr(), deltas.data_ptr(),
                            order.data_ptr(), rows.data_ptr(), out.data_ptr(),
                            N, int(width), lanes, group, max_rows, stream)
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


def _walk_alloc(shape, dtype, device) -> torch.Tensor:
    """A buffer of the walk, its bytes counted (kernels.seqalign.walk_bytes)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    profiling.count("kernels.seqalign.walk_bytes", t.numel() * t.element_size())
    return t


def _walk_err(name: str, err: int, **shape) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} ("
                           + ", ".join(f"{k}={v}" for k, v in shape.items()) + ")")


def _walk_state(out: torch.Tensor) -> Tuple[int, int, int, int]:
    """(score, i, j, how it ended) of a walk's result words, on the host."""
    w = out[:7].cpu().tolist()
    return w[0], w[1], w[2], w[6]


def _launch_walk(lib, read_codes, path_codes, stream,
                 budget: int = WALK_BUDGET):
    """The walk on checked (rows,) and (cols,) codes of any one device, from
    their last cell: its result words, (WALK_HEAD + (rows + cols + 3) // 4,)
    int32 (walk_result reads them), and, for a rectangle walked as one tile,
    its walk codes (walk_codes reads them; None otherwise), both on that
    device.  Every buffer is allocated here and counted
    (kernels.seqalign.walk_bytes); `budget` bounds them (walk_plan).

    One tile (the codes fit the budget): sa_walk, the forward pass with
    codes and the walk, without waiting.  Otherwise row blocks, waiting on
    the device between launches: sa_walk_rows (the forward pass, boundary
    rows every `every` rows, the score), then, for a rectangle without PAD
    whose band fits (walk_band), the band's row blocks in one sa_walk_tiles
    launch and one sa_walk_trace; else (or should the walk leave the band)
    whole-width blocks of plan.block_rows rows, bottom first, one
    sa_walk_tiles and one sa_walk_trace each, each trace going on from the
    last."""
    rows, cols = read_codes.shape[0], path_codes.shape[0]
    device = read_codes.device
    plan = walk_plan(rows, cols, budget)
    out = _walk_alloc((WALK_HEAD + (rows + cols + 3) // 4,), torch.int32, device)
    if plan.whole:
        T, parts = walk_layout(cols)
        codes = _walk_alloc((walk_groups(cols) * rows,), torch.int16, device)
        work = _walk_alloc((lib.sa_walk_workspace(rows, parts),), torch.int32,
                           device)
        _walk_err("sa_walk", lib.sa_walk(
            read_codes.data_ptr(), rows, path_codes.data_ptr(), cols,
            codes.data_ptr(), work.data_ptr(), out.data_ptr(), T, parts, stream),
            rows=rows, cols=cols, T=T, parts=parts)
        profiling.count("kernels.seqalign.walk")
        profiling.count("kernels.seqalign.walk_cells", rows * cols)
        profiling.count("kernels.seqalign.walk_blocks")
        return out, codes
    every, ld = plan.every, cols + 1
    last = (rows - 1) // every * every          # the last boundary row
    bound = _walk_alloc((max(1, last // every) * ld,), torch.int32, device)
    T, parts = walk_layout(cols, plan.rows_threads)
    work = _walk_alloc((lib.sa_walk_workspace(rows, parts),), torch.int32, device)
    _walk_err("sa_walk_rows", lib.sa_walk_rows(
        read_codes.data_ptr(), rows, path_codes.data_ptr(), cols, every, last,
        bound.data_ptr(), ld, work.data_ptr(), out.data_ptr(), T, parts, stream),
        rows=rows, cols=cols, every=every, T=T, parts=parts)
    del work
    profiling.count("kernels.seqalign.walk")
    profiling.count("kernels.seqalign.walk_cells", rows * cols)
    score = _walk_state(out)[0]

    def buffers(tiles):
        """Codes and workspace for `tiles` ((r0, rows, c0, cols) each)."""
        T, parts = walk_layout(max(1, max(c for _, _, _, c in tiles)))
        words = sum(walk_groups(c) * n for _, n, _, c in tiles)
        hand_rows = max(n for _, n, _, _ in tiles)
        return (_walk_alloc((max(1, words),), torch.int16, device),
                _walk_alloc((lib.sa_walk_workspace(hand_rows, len(tiles) * parts),),
                            torch.int32, device))

    def tiles_walk(tiles, start, cont, codes, work):
        """Codes of `tiles` ((r0, rows, c0, cols) each) into `codes`, then
        the walk from `start` through them; (i, j, how it ended)."""
        width = max(c for _, _, _, c in tiles)
        T, parts = walk_layout(max(1, width))
        table, off = [], 0
        for r0, n, c0, c in tiles:
            table.append((off, r0, n, c0, c, r0 // every - 1))
            off += walk_groups(c) * n
        tab = torch.tensor(table, dtype=torch.int64).to(device)
        hand_rows = max(n for _, n, _, _ in tiles)
        _walk_err("sa_walk_tiles", lib.sa_walk_tiles(
            read_codes.data_ptr(), path_codes.data_ptr(), tab.data_ptr(),
            len(tiles), parts, bound.data_ptr(), ld, codes.data_ptr(),
            work.data_ptr(), hand_rows, T, stream),
            tiles=len(tiles), width=width, T=T, parts=parts)
        _walk_err("sa_walk_trace", lib.sa_walk_trace(
            codes.data_ptr(), tab.data_ptr(), len(tiles), read_codes.data_ptr(),
            path_codes.data_ptr(), out.data_ptr(), rows + cols, start[0],
            start[1], int(cont), stream), tiles=len(tiles), start=start)
        profiling.count("kernels.seqalign.walk_cells", sum(n * c for _, n, _, c in tiles))
        profiling.count("kernels.seqalign.walk_blocks", len(tiles))
        return _walk_state(out)[1:]

    band = walk_band(rows, cols, score, every, budget)
    if (band is not None and not bool((read_codes == PAD).any())
            and not bool((path_codes == PAD).any())):
        if tiles_walk(band, (rows, cols), False, *buffers(band))[2] == 1:
            return out, None
    i, j, cont = rows, cols, False
    bufs = buffers([(0, min(rows, plan.block_rows), 0, cols)])
    while True:                     # whole-width blocks, bottom first
        r0 = max(0, -(-(i - plan.block_rows) // every) * every)
        i, j, ended = tiles_walk([(r0, i - r0, 0, j)], (i, j), cont, *bufs)
        if ended == 1:
            return out, None
        if ended != 0 or i != r0:
            raise RuntimeError(f"the walk left its row block ({ended}, {i}, {j})")
        cont = True


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
    (rows, cols): _launch_walk (one sa_walk launch for a rectangle whose
    codes fit WALK_BUDGET, row blocks in bounded memory for a larger one)
    and one copy of the result to the host, which waits for it."""
    device = _cuda_device(read_codes, "full_walk_cuda")
    _check("read_codes", read_codes, torch.int8, 1, device)
    _check("path_codes", path_codes, torch.int8, 1, device)
    rows, cols = read_codes.shape[0], path_codes.shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    out, _ = _launch_walk(_lib(), read_codes, path_codes, stream)
    return walk_result(out.cpu(), rows, cols)


class _BandJob(NamedTuple):
    """A banded walk the kernel takes: seqalign.banded_traceback's
    arguments, its end lane and its layout."""
    read: np.ndarray
    path: np.ndarray
    end_i: int
    end_j: int
    delta: int
    width: int
    expected: int
    u_end: int
    lanes: int
    team: int


_OPS = np.frombuffer(b"=XID", np.uint8)   # the kernel's 2-bit ops
_OP_SHIFTS = 2 * np.arange(16, dtype=np.uint32)


def _bandtrace_blocks(jobs: List[_BandJob]) -> Tuple[List[int], np.ndarray]:
    """The table order of a launch's walks (by layout, then longest first)
    and its blocks, (first table row, teams, lanes, team threads) each: the
    walks of one layout BT_THREADS / G to a block (one for a team of 128
    threads), the blocks of the longest walks first."""
    order = sorted(range(len(jobs)),
                   key=lambda k: (jobs[k].lanes, jobs[k].team, -jobs[k].end_i))
    blocks, row = [], 0
    while row < len(order):
        job = jobs[order[row]]
        per_block = max(1, BT_THREADS // job.team)
        n = 0
        while (n < per_block and row + n < len(order)
               and jobs[order[row + n]][8:] == job[8:]):
            n += 1
        blocks.append((job.end_i, row, n, job.lanes, job.team))
        row += n
    blocks.sort(key=lambda b: -b[0])
    return order, np.array([b[1:] for b in blocks], np.int32).reshape(-1, BT_BLOCK_WORDS)


def _launch_bandtrace(lib, jobs: List[_BandJob], device, stream):
    """One sa_bandtrace launch over `jobs` on `device`: the table, the
    blocks and every read and path char go up in one copy, the results
    come back in one.  Returns, a walk, (score, qstart, pstart, matches,
    nm, ops) or None where a parity gate declined it, and, for checks, the
    code words on the device with each walk's first word (band_codes
    reads them)."""
    order, blocks = _bandtrace_blocks(jobs)
    n = len(jobs)
    table = np.zeros((n, BT_TABLE_WORDS), np.int64)
    chars, at, code_at, res_at = [], 0, 0, 0
    for row, k in enumerate(order):
        job = jobs[k]
        w2 = job.width // 2
        lo = min(max(0, job.delta - w2), job.end_j)
        stride = job.team * job.lanes // 16
        cap = 16 * ((2 * job.end_i + job.u_end) // 16 + 1)
        table[row] = (at, at + job.end_i, lo, job.end_i, job.end_j, job.delta,
                      job.width, code_at, stride, res_at, job.expected,
                      job.u_end, cap, 0, 0, 0)
        chars += [job.read[:job.end_i], job.path[lo:job.end_j]]
        at += job.end_i + job.end_j - lo
        code_at += -(-job.end_i * stride // 4) * 4
        res_at += BT_HEAD + cap // 16
    head = table.nbytes + blocks.nbytes
    buf = np.empty(head + at, np.uint8)
    buf[:table.nbytes] = table.view(np.uint8).reshape(-1)
    buf[table.nbytes:head] = blocks.view(np.uint8).reshape(-1)
    np.concatenate(chars, out=buf[head:].view(np.int8))
    up = torch.from_numpy(buf).to(device)
    codes = torch.empty((max(1, code_at),), dtype=torch.int32, device=device)
    res = torch.empty((res_at,), dtype=torch.int32, device=device)
    base = up.data_ptr()
    err = lib.sa_bandtrace(base + head, base, n, base + table.nbytes,
                           len(blocks), codes.data_ptr(), res.data_ptr(),
                           max(job.width for job in jobs), stream)
    if err != 0:
        raise RuntimeError(f"sa_bandtrace launch failed: cudaError {err} "
                           f"(walks={n}, blocks={len(blocks)}, "
                           f"rows={max(job.end_i for job in jobs)})")
    profiling.count("kernels.seqalign.bandtrace")
    words = res.cpu().numpy()
    out = [None] * n
    for row, k in enumerate(order):
        at = int(table[row, 9])
        status, score, qstart, pstart, matches, nm, n_ops = (
            int(x) for x in words[at:at + 7])
        if status not in (1, 2):
            raise RuntimeError(f"sa_bandtrace's walk ended as {status} "
                               f"({n_ops} ops)")
        if status == 2:
            continue
        packed = words[at + BT_HEAD:at + BT_HEAD + -(-n_ops // 16)].view(np.uint32)
        ops = ((packed[:, None] >> _OP_SHIFTS) & 3).reshape(-1)[:n_ops]
        out[k] = (score, qstart, pstart, matches, nm,
                  _OPS[ops[::-1]].tobytes().decode())
    return out, codes, table[np.argsort(order), 7]


def band_codes(codes: torch.Tensor, first: int, rows: int, width: int) -> np.ndarray:
    """The moves of one walk's band codes (a launch's code words `codes`
    from word `first`, rows x width cells) on the host as a (rows, width)
    uint8 array laid out as seqalign.band_codes_ref's codes[1:]: 0 stop,
    1 diagonal, 2 up, 3 left.  For checks."""
    lanes, team = bandtrace_layout(width)
    stride = lanes * team // 16
    words = codes[first:first + rows * stride].cpu().numpy().view(np.uint32)
    moves = (words.reshape(rows, stride)[:, :, None] >> _OP_SHIFTS) & 3
    return moves.reshape(rows, -1)[:, :width].astype(np.uint8)


def _band_walks(lib, walks, device, stream) -> list:
    """banded_walks_cuda on `lib` and the tensors of `device` (the host
    build of the source runs it on the CPU): the walks whose end lies on
    the band go in launches of sa_bandtrace, longest first, each within
    BANDTRACE_BUDGET bytes of band codes (a longer walk alone)."""
    from .seqalign import band_end

    jobs, slots = [], []
    for n, (read, path, end_i, end_j, delta, width, expected) in enumerate(walks):
        u_end = band_end(len(read), len(path), end_i, end_j, delta, width)
        if u_end is None:
            continue
        jobs.append(_BandJob(read, path, int(end_i), int(end_j), int(delta),
                             int(width), int(expected), u_end,
                             *bandtrace_layout(int(width))))
        slots.append(n)
    out = [None] * len(walks)
    order = sorted(range(len(jobs)), key=lambda k: -jobs[k].end_i)
    start = 0
    while start < len(order):
        stop, held = start, 0
        while stop < len(order):
            job = jobs[order[stop]]
            held += job.end_i * job.team * job.lanes // 4
            if stop > start and held > BANDTRACE_BUDGET:
                break
            stop += 1
        part = order[start:stop]
        for k, got in zip(part, _launch_bandtrace(lib, [jobs[k] for k in part],
                                                  device, stream)[0]):
            out[slots[k]] = got
        start = stop
    return out


def banded_walks_cuda(walks, device) -> list:
    """The banded tracebacks of `walks` (seqalign.banded_traceback's
    arguments each: read and path int8 numpy arrays, end_i, end_j, delta,
    width, expected) on the CUDA `device`, as seq_banded_traceback walks
    them: a walk, (score, qstart, pstart, matches, nm, ops), or None where
    its end lies off the band or a parity gate declined it.  One
    sa_bandtrace launch takes the walks whose codes fit BANDTRACE_BUDGET
    (_band_walks); the caller waits for each launch's results."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("banded_walks_cuda needs a CUDA device")
    return _band_walks(_lib(), walks, device,
                       torch.cuda.current_stream(device).cuda_stream)
