"""CUDA kernels K3, K4 and K5 of the align-mode scorer (csrc/seqalign.cu).

K3 (`sa_banded_fwd`) replaces gfalign_tpu/ops/seqalign_pallas.py
`_banded_kernel_factory` together with the strip assembly in front of it;
K4 and K5 (`sa_local_fwd`, pairwise and cross product) replace
`_kernel_factory`.  The wrappers check device, dtype, shape and contiguity,
launch on PyTorch's current stream without synchronising, and count their
launches in `LAUNCHES`.  They never fall back to the plain versions of
ops/seqalign.py: a CUDA tensor launches a kernel or raises.

The library is built at first use with nvcc into build/gfalign_torch/ by
ops/cuda_build.py, whose `build("seqalign")` does it explicitly and returns
nvcc's register/spill report.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SCRATCH_BYTES = 1 << 30   # K4/K5 strip hand-over planes per launch (wide paths)

LAUNCHES = {"banded": 0, "pairs": 0, "cross": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("seqalign")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sa_banded_lanes.argtypes = [ci]
    lib.sa_banded_lanes.restype = ci
    lib.sa_local_strip.argtypes = [ci]
    lib.sa_local_strip.restype = ci
    lib.sa_banded_fwd.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp, ci, ci,
                                  vp, vp, vp, vp, ci, ci, vp]
    lib.sa_banded_fwd.restype = ci
    lib.sa_local_fwd.argtypes = [vp, ci, ci, vp, ci, ci, ci, vp, vp, vp]
    lib.sa_local_fwd.restype = ci
    return lib


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


def banded_arena_scores_cuda(arena, cum_off, base_ptr, plen, read_pool,
                             read_idx, path_idx, deltas, width: int):
    """(best, bi, bj, edge) of N banded pairs, each (N,) on the device (int32
    and a bool flag): pair n aligns read_pool[read_idx[n]] against the path
    registered in row path_idx[n] of the step tables, in a band of `width`
    lanes around diagonal deltas[n].

    arena (A,) int8; cum_off, base_ptr (P, S) int32; plen (P,) int32;
    read_pool (R, lr) int8; read_idx, path_idx, deltas (N,) int32; all
    contiguous on one CUDA device.  Indices clamp into their pools."""
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
    lib = _lib()
    if lib.sa_banded_lanes(int(width)) == 0:
        raise ValueError(f"band width {width} is not served by the CUDA kernel "
                         "(a multiple of 4 up to 2048, or of 16 up to 8192)")
    out = torch.empty((4, N), dtype=torch.int32, device=device)
    if N == 0:
        return out[0], out[1], out[2], out[3].bool()
    if arena.numel() == 0 or P == 0 or R == 0 or lr == 0:
        raise ValueError("banded_arena_scores_cuda needs non-empty pools")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.sa_banded_fwd(arena.data_ptr(), arena.numel(), cum_off.data_ptr(),
                            base_ptr.data_ptr(), plen.data_ptr(), P, S,
                            read_pool.data_ptr(), R, lr, read_idx.data_ptr(),
                            path_idx.data_ptr(), deltas.data_ptr(),
                            out.data_ptr(), N, int(width), stream)
    if err != 0:
        raise RuntimeError(f"sa_banded_fwd launch failed: cudaError {err} "
                           f"(N={N}, lr={lr}, width={width}, S={S})")
    LAUNCHES["banded"] += 1
    return out[0], out[1], out[2], out[3].bool()


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
    kind = "pairs" if pairwise else "cross"
    lib = _lib()
    out = torch.empty((3,) + shape, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    # a path wider than one strip of columns hands columns on through scratch
    # planes (2 x pairs x lr int32); reads are chunked to bound them
    step, scratch = R, None
    if lp > lib.sa_local_strip(lp):
        per_read = 2 * (1 if pairwise else P) * lr * 4
        step = max(1, min(R, SCRATCH_BYTES // per_read))
        scratch = torch.empty(step * per_read // 4, dtype=torch.int32, device=device)
    for r0 in range(0, R, step):
        n = min(step, R - r0)
        # one launch writes (3, n[, P]); a chunk of the reads gets its own
        # buffer so that the three planes stay contiguous
        part = out if n == R else torch.empty((3, n) + shape[1:],
                                              dtype=torch.int32, device=device)
        paths = path_codes[r0:r0 + n] if pairwise else path_codes
        err = lib.sa_local_fwd(read_codes[r0:r0 + n].data_ptr(), n, lr,
                               paths.data_ptr(), n if pairwise else P, lp,
                               int(pairwise), part.data_ptr(),
                               None if scratch is None else scratch.data_ptr(),
                               stream)
        if err != 0:
            raise RuntimeError(f"sa_local_fwd launch failed: cudaError {err} "
                               f"(R={n}, P={P}, lr={lr}, lp={lp}, {kind})")
        LAUNCHES[kind] += 1
        if part is not out:
            out[:, r0:r0 + n] = part
    return out[0], out[1], out[2]
