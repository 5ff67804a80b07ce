"""CUDA kernels K1 and K2 of the NW path scorer (csrc/nw_path.cu).

K1 (`nw_fwd_packed`) replaces gfalign_tpu/ops/nw_pallas.py
`_kernel_factory_packed`; K2 (`nw_fwd_split`) replaces `_kernel_factory`.
The wrapper picks K1 or K2 by the JAX package's rule (nw_pallas.py:265-266:
the packed word fits when the 8-padded candidate width plus the read width
is below 8192), checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, and counts its launches in `LAUNCHES`.  It never
falls back to the plain version: a CUDA tensor launches a kernel or raises.

The library is built at first use with nvcc into build/gfalign_torch/
(plain C interface, loaded with ctypes) by ops/cuda_build.py, whose
`build("nw_path")` does it explicitly and returns nvcc's register/spill
report.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

TILE_R = 128                 # reads per block (the read pad quantum on CUDA)
STRIP = 32                   # widest register strip; wider reads use scratch
PACKED_MAX_DIAG = 1 << 13    # K1 when pad8(n) + m < this, else K2
SCRATCH_BYTES = 256 << 20    # strip scratch per launch; C is chunked to fit

LAUNCHES = {"packed": 0, "split": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("nw_path")
    for fn in (lib.nw_fwd_packed, lib.nw_fwd_split):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nw_pair_scores_cuda(a_keys: torch.Tensor, a_len: torch.Tensor,
                        b_keys: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """(C, R) int32 traceback scores of every (candidate, read) pair.

    a_keys (C, n) int32 (pads -1), a_len (C,), b_keys (R, m) int32 (pads
    -2), b_len (R,), all contiguous on one CUDA device; lengths lie in
    [0, width]."""
    if a_keys.dim() != 2 or b_keys.dim() != 2:
        raise ValueError("a_keys and b_keys must be 2-D")
    C, n = a_keys.shape
    R, m = b_keys.shape
    device = b_keys.device
    if device.type != "cuda":
        raise ValueError(f"nw_pair_scores_cuda needs CUDA tensors, got {device}")
    _check("a_keys", a_keys, (C, n), device)
    _check("a_len", a_len, (C,), device)
    _check("b_keys", b_keys, (R, m), device)
    _check("b_len", b_len, (R,), device)
    if C == 0 or R == 0 or n == 0 or m == 0:
        return torch.zeros((C, R), dtype=torch.int32, device=device)
    out = torch.empty((C, R), dtype=torch.int32, device=device)
    packed = -(-n // 8) * 8 + m < PACKED_MAX_DIAG
    kind = "packed" if packed else "split"
    lib = _lib()
    fn = lib.nw_fwd_packed if packed else lib.nw_fwd_split
    # transposed read keys: neighbouring threads read neighbouring words
    b_t = b_keys.t().contiguous()
    scratch = None
    chunk = min(C, 65535)  # grid.y limit
    if m > STRIP:
        per_cand = (1 if packed else 2) * n * R   # int32 words of scratch
        chunk = max(1, min(chunk, SCRATCH_BYTES // (4 * per_cand)))
        scratch = torch.empty(chunk * per_cand, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for c0 in range(0, C, chunk):
        cc = min(chunk, C - c0)
        err = fn(a_keys[c0].data_ptr(), a_len[c0:].data_ptr(), b_t.data_ptr(),
                 b_len.data_ptr(), out[c0].data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 cc, n, R, m, stream)
        if err != 0:
            raise RuntimeError(f"nw_fwd_{kind} launch failed: cudaError {err} "
                               f"(C={cc}, n={n}, R={R}, m={m})")
        LAUNCHES[kind] += 1
    return out
