"""CUDA kernels K1 and K2 of the NW path scorer (csrc/nw_path.cu).

K1 (`nw_fwd_packed`) replaces gfalign_tpu/ops/nw_pallas.py
`_kernel_factory_packed`; K2 (`nw_fwd_split`) replaces `_kernel_factory`.

Both kernels take the reads as a `ReadOperand`: built once per read batch
(plain torch, any device), it holds the rows sorted by length, longest
first, padded to whole blocks, as transposed (m, rows) key planes (forward
and, for best-of-both scoring, reverse-complement), the strip width of every
block of rows, and the permutation back to the caller's row order.  A
frontier call of the search then uploads only the candidates.

`scores_prepared` picks K1 or K2 by the JAX package's rule (nw_pallas.py:
265-266: the packed word fits when the 8-padded candidate width plus the
read width is below 8192), checks device, dtype, shape and contiguity,
launches on PyTorch's current stream, and counts its launches in
`LAUNCHES`.  It never falls back to the plain version: a CUDA tensor
launches a kernel or raises.  The launch geometry is chosen by the small
pure functions below (`strip_width`, `candidate_chunk`, `wide_plan`,
`split_layout`), which run anywhere.

The library is built at first use with nvcc into build/gfalign_torch/
(plain C interface, loaded with ctypes) by ops/cuda_build.py, whose
`build("nw_path")` does it explicitly and returns nvcc's register/spill
report.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_build
from .nw_path import rc_keys_device

BLOCK_R = 128                # read rows per K1 block; the operand's row quantum
NARROW = 16                  # widest register strip; longer rows sweep strips of 32
STRIP = 32
PACKED_MAX_DIAG = 1 << 13    # K1 when pad8(n) + m < this, else K2
TARGET_BLOCKS = 132 * 16     # K1 blocks wanted per launch: 16 for each of 132 SMs
TARGET_WARPS = 132 * 8       # K2 warps wanted per launch
STAGE_WORDS = 48 * 1024 // 4  # shared-memory words for a K1 candidate chunk
SCRATCH_BYTES = 256 << 20    # hand-over scratch per launch (reads wider than a strip)
SPLIT_MAX_THREADS = {4: 1024, 8: 512, 16: 512}   # K2 threads a block, by columns a thread

LAUNCHES = {"packed": 0, "split": 0}


def uses_packed(n: int, m: int) -> bool:
    """K1 (dp, priority and exit column in one word) or K2."""
    return -(-n // 8) * 8 + m < PACKED_MAX_DIAG


def strip_width(max_len: int) -> int:
    """Register strip of a K1 block whose longest read has max_len steps:
    0 for a block of empty rows, the next even width up to 16, else 32
    (the wide kernel, which sweeps strips)."""
    if max_len <= 0:
        return 0
    if max_len > NARROW:
        return STRIP
    return max_len + (max_len & 1)


def candidate_chunk(C: int, n: int, row_blocks: int) -> int:
    """Candidates a K1 block sweeps: as many as still leave TARGET_BLOCKS
    blocks in the grid, within the shared-memory stage (n keys and a length
    per candidate) and the grid's 65,535 candidate chunks."""
    chunks_wanted = max(1, -(-TARGET_BLOCKS // max(row_blocks, 1)))
    chunk = max(-(-C // chunks_wanted), -(-C // 65535), 1)
    return max(1, min(chunk, C, STAGE_WORDS // (n + 1)))


def wide_plan(C: int, n: int, wide_blocks: int, ns: int) -> Tuple[int, int, int]:
    """(candidate chunk, candidates per launch, row blocks per launch) of the
    wide K1 kernel.  Its scratch is chunks x ns x n x rows words, so a
    launch takes as many row blocks, then as many candidate chunks, as keep
    it within SCRATCH_BYTES."""
    chunk = candidate_chunk(C, n, wide_blocks)
    block_chunks = max(1, SCRATCH_BYTES // (4 * ns * n * BLOCK_R))
    blocks = min(wide_blocks, block_chunks)
    return chunk, min(C, block_chunks // blocks * chunk), blocks


def split_layout(max_len: int, pairs: int) -> Tuple[int, int]:
    """(columns a thread K, threads a block T) of K2 for reads of at most
    max_len steps and `pairs` blocks.  More columns a thread mean fewer
    instructions a cell (the shuffles, ring accesses and barriers of a step
    are shared by K cells) but a longer serial step, so K is the largest of
    16, 8, 4 that still gives a pair 4 warps, one for each scheduler of its
    SM, unless the pairs alone fill the card with TARGET_WARPS warps; short
    reads take K = 4.  A read wider than one block's T x K columns takes
    K = 16 at 512 threads and sweeps super-strips."""
    fits = [k for k in (16, 8, 4) if max_len <= k * SPLIT_MAX_THREADS[k]]
    for k in fits:
        warps = max(1, -(-max_len // (32 * k)))
        if warps >= 4 or pairs * warps >= TARGET_WARPS or k == fits[-1]:
            return k, 32 * warps
    return 16, SPLIT_MAX_THREADS[16]


class ReadOperand:
    """Read paths as K1 and K2 want them, prepared once per batch.

    From b_keys (R, m) int32 (pads -2) and b_len (R,): rows sorted by
    length, longest first (stable), and padded with empty rows to a
    multiple of `block_rows` (Rp rows).

      keys     (Rp, m) sorted forward keys (the membership filter's view)
      keys_t   (ns, m, Rp) transposed planes: forward and, with_rc, the
               reverse-complement
      b_len    (Rp,) sorted lengths, clamped to [0, m]
      order    (R,) caller's row of each sorted row
      inverse  (R,) sorted position of each caller's row: scores in the
               operand's order, indexed by it, are in the caller's order
      block_max, block_w   per block: longest read and its strip width
                           (host lists); block_w_dev the latter on the device
      max_len, live_rows   longest read; rows that are not empty (host ints)

    Everything is plain torch and works on any device; the kernels need the
    default block_rows."""

    def __init__(self, b_keys: torch.Tensor, b_len: torch.Tensor,
                 with_rc: bool = True, block_rows: int = BLOCK_R):
        if b_keys.dim() != 2 or b_len.shape != b_keys.shape[:1]:
            raise ValueError("b_keys must be (R, m) and b_len (R,)")
        if b_keys.dtype != torch.int32:
            raise TypeError(f"b_keys must be int32, got {b_keys.dtype}")
        if b_len.device != b_keys.device:
            raise ValueError(f"b_len is on {b_len.device}, expected {b_keys.device}")
        R, m = b_keys.shape
        dev = b_keys.device
        self.R, self.m, self.block_rows = R, m, block_rows
        self.Rp = Rp = -(-R // block_rows) * block_rows
        lens = b_len.to(torch.int32).clamp(0, m)
        self.order = torch.argsort(lens, descending=True, stable=True)
        self.inverse = torch.argsort(self.order)
        self.b_len = torch.zeros((Rp,), dtype=torch.int32, device=dev)
        self.b_len[:R] = lens[self.order]
        col = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
        self.keys = torch.full((Rp, m), -2, dtype=torch.int32, device=dev)
        self.keys[:R] = b_keys[self.order]
        self.keys = torch.where(col < self.b_len[:, None], self.keys, -2)
        planes = [self.keys]
        if with_rc:
            planes.append(rc_keys_device(self.keys, self.b_len))
        self.ns = len(planes)
        self.keys_t = torch.stack([p.t() for p in planes]).contiguous()
        # sorted longest first: a block's first row is its longest
        self.block_max = self.b_len[::block_rows].tolist()
        self.block_w = [strip_width(x) for x in self.block_max]
        self.block_w_dev = torch.tensor(self.block_w, dtype=torch.int32, device=dev)
        self.max_len = self.block_max[0] if self.block_max else 0
        self.live_rows = int((self.b_len > 0).sum())   # they come first
        self.wide_blocks = sum(w == STRIP for w in self.block_w)
        self._scratch = None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def plane(self, o: int) -> torch.Tensor:
        """(Rp, m) keys of orientation o (0 forward, 1 reverse-complement)."""
        return self.keys_t[o].t()

    def to_caller_order(self, scores: torch.Tensor) -> torch.Tensor:
        """(C, Rp) scores in the operand's order -> (C, R) in the caller's."""
        return scores.index_select(1, self.inverse)

    def scratch(self, words: int) -> torch.Tensor:
        """int32 hand-over scratch of at least `words`, kept with the operand
        so that repeated calls at one shape allocate once."""
        if self._scratch is None or self._scratch.numel() < words:
            self._scratch = torch.empty(words, dtype=torch.int32, device=self.device)
        return self._scratch


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of csrc/nw_path.cu on a loaded library."""
    lib.nw_fwd_packed.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                  + [ctypes.c_void_p])
    lib.nw_fwd_split.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                                 + [ctypes.c_void_p])
    for fn in (lib.nw_fwd_packed, lib.nw_fwd_split):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(cuda_build.load("nw_path"))


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_packed(lib, a_keys, a_len, op: ReadOperand, out, stream) -> None:
    C, n = a_keys.shape
    n_blocks = op.Rp // BLOCK_R

    def launch(c0, cc, blk0, nblk, chunk, scratch):
        err = lib.nw_fwd_packed(
            a_keys[c0].data_ptr(), a_len[c0:].data_ptr(), op.keys_t.data_ptr(),
            op.b_len.data_ptr(), op.block_w_dev.data_ptr(), out[c0].data_ptr(),
            None if scratch is None else scratch.data_ptr(), cc, n, op.Rp, op.m,
            op.ns, blk0, nblk, chunk, int(scratch is not None), stream)
        if err != 0:
            raise RuntimeError(
                f"nw_fwd_packed launch failed: cudaError {err} (C={cc}, n={n}, "
                f"rows={op.Rp}, m={op.m}, blocks {blk0}+{nblk}, chunk={chunk})")
        LAUNCHES["packed"] += 1

    wide = op.wide_blocks            # the longest rows come first
    if wide:
        chunk, c_step, b_step = wide_plan(C, n, wide, op.ns)
        scratch = op.scratch(-(-c_step // chunk) * op.ns * n * b_step * BLOCK_R)
        for c0 in range(0, C, c_step):
            for blk0 in range(0, wide, b_step):
                launch(c0, min(c_step, C - c0), blk0, min(b_step, wide - blk0),
                       chunk, scratch)
    if n_blocks > wide:
        launch(0, C, wide, n_blocks - wide,
               candidate_chunk(C, n, n_blocks - wide), None)


def _launch_split(lib, a_keys, a_len, op: ReadOperand, stream) -> torch.Tensor:
    C, n = a_keys.shape
    K, T = split_layout(op.max_len, C * op.live_rows * op.ns)
    # a block per live row; the empty rows behind them score 0
    out = torch.zeros((op.ns, C, op.Rp), dtype=torch.int32, device=op.device)
    if op.live_rows == 0:
        return out[0]
    step = min(C, 65535)             # grid.y limit
    per_cand = 0
    if op.max_len > K * T:           # super-strips hand over through scratch
        per_cand = op.ns * op.Rp * 2 * n
        if 4 * per_cand > SCRATCH_BYTES:
            raise ValueError(
                f"nw_fwd_split: {op.Rp} read rows of up to {op.max_len} steps "
                f"against candidates of {n} need {4 * per_cand} bytes of "
                f"hand-over scratch a candidate; score the reads in smaller batches")
        step = min(step, SCRATCH_BYTES // (4 * per_cand))
    for c0 in range(0, C, step):
        cc = min(step, C - c0)
        # the kernel wants contiguous (ns, cc, Rp) planes
        part = out if cc == C else torch.zeros_like(out[:, :cc])
        scratch = op.scratch(cc * per_cand) if per_cand else None
        err = lib.nw_fwd_split(
            a_keys[c0].data_ptr(), a_len[c0:].data_ptr(), op.keys_t.data_ptr(),
            op.b_len.data_ptr(), part.data_ptr(),
            None if scratch is None else scratch.data_ptr(), cc, n, op.Rp,
            op.live_rows, op.m, op.ns, op.max_len, K, T, stream)
        if err != 0:
            raise RuntimeError(
                f"nw_fwd_split launch failed: cudaError {err} (C={cc}, n={n}, "
                f"rows={op.Rp}, m={op.m}, K={K}, T={T})")
        LAUNCHES["split"] += 1
        if part is not out:
            out[:, c0:c0 + cc] = part
    return out[0] if op.ns == 1 else torch.maximum(out[0], out[1])


def scores_prepared(a_keys: torch.Tensor, a_len: torch.Tensor,
                    operand: ReadOperand) -> torch.Tensor:
    """(C, Rp) int32 traceback scores of every candidate against every row
    of a prepared CUDA read operand, in the operand's row order: forward
    scores, or max(forward, reverse-complement) when the operand holds both
    planes.

    a_keys (C, n) int32 (pads -1) and a_len (C,) int32, contiguous on the
    operand's device; lengths lie in [0, n]."""
    device = operand.device
    if device.type != "cuda":
        raise ValueError(f"scores_prepared needs a CUDA operand, got {device}")
    if operand.block_rows != BLOCK_R:
        raise ValueError(f"the kernels need an operand of {BLOCK_R}-row blocks, "
                         f"got {operand.block_rows}")
    if a_keys.dim() != 2:
        raise ValueError("a_keys must be 2-D")
    C, n = a_keys.shape
    _check("a_keys", a_keys, (C, n), device)
    _check("a_len", a_len, (C,), device)
    if C == 0 or operand.R == 0 or n == 0 or operand.m == 0:
        return torch.zeros((C, operand.Rp), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if uses_packed(n, operand.m):
        out = torch.empty((C, operand.Rp), dtype=torch.int32, device=device)
        _launch_packed(_lib(), a_keys, a_len, operand, out, stream)
        return out
    return _launch_split(_lib(), a_keys, a_len, operand, stream)


def _scores_cuda(a_keys, a_len, b_keys, b_len, with_rc: bool) -> torch.Tensor:
    if b_keys.dim() != 2:
        raise ValueError("b_keys must be 2-D")
    R, m = b_keys.shape
    device = b_keys.device
    if device.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {device}")
    _check("b_keys", b_keys, (R, m), device)
    _check("b_len", b_len, (R,), device)
    operand = ReadOperand(b_keys, b_len, with_rc=with_rc)
    return operand.to_caller_order(scores_prepared(a_keys, a_len, operand))


def nw_pair_scores_cuda(a_keys: torch.Tensor, a_len: torch.Tensor,
                        b_keys: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """(C, R) int32 traceback scores of every (candidate, read) pair, in the
    caller's row order: prepares a forward-only operand for this one call.

    a_keys (C, n) int32 (pads -1), a_len (C,), b_keys (R, m) int32 (pads
    -2), b_len (R,), all contiguous on one CUDA device; lengths lie in
    [0, width]."""
    return _scores_cuda(a_keys, a_len, b_keys, b_len, with_rc=False)


def nw_best_scores_cuda(a_keys: torch.Tensor, a_len: torch.Tensor,
                        b_keys: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """(C, R) int32 max(forward, reverse-complement) scores in the caller's
    row order; operands as for `nw_pair_scores_cuda`."""
    return _scores_cuda(a_keys, a_len, b_keys, b_len, with_rc=True)
