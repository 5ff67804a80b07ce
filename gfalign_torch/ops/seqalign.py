"""Base-level local alignment (Smith-Waterman, linear gap) for the align
mode -- the capability the reference outsources to GraphAligner
(reference src/main.cpp:167-169).  PyTorch port of
gfalign_tpu/ops/seqalign.py.

Device/host split:
  * the O(Lr x Lp) forward scoring runs on the device, batched over
    (reads x candidate path sequences).  On CUDA tensors the entry points
    launch the hand-written kernels of ops/seqalign_cuda.py
    (csrc/seqalign.cu) or raise; on CPU tensors they run the plain PyTorch
    versions below (`*_ref`), which translate the JAX package's row scans:
    the per-row horizontal dependency is an associative max-plus decay
    scan, so each row is elementwise work + one cummax;
  * only the selected placements (a handful per read) are tracebacked, on
    the host, by recomputing the single pair's small DP.

Scoring: match +1, mismatch -2, gap -3 (linear).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

MATCH = 1
MISMATCH = -2
GAP = -3


class Placement(NamedTuple):
    score: int
    qstart: int
    qend: int
    pstart: int
    pend: int
    cigar: List[Tuple[int, str]]   # [(run_length, op)] ops: = X I D
    matches: int
    nm: int


PAD = 5       # padding sentinel; code 4 = N (aligns as mismatch)
_BLOCK = -1000  # padding must never extend an alignment
_BIG = 1 << 30

# Tracebacks by route: the native C++ walks or the numpy oracles below.
TRACEBACK_CALLS = {"native": 0, "python": 0}

# Plain-version working set: local_forward_ref keeps its (R, P, Lp + 1) rows
# in read chunks of at most this many elements.
_REF_CHUNK_ELEMS = 1 << 24


def _as_tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if dtype is None or t.dtype == dtype else t.to(dtype)


def _subs(r, p):
    """Substitution scores of read chars `r` against path chars `p`
    (broadcast): PAD on either side blocks, equal bases < 4 match, anything
    else (N included) mismatches."""
    is_pad = (r == PAD) | (p == PAD)
    match = (r < 4) & (p < 4) & (r == p)
    s = torch.where(match, MATCH, MISMATCH)
    return torch.where(is_pad, _BLOCK, s).to(torch.int32)


def _first_argmax(values, row_best, idx):
    """Smallest index of the row maximum along the last axis."""
    return torch.where(values == row_best[..., None], idx, _BIG).amin(dim=-1)


def _live_rows(read_codes) -> int:
    """Rows up to the last non-PAD read char of the batch: a row of PADs
    blocks every cell, so the rows after it only decay and never raise a
    best."""
    live = (read_codes != PAD).any(dim=0).nonzero()
    return int(live[-1]) + 1 if live.numel() else 0


def _local_scan(reads, paths, lead):
    """Row scan of the local-alignment recurrence.  reads (..., Lr) and
    paths (..., Lp) broadcast over the leading shape `lead`; returns
    (best, bi, bj), each of shape `lead`."""
    dev = paths.device
    Lp = paths.shape[-1]
    i32 = torch.int32
    jidx = torch.arange(Lp + 1, dtype=i32, device=dev)
    gj = GAP * jidx  # decay offsets for the cummax trick
    H = torch.zeros(tuple(lead) + (Lp + 1,), dtype=i32, device=dev)
    best = torch.zeros(tuple(lead), dtype=i32, device=dev)
    bi = torch.zeros_like(best)
    bj = torch.zeros_like(best)
    zero_col = torch.zeros(tuple(lead) + (1,), dtype=i32, device=dev)
    flat = reads.reshape(-1, reads.shape[-1])
    for i in range(_live_rows(flat)):
        s = _subs(reads[..., i:i + 1], paths)
        c = torch.clamp_min(torch.maximum(H[..., :-1] + s, H[..., 1:] + GAP), 0)
        c0 = torch.cat([zero_col, c.expand(tuple(lead) + (Lp,))], dim=-1)
        H = torch.cummax(c0 - gj, dim=-1).values + gj
        row_best = H.amax(dim=-1)
        improved = row_best > best
        row_arg = _first_argmax(H, row_best, jidx)
        best = torch.where(improved, row_best, best)
        bi = torch.where(improved, i + 1, bi).to(i32)
        bj = torch.where(improved, row_arg, bj).to(i32)
    return best, bi, bj


def local_forward_ref(read_codes, path_codes):
    """Plain PyTorch best local alignment cell for every (read, path) pair.

    read_codes: (R, Lr) int8 (0-3 bases, 4 = N, 5 = PAD)
    path_codes: (P, Lp) int8
    returns (best, best_i, best_j): each (R, P) int32; best_i/best_j are the
    END cell (1-based DP indices) of the maximum-scoring local alignment
    (largest value, then smallest row, then smallest column; a best of 0
    reports (0, 0))."""
    R = read_codes.shape[0]
    P, Lp = path_codes.shape
    outs = [torch.zeros((R, P), dtype=torch.int32, device=path_codes.device)
            for _ in range(3)]
    if R == 0 or P == 0:
        return tuple(outs)
    step = max(1, _REF_CHUNK_ELEMS // (P * (Lp + 1)))
    for r0 in range(0, R, step):
        rc = read_codes[r0:r0 + step]
        got = _local_scan(rc[:, None, :], path_codes[None, :, :],
                          (rc.shape[0], P))
        for out, g in zip(outs, got):
            out[r0:r0 + step] = g
    return tuple(outs)


def local_forward_pairs_ref(read_codes, path_codes):
    """Plain pairwise variant: row i of reads aligns against row i of paths
    only.  read_codes: (N, Lr), path_codes: (N, Lp) -> (best, bi, bj) each
    (N,)."""
    return _local_scan(read_codes, path_codes, (read_codes.shape[0],))


def _check_codes(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype != torch.int8:
        raise TypeError(f"{name} must be int8, got {t.dtype}")


def batched_pair_scores(read_codes, path_codes):
    """(best, bi, bj), each (N,) int32 on the inputs' device: read i against
    path i.  CUDA tensors launch the kernel (K4) or raise; CPU tensors run
    the plain version."""
    read_codes, path_codes = _as_tensor(read_codes), _as_tensor(path_codes)
    _check_codes("read_codes", read_codes)
    _check_codes("path_codes", path_codes)
    if read_codes.is_cuda or path_codes.is_cuda:
        from . import seqalign_cuda

        return seqalign_cuda.local_forward_cuda(read_codes, path_codes,
                                                pairwise=True)
    return local_forward_pairs_ref(read_codes, path_codes)


def batched_local_scores(read_codes, path_codes):
    """(best, bi, bj), each (R, P) int32 on the inputs' device: every read
    against every path.  CUDA tensors launch the kernel (K5) or raise; CPU
    tensors run the plain version."""
    read_codes, path_codes = _as_tensor(read_codes), _as_tensor(path_codes)
    _check_codes("read_codes", read_codes)
    _check_codes("path_codes", path_codes)
    if read_codes.is_cuda or path_codes.is_cuda:
        from . import seqalign_cuda

        return seqalign_cuda.local_forward_cuda(read_codes, path_codes,
                                                pairwise=False)
    return local_forward_ref(read_codes, path_codes)


# ---------------------------------------------------------------------------
# Banded pairwise scoring (seeded align fast path)
# ---------------------------------------------------------------------------


def banded_pair_scores(read_codes, path_codes, deltas, width: int = 128):
    """Pairwise local alignment restricted to a band around a known
    diagonal -- the GraphAligner-style banded DP the seeded aligner uses
    when anchors supply the expected diagonal (read pos i aligns near path
    pos i + delta).  ~Lp/width fewer cells than the full pairwise DP;
    results are identical whenever the optimal alignment stays in-band.
    Out-of-band DETECTION is best-effort: the edge flag fires when the best
    END cell sits on a band-edge lane (callers rescore flagged and
    sub-threshold pairs with the full DP).  Residual risk, documented: an
    optimal path that leaves the band mid-walk while ENDING at an interior
    cell is scored lower silently.  Anchored deltas make the case rare, and
    the traceback parity gates (banded_traceback) keep every EMITTED
    placement self-consistent with its score.

    Band coordinates: H_band[i][u] = H[i][j], j = i + delta - width//2 + u.
    The diagonal predecessor keeps its lane, 'up' shifts by +1, and the
    horizontal chain is the usual max-plus prefix over the band.

    read_codes: (N, Lr) int8, path_codes: (N, Lp) int8, deltas: (N,) int.
    Returns (best, bi, bj, edge) on the inputs' device -- as the pairwise
    DP plus a bool band-edge-touch flag per pair.  CUDA tensors launch the
    banded kernel (K3) or raise; CPU tensors run the plain version."""
    read_codes, path_codes = _as_tensor(read_codes), _as_tensor(path_codes)
    _check_codes("read_codes", read_codes)
    _check_codes("path_codes", path_codes)
    dev = read_codes.device
    deltas = _as_tensor(deltas, torch.int32).to(dev)
    if not read_codes.is_cuda:
        return _banded_forward(read_codes, path_codes, deltas, width=width)
    # each row of path_codes is a one-step path in an arena made of the rows
    N, lp = path_codes.shape
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    return banded_arena_scores(
        path_codes.reshape(-1), torch.zeros((N, 1), dtype=torch.int32, device=dev),
        (rows * lp)[:, None].contiguous(),
        torch.full((N,), lp, dtype=torch.int32, device=dev), read_codes, rows,
        rows, deltas, width=width, materialize=False)


def assemble_strip(arena, cum_off, base_ptr, plens, deltas, n_cols: int,
                   shift: int, w2: int):
    """Assemble banded strips ON DEVICE from the oriented-segment arena.

    A candidate path is a concatenation of oriented segment slices; path
    position x of pair n lives at arena[base_ptr[n, k] + x] where k is the
    last step with cum_off[n, k] <= x.  strip[n, t] = path char at
    x = t + delta_n - w2 - shift, PAD outside [0, plen).

    arena: (A,) int8 oriented segment codes (fw + rc of every segment,
        uploaded once -- paths never ship their bytes to the device).
    cum_off: (N, S) int32, step start offsets, padded with INT32_MAX.
    base_ptr: (N, S) int32 (arena start - cum_off + overlap drop).
    plens, deltas: (N,) int32.  cum_off[:, 0] must be 0 (every path has a
    first step starting at 0)."""
    N, S = cum_off.shape
    t = torch.arange(n_cols, dtype=torch.int32, device=arena.device)
    src = t[None, :] + deltas[:, None].to(torch.int32) - w2 - shift
    valid = (src >= 0) & (src < plens[:, None])
    srcc = src.clamp_min(0)
    # step selection: the last k with cum_off[n, k] <= src, as S
    # compare-selects (cum_off pad entries are INT32_MAX, so never win)
    bsel = base_ptr[:, 0:1].expand(N, n_cols)
    for s in range(1, S):
        bsel = torch.where(cum_off[:, s:s + 1] <= srcc, base_ptr[:, s:s + 1], bsel)
    ai = (bsel + srcc).clamp(0, arena.shape[0] - 1)
    codes = arena[ai.long()]
    return torch.where(valid, codes, PAD).to(torch.int8)


def banded_arena_scores_ref(arena, cum_off_pool, base_ptr_pool, plen_pool,
                            read_pool, read_idx, path_idx, deltas, width: int):
    """Plain PyTorch version of banded_arena_scores, on the tensors' own
    device: gather the pairs' rows (indices clamp into the pools), assemble
    the strips from the arena, run the banded row scan."""
    ridx = read_idx.long().clamp(0, read_pool.shape[0] - 1)
    pidx = path_idx.long().clamp(0, cum_off_pool.shape[0] - 1)
    rc = read_pool[ridx]
    co = cum_off_pool[pidx]
    bp = base_ptr_pool[pidx]
    pl = plen_pool[pidx]
    strip = assemble_strip(arena, co, bp, pl, deltas, rc.shape[1] + width,
                           shift=0, w2=width // 2)
    return _banded_forward_core(rc, strip, deltas, pl, width=width)


def banded_arena_scores(arena, cum_off_pool, base_ptr_pool, plen_pool,
                        read_pool, read_idx, path_idx, deltas,
                        width: int = 128, materialize: bool = True):
    """Banded pairwise scoring with device-side strip assembly: per
    dispatch only int32 row indices + deltas leave the host; the path BYTES
    never do (they are re-materialized from the segment arena).
    Returns (best, bi, bj, edge) like banded_pair_scores.

    The pools are tensors on one device; read_idx, path_idx and deltas may
    be numpy arrays (they are moved there).  CUDA pools launch the banded
    kernel (K3) or raise; CPU pools run the plain version.

    materialize=False returns device tensors WITHOUT waiting: callers with
    several chunks queue them all, then fetch (the fetch is the
    synchronization point)."""
    dev = arena.device
    read_idx = _as_tensor(read_idx, torch.int32).to(dev)
    path_idx = _as_tensor(path_idx, torch.int32).to(dev)
    deltas = _as_tensor(deltas, torch.int32).to(dev)
    if arena.is_cuda:
        from . import seqalign_cuda

        out = seqalign_cuda.banded_arena_scores_cuda(
            arena, cum_off_pool, base_ptr_pool, plen_pool, read_pool,
            read_idx, path_idx, deltas, width)
    else:
        out = banded_arena_scores_ref(
            arena, cum_off_pool, base_ptr_pool, plen_pool, read_pool,
            read_idx, path_idx, deltas, width)
    if not materialize:
        return out
    return tuple(x.cpu().numpy() for x in out)


def _banded_forward(read_codes, path_codes, deltas, *, width: int):
    Lr = read_codes.shape[1]
    lp = path_codes.shape[1]
    W2 = width // 2
    dev = read_codes.device
    # strip extraction on the device: strip[n, t] = path[n, t + delta - W2]
    t = torch.arange(Lr + width, dtype=torch.int32, device=dev)
    src = t[None, :] + deltas[:, None].to(torch.int32) - W2
    ok = (src >= 0) & (src < lp)
    strip = torch.where(ok, torch.gather(path_codes, 1,
                                         src.clamp(0, lp - 1).long()), PAD)
    plens = torch.full(read_codes.shape[:1], lp, dtype=torch.int32, device=dev)
    return _banded_forward_core(read_codes, strip.to(torch.int8), deltas, plens,
                                width=width)


def _banded_forward_core(read_codes, strip, deltas, plens, *, width: int):
    """Banded scan over a pre-extracted strip (strip[n, t] = path char at
    position t + delta - W2, PAD outside); `plens` bounds the in-path
    region per pair.  Cells beyond a path's true length can never win the
    best (every move into them strictly decays), so calling this with
    plens = padded pool width or with true path lengths yields identical
    (best, bi, bj, edge).

    No mid-walk out-of-band detection is attempted: the edge flag covers
    only the END cell (see banded_pair_scores)."""
    N, Lr = read_codes.shape
    dev = read_codes.device
    i32 = torch.int32
    W2 = width // 2
    uidx = torch.arange(width, dtype=i32, device=dev)
    gj = GAP * torch.arange(width + 1, dtype=i32, device=dev)
    deltas = deltas.to(i32)
    lp_col = plens.to(i32)[:, None]
    H = torch.zeros((N, width), dtype=i32, device=dev)
    best = torch.zeros((N,), dtype=i32, device=dev)
    bi = torch.zeros_like(best)
    bj = torch.zeros_like(best)
    bu = torch.zeros_like(best)
    block_col = torch.full((N, 1), _BLOCK, dtype=i32, device=dev)
    zero_col = torch.zeros((N, 1), dtype=i32, device=dev)
    j0 = deltas[:, None] - W2 + uidx[None, :]           # j(u) - i1
    for i1 in range(1, _live_rows(read_codes) + 1):     # current row (1-based)
        # window for row i1 = strip[:, i1-1 : i1-1+width]
        win = strip[:, i1 - 1:i1 - 1 + width]
        j_of_u = j0 + i1
        in_path = (j_of_u >= 1) & (j_of_u <= lp_col)
        s = _subs(read_codes[:, i1 - 1:i1], win)
        up = torch.cat([H[:, 1:], block_col], dim=1)
        c = torch.clamp_min(torch.maximum(H + s, up + GAP), 0)
        c = torch.where(in_path, c, 0)
        # horizontal chain along the band (max-plus prefix)
        c0 = torch.cat([zero_col, c], dim=1)
        z = torch.cummax(c0 - gj, dim=1).values
        H = torch.where(in_path, (z + gj)[:, 1:], 0)
        row_best = H.amax(dim=1)
        row_u = _first_argmax(H, row_best, uidx)
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        bi = torch.where(improved, i1, bi).to(i32)
        bj = torch.where(improved, i1 + deltas - W2 + row_u, bj).to(i32)
        bu = torch.where(improved, row_u, bu).to(i32)
    ok = best > 0
    edge = ok & ((bu <= 0) | (bu >= width - 1))
    return (torch.where(ok, best, 0), torch.where(ok, bi, 0),
            torch.where(ok, bj, 0), edge)


# ---------------------------------------------------------------------------
# Host traceback for a selected (read, path) pair
# ---------------------------------------------------------------------------


def _matrix(read: np.ndarray, path: np.ndarray) -> np.ndarray:
    Lr, Lp = len(read), len(path)
    H = np.zeros((Lr + 1, Lp + 1), dtype=np.int32)
    decay = -GAP * np.arange(Lp, dtype=np.int32)  # max-plus decay offsets
    for i in range(1, Lr + 1):
        rc = read[i - 1]
        sub = np.where((path == PAD) | (rc == PAD), _BLOCK,
                       np.where((path < 4) & (rc < 4) & (path == rc), MATCH, MISMATCH))
        prev = H[i - 1]
        c = np.maximum(0, np.maximum(prev[:-1] + sub, prev[1:] + GAP))
        # horizontal chain H[j] = max(c[j], H[j-1]+GAP) as one accumulate
        H[i, 1:] = np.maximum.accumulate(c + decay) - decay
    return H


def _runs(ops) -> List[Tuple[int, str]]:
    """Run-length encode an op sequence (a string or a list of chars)."""
    if not ops:
        return []
    s = ops if isinstance(ops, str) else "".join(ops)
    a = np.frombuffer(s.encode(), np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(a)]]))
    return [(int(c), chr(a[i])) for c, i in zip(counts, starts)]


def traceback(read: np.ndarray, path: np.ndarray,
              end_i: int, end_j: int) -> Placement:
    """Recompute the pair DP and walk back from (end_i, end_j) to H==0.

    Runs the native C++ walk (io/native.local_traceback); the full-matrix
    numpy row loop below is its oracle, taken when `native.available()` is
    false or the walk declines."""
    from ..io import native

    if native.available():
        TRACEBACK_CALLS["native"] += 1
        res = native.local_traceback(read, path, end_i, end_j,
                                     MATCH, MISMATCH, GAP, PAD, _BLOCK)
        if res is not None:
            score, qstart, pstart, matches, nm, ops = res
            return Placement(score, qstart, end_i, pstart, end_j,
                             _runs(ops), matches, nm)
    TRACEBACK_CALLS["python"] += 1
    return _traceback_py(read, path, end_i, end_j)


def banded_traceback(read: np.ndarray, path: np.ndarray,
                     end_i: int, end_j: int, delta: int, width: int,
                     expected: int):
    """Banded traceback for a pair scored by the banded scorer: recomputes
    only the band (O(end_i x width) vs the full matrix's O(end_i x end_j))
    and walks back from (end_i, end_j).

    Banded H <= full H even at interior cells, so the walk is only trusted
    behind two parity gates: the banded end-cell value must equal
    `expected` (the device score) and the walk must never touch a band-edge
    lane.  Returns None when a gate fails (or coordinates are off-band) --
    the caller falls back to the exact full-matrix traceback().  The
    exhaustive align mode never uses this path.  Runs the native C++ walk
    (io/native.banded_local_traceback); `_banded_traceback_py` is its
    oracle, taken when `native.available()` is false."""
    from ..io import native

    if native.available():
        TRACEBACK_CALLS["native"] += 1
        res = native.banded_local_traceback(read, path, end_i, end_j, delta,
                                            width, expected, MATCH, MISMATCH,
                                            GAP, PAD, _BLOCK)
    else:
        TRACEBACK_CALLS["python"] += 1
        res = _banded_traceback_py(read, path, end_i, end_j, delta, width,
                                   expected)
    if res is None:
        return None
    score, qstart, pstart, matches, nm, ops = res
    return Placement(score, qstart, end_i, pstart, end_j,
                     _runs(ops), matches, nm)


def _banded_traceback_py(read: np.ndarray, path: np.ndarray,
                         end_i: int, end_j: int, delta: int, width: int,
                         expected: int):
    """Banded DP recomputation and walk with the parity gates (None = a
    gate failed)."""
    lr, lp = len(read), len(path)
    if end_i < 0 or end_j < 0 or end_i > lr or end_j > lp or width < 4:
        return None
    w2 = width // 2
    u_end = end_j - end_i - delta + w2
    if u_end <= 0 or u_end >= width - 1:
        return None
    H = np.zeros((end_i + 1, width), np.int32)
    uidx = np.arange(width)
    decay = -GAP * uidx.astype(np.int32)
    for i in range(1, end_i + 1):
        j_of_u = i + delta - w2 + uidx
        in_path = (j_of_u >= 1) & (j_of_u <= lp)
        pc = path[np.clip(j_of_u - 1, 0, lp - 1)]
        rc = read[i - 1]
        sub = np.where((pc == PAD) | (rc == PAD), _BLOCK,
                       np.where((pc < 4) & (rc < 4) & (pc == rc),
                                MATCH, MISMATCH))
        prev = H[i - 1]
        up = np.concatenate([prev[1:], [_BLOCK]])
        c = np.maximum(0, np.maximum(prev + sub, up + GAP))
        c = np.where(in_path, c, 0)
        row = np.maximum.accumulate(c + decay) - decay
        H[i] = np.where(in_path, row, 0)
    i, u = end_i, u_end
    if int(H[i, u]) != expected:
        return None
    score = int(H[i, u])
    ops: List[str] = []
    matches = 0
    nm = 0
    while i > 0 and H[i, u] > 0:
        if u <= 0 or u >= width - 1:
            return None
        j = i + delta - w2 + u
        if j <= 0:
            break
        sub = MATCH if (read[i - 1] == path[j - 1] and read[i - 1] < 4) else MISMATCH
        if H[i, u] == H[i - 1, u] + sub:
            ops.append("=" if sub == MATCH else "X")
            if sub == MATCH:
                matches += 1
            else:
                nm += 1
            i -= 1
        elif H[i, u] == H[i - 1, u + 1] + GAP:
            ops.append("I")
            nm += 1
            i -= 1
            u += 1
        elif H[i, u] == H[i, u - 1] + GAP:
            ops.append("D")
            nm += 1
            u -= 1
        else:
            break
    if u <= 0 or u >= width - 1:
        return None
    ops.reverse()
    j = i + delta - w2 + u
    return score, i, max(0, j), matches, nm, "".join(ops)


def _traceback_py(read: np.ndarray, path: np.ndarray,
                  end_i: int, end_j: int) -> Placement:
    # cells beyond (end_i, end_j) are never consulted by the walk
    H = _matrix(read[:end_i], path[:end_j])
    i, j = end_i, end_j
    score = int(H[i, j])
    ops: List[str] = []
    matches = 0
    nm = 0
    while i > 0 and j > 0 and H[i, j] > 0:
        sub = MATCH if (read[i - 1] == path[j - 1] and read[i - 1] < 4) else MISMATCH
        if H[i, j] == H[i - 1, j - 1] + sub:
            if sub == MATCH:
                ops.append("=")
                matches += 1
            else:
                ops.append("X")
                nm += 1
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j] + GAP:
            ops.append("I")
            nm += 1
            i -= 1
        elif H[i, j] == H[i, j - 1] + GAP:
            ops.append("D")
            nm += 1
            j -= 1
        else:  # local start (c floored at 0 mid-row)
            break
    ops.reverse()
    return Placement(score, i, end_i, j, end_j, _runs(ops), matches, nm)
