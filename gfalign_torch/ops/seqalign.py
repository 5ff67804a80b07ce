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
  * only the selected placements (a handful per read) are tracebacked, by
    recomputing the single pair's DP on the device of the run: the banded
    walks of a placement wave together (`banded_tracebacks`: on CUDA one
    banded-walk kernel launch, on the CPU the native walk a pair); the
    exact full-matrix walk (on CUDA the walk-code kernel, `full_walk`; on
    the CPU the native walk), in bounded memory (row blocks) and, where the
    caller has the ladder's score, over the columns that score leaves
    possible (`walk_window`).

Scoring: match +1, mismatch -2, gap -3 (linear).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..utils import profiling

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

# Tracebacks by route: the native C++ walks, the plain versions below, the
# walk-code kernel on CUDA (full walks) or the banded-walk kernel on CUDA
# (banded_cuda: one a banded walk; the registry's counters
# align.traceback.<route>).
TRACEBACK_CALLS = profiling.view(profiling.COUNTS, "align.traceback.",
                                 ("native", "python", "cuda", "banded_cuda"))

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


def _runs(ops) -> List[Tuple[int, str]]:
    """Run-length encode an op sequence (a string or a list of chars)."""
    if not ops:
        return []
    s = ops if isinstance(ops, str) else "".join(ops)
    a = np.frombuffer(s.encode(), np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(a)]]))
    return [(int(c), chr(a[i])) for c, i in zip(counts, starts)]


def walk_codes_ref(read_codes: torch.Tensor, path_codes: torch.Tensor):
    """Plain version of the walk kernel's forward pass (CPU tensors): H row
    by row over read_codes (rows,) x path_codes (cols,), and for every cell the walk's move there, the first that fits of
    1 diagonal (H == H[i-1][j-1] + sub, sub the match iff read == path < 4,
    no PAD case), 2 up (I), 3 left (D); 0 stop (H <= 0, or none fits).
    Returns (H[rows][cols], codes (rows + 1, cols + 1) uint8, row and column
    0 stop)."""
    r = read_codes.to(torch.int32)
    p = path_codes.to(torch.int32)
    rows, cols = r.numel(), p.numel()
    codes = torch.zeros((rows + 1, cols + 1), dtype=torch.uint8)
    prev = torch.zeros((cols + 1,), dtype=torch.int32)
    decay = -GAP * torch.arange(cols, dtype=torch.int32)
    zero = prev[:1]
    for i in range(1, rows + 1):
        rc = int(r[i - 1])
        eq = (p == rc) & (rc < 4)
        sub = torch.where((p == PAD) | (rc == PAD), _BLOCK,
                          torch.where(eq, MATCH, MISMATCH))
        c = torch.clamp(torch.maximum(prev[:-1] + sub, prev[1:] + GAP), min=0)
        row = torch.cummax(c + decay, 0).values - decay
        left = torch.cat([zero, row[:-1]])
        code = torch.where(row == left + GAP, 3, 0)
        code = torch.where(row == prev[1:] + GAP, 2, code)
        code = torch.where(row == prev[:-1] + torch.where(eq, MATCH, MISMATCH),
                           1, code)
        codes[i, 1:] = torch.where(row > 0, code, 0).to(torch.uint8)
        prev = torch.cat([zero, row])
    return int(prev[cols]), codes


def _walk(score: int, codes: torch.Tensor, read: np.ndarray, path: np.ndarray):
    """The walk over walk codes (walk_codes_ref's) from their last cell:
    (score, qstart, pstart, matches, nm, ops)."""
    c = codes.numpy()
    i, j = c.shape[0] - 1, c.shape[1] - 1
    ops: List[str] = []
    matches = nm = 0
    while i > 0 and j > 0:
        move = c[i, j]
        if move == 1:
            eq = read[i - 1] == path[j - 1] and read[i - 1] < 4
            ops.append("=" if eq else "X")
            matches += int(eq)
            nm += int(not eq)
            i -= 1
            j -= 1
        elif move == 2:
            ops.append("I")
            nm += 1
            i -= 1
        elif move == 3:
            ops.append("D")
            nm += 1
            j -= 1
        else:  # local start
            break
    ops.reverse()
    return score, i, j, matches, nm, "".join(ops)


def full_walk(read_codes: torch.Tensor, path_codes: torch.Tensor):
    """(score, qstart, pstart, matches, nm, ops) of the exact full-matrix
    traceback of read_codes (rows,) against path_codes (cols,), int8, from
    their last cell (rows, cols).  CUDA tensors launch the walk-code kernel
    (ops/seqalign_cuda.full_walk_cuda) or raise; CPU tensors take the plain
    version, walk_codes_ref and its walk."""
    if read_codes.is_cuda:
        from . import seqalign_cuda
        return seqalign_cuda.full_walk_cuda(read_codes, path_codes)
    score, codes = walk_codes_ref(read_codes, path_codes)
    return _walk(score, codes, read_codes.numpy(), path_codes.numpy())


def walk_gaps(rows: int, score: int) -> Tuple[int, int]:
    """(D, I): the most deletions and insertions of a local alignment over
    at most `rows` read rows that scores `score` or more.  Its m matches,
    x mismatches and I insertions take m + x + I <= rows rows and it
    scores s = m - 2x - 3I - 3D, so 3x + 4I + 3D <= rows - s: D <=
    (rows - s) // 3 and I <= (rows - s) // 4.  An alignment that ends at
    (end_i, end_j) thus lies within diagonals j - i from end_j - end_i - D
    to end_j - end_i + I.  The full walk's column cut (walk_window) and the
    card's band (ops/seqalign_cuda.walk_band) both rest on this."""
    slack = max(0, rows - int(score))
    return slack // 3, slack // 4


def walk_window(read: np.ndarray, path: np.ndarray, end_i: int, end_j: int,
                score=None) -> int:
    """The first column c0 of the rectangle that a walk from (end_i, end_j)
    needs when the caller knows a score at most H[end_i][end_j] (the
    ladder's): 0 without one.

    A local alignment that ends at (end_i, end_j) with score s >= score
    starts at a column no earlier than end_j - end_i - D (walk_gaps), c0
    below.  Every cell of the walk, and every neighbour whose move test
    fits, lies on such an alignment (the walk's moves telescope to its
    score), so over path[c0:end_j], with column c0 taken as 0, the walk
    sees the same values and takes the same moves.  The one exception is
    the walk's diagonal test on a PAD cell, which takes -2 where the
    recurrence took the block score: it can fit a neighbour whose value the
    cut lowered.  So a rectangle with a PAD (a read masked by an earlier
    placement) takes no cut.  `traceback` checks the cut walk's score
    against `score` and walks again uncut below it."""
    if score is None or score <= 0 or end_i <= 0 or end_j <= 0:
        return 0
    c0 = end_j - end_i - walk_gaps(end_i, score)[0]
    if c0 <= 0 or (read[:end_i] == PAD).any() or (path[:end_j] == PAD).any():
        return 0
    return int(c0)


def traceback(read: np.ndarray, path: np.ndarray,
              end_i: int, end_j: int, device="cpu", score=None) -> Placement:
    """Recompute the pair DP and walk back from (end_i, end_j) to H==0.

    With `score`, a lower bound on H[end_i][end_j] (the ladder's score of
    the pair), the walk runs over the columns `walk_window` leaves, and
    again over the whole rectangle should its score come out below it (the
    bound did not hold): the same Placement either way.

    The device of the align run picks the route.  On CUDA the walk runs on
    the card (`full_walk`: the rectangle's read and path chars go up in one
    copy, the result comes back in one).  Elsewhere the native C++ walk
    (io/native.local_traceback) runs; the plain walk (`full_walk` on CPU
    tensors) is its oracle, taken when `native.available()` is false or
    the walk declines.  Both devices walk a large rectangle in row blocks, in
    bounded memory (ops/seqalign_cuda.walk_plan, the native walk's
    budget)."""
    if not (0 <= end_i <= len(read) and 0 <= end_j <= len(path)):
        raise ValueError(f"end cell ({end_i}, {end_j}) outside the "
                         f"{len(read)} x {len(path)} matrix")
    profiling.count("align.traceback.full_cells", end_i * end_j)
    c0 = walk_window(read, path, end_i, end_j, score)
    if c0:
        pl = _walk_route(read[:end_i], path[c0:end_j], device)
        if pl.score >= score:
            return pl._replace(pstart=pl.pstart + c0, pend=end_j)
    return _walk_route(read[:end_i], path[:end_j], device)


def _walk_route(read: np.ndarray, path: np.ndarray, device) -> Placement:
    """The full walk of read against path from their last cell, on the
    route of `device`."""
    from ..io import native

    end_i, end_j = len(read), len(path)
    cuda = torch.device(device).type == "cuda"
    res = None
    if not cuda and native.available():
        profiling.count("align.traceback.native")
        res = native.local_traceback(read, path, end_i, end_j,
                                     MATCH, MISMATCH, GAP, PAD, _BLOCK)
    if res is None:
        # the card's walk, or the plain walk on CPU tensors
        profiling.count("align.traceback." + ("cuda" if cuda else "python"))
        seq = torch.from_numpy(np.concatenate(
            [read, path]).astype(np.int8, copy=False)).to(device)
        res = full_walk(seq[:end_i], seq[end_i:])
    return _placement(res, end_i, end_j)


def band_end(lr: int, lp: int, end_i: int, end_j: int, delta: int,
             width: int):
    """The lane of (end_i, end_j) in the band of `width` lanes around
    diagonal delta, for a read of lr and a path of lp chars, or None where
    the walk is declined before any work: the cell lies outside the matrix
    or on or off the band's edge, or the band is under 4 lanes."""
    if not (0 <= end_i <= lr and 0 <= end_j <= lp) or width < 4:
        return None
    u_end = end_j - end_i - delta + width // 2
    return u_end if 0 < u_end < width - 1 else None


def band_codes_ref(read_codes: torch.Tensor, path_codes: torch.Tensor,
                   delta: int, width: int):
    """Plain version of the banded walk's forward pass (CPU tensors): K3's
    banded recurrence over read_codes (rows,) against path_codes (cols,),
    H[i][u] at j = i + delta - width//2 + u (the diagonal keeps its lane,
    'up' from lane u + 1, blocked at the last lane, cells with j outside
    [1, cols] 0, a PAD on either side _BLOCK), and for every cell the
    walk's move there, the first that fits of 1 diagonal (H ==
    H[i-1][u] + sub, sub the match iff read == path < 4, no PAD case),
    2 up (H == H[i-1][u+1] + GAP), 3 left (H == H[i][u-1] + GAP); 0 stop
    (H <= 0, or none fits).  Returns (H[rows] (width,), codes
    (rows + 1, width) uint8, row 0 stop)."""
    r = read_codes.to(torch.int32)
    p = path_codes.to(torch.int32)
    rows, cols = r.numel(), p.numel()
    u = torch.arange(width, dtype=torch.int32)
    decay = -GAP * u
    block = torch.full((1,), _BLOCK, dtype=torch.int32)
    none = torch.full((1,), -_BIG, dtype=torch.int32)   # no left of lane 0
    codes = torch.zeros((rows + 1, width), dtype=torch.uint8)
    prev = torch.zeros((width,), dtype=torch.int32)
    for i in range(1, rows + 1):
        j = i + delta - width // 2 + u
        in_path = (j >= 1) & (j <= cols)
        pc = torch.full((width,), PAD, dtype=torch.int32)
        pc[in_path] = p[j[in_path] - 1]
        rc = int(r[i - 1])
        eq = (pc == rc) & (rc < 4)
        sub = torch.where((pc == PAD) | (rc == PAD), _BLOCK,
                          torch.where(eq, MATCH, MISMATCH))
        up = torch.cat([prev[1:], block])
        c = torch.clamp(torch.maximum(prev + sub, up + GAP), min=0)
        c = torch.where(in_path, c, 0)
        row = torch.where(in_path, torch.cummax(c + decay, 0).values - decay, 0)
        left = torch.cat([none, row[:-1]])
        code = torch.where(row == left + GAP, 3, 0)
        code = torch.where(row == up + GAP, 2, code)
        code = torch.where(row == prev + torch.where(eq, MATCH, MISMATCH), 1, code)
        codes[i] = torch.where(row > 0, code, 0).to(torch.uint8)
        prev = row
    return prev, codes


def _band_walk(codes: np.ndarray, read: np.ndarray, path: np.ndarray,
               end_i: int, u_end: int, delta: int, width: int):
    """The walk over band codes (band_codes_ref's) from (end_i, u_end):
    (qstart, pstart, matches, nm, ops), or None where it touches lane 0 or
    lane width - 1."""
    i, u, w2 = end_i, u_end, width // 2
    ops: List[str] = []
    matches = nm = 0
    while True:
        if u <= 0 or u >= width - 1:
            return None
        move = codes[i, u]   # row 0 stops
        if move == 1:
            rc = read[i - 1]
            eq = rc == path[i - 1 + delta - w2 + u] and rc < 4
            ops.append("=" if eq else "X")
            matches += int(eq)
            nm += int(not eq)
            i -= 1
        elif move == 2:
            ops.append("I")
            nm += 1
            i -= 1
            u += 1
        elif move == 3:
            ops.append("D")
            nm += 1
            u -= 1
        else:  # a local start, or row 0
            break
    ops.reverse()
    return i, max(0, i + delta - w2 + u), matches, nm, "".join(ops)


def banded_walk_ref(read: np.ndarray, path: np.ndarray, end_i: int,
                    end_j: int, delta: int, width: int, expected: int):
    """Plain version of the banded walk (band_codes_ref and its walk), with
    the parity gates: (score, qstart, pstart, matches, nm, ops), or None
    where the end lies off the band or a gate declines."""
    u_end = band_end(len(read), len(path), end_i, end_j, delta, width)
    if u_end is None:
        return None
    last, codes = band_codes_ref(torch.from_numpy(np.asarray(read[:end_i])),
                                 torch.from_numpy(np.asarray(path[:end_j])),
                                 delta, width)
    score = int(last[u_end])
    if score != expected:
        return None
    walk = _band_walk(codes.numpy(), read, path, end_i, u_end, delta, width)
    return None if walk is None else (score, *walk)


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
    (io/native.banded_local_traceback); the plain version, banded_walk_ref,
    is its oracle, taken when `native.available()` is false."""
    from ..io import native

    if native.available():
        profiling.count("align.traceback.native")
        res = native.banded_local_traceback(read, path, end_i, end_j, delta,
                                            width, expected, MATCH, MISMATCH,
                                            GAP, PAD, _BLOCK)
    else:
        profiling.count("align.traceback.python")
        res = banded_walk_ref(read, path, end_i, end_j, delta, width, expected)
    return _placement(res, end_i, end_j)


def _placement(res, end_i: int, end_j: int):
    if res is None:
        return None
    score, qstart, pstart, matches, nm, ops = res
    return Placement(score, qstart, end_i, pstart, end_j,
                     _runs(ops), matches, nm)


def banded_tracebacks(walks, device="cpu") -> list:
    """banded_traceback of every walk of `walks` (its arguments each), on
    the device of the run: on CUDA the banded-walk kernel takes them all
    (ops/seqalign_cuda.banded_walks_cuda: one launch for a wave whose band
    codes fit its budget), elsewhere banded_traceback walks them one by
    one.  A Placement, or None where the walk declined, a walk."""
    if torch.device(device).type != "cuda":
        return [banded_traceback(*walk) for walk in walks]
    from . import seqalign_cuda

    profiling.count("align.traceback.banded_cuda", len(walks))
    return [_placement(res, walk[2], walk[3]) for res, walk in
            zip(seqalign_cuda.banded_walks_cuda(walks, device), walks)]
