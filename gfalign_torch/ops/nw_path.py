"""Needleman-Wunsch alignment over *paths of (node, orientation) steps*.

This is the hottest function of the framework: the tangle search re-scores
every read path against every candidate path expansion
(reference src/eval.cpp:92-93 inside the search loop at :134-189).

Exact-semantics contract (derived from reference src/alignments.cpp:499-554
and the dp-matrix reuse in src/eval.cpp:79; see SURVEY.md section 4 quirk 5):

  * A = candidate path (length n), B = read path (length m);
  * dp row 0 is initialized as j*gap for j <= n and stays 0 for j > n (the
    reference initializes the row over A's extent, not B's);
  * dp column 0 is all 0 (free leading candidate-gap);
  * vertical moves in the last column are free (free trailing candidate-gap):
    dp[i][j] = max(dp[i-1][j-1]+S, dp[i-1][j] + (gap if j<m else 0),
                   dp[i][j-1] + gap);
  * the reported score is NOT dp[n][m] but is recomputed during traceback:
    diagonal adds S; a vertical move subtracts 1 only if some B step was
    already emitted (so trailing candidate-overhang is free); a horizontal
    move subtracts 1; border moves (ii==0 or jj==0) are free;
  * traceback prefers diagonal, then vertical when
    dp[ii-1][jj] >= dp[ii][jj-1], else horizontal.

Two implementations of the score:
  * a pure-Python oracle (reference behavior, used for byte-parity printing);
  * a batched tensor version.  `nw_pair_scores` / `nw_best_scores` send a
    CUDA tensor to the hand-written kernels of ops/nw_cuda.py and a CPU
    tensor to the plain PyTorch version (`nw_pair_scores_ref`,
    `nw_best_scores_ref`), which stays callable by name on any device so
    the kernels can be held against it on the card.  `scores_prepared`
    does the same against a read operand prepared once (nw_cuda.ReadOperand:
    both orientations, length-sorted, transposed), which is how the search
    scores every frontier.  The plain version is the row formulation: each
    dp row is one int32 `cummax` over (candidate + j), batched over
    candidates and reads, and the traceback is replaced by forward
    propagation of the walk's exit column.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Step(NamedTuple):
    id: int
    orientation: str  # '+', '-', or '0' (undetermined start)


def revcomp_path(path: Sequence[Step]) -> List[Step]:
    """Reverse the step order and flip orientations.  Note the reference
    maps any non-'+' orientation (including '0') to '+'
    (include/alignments.h:64-70)."""
    return [Step(s.id, "-" if s.orientation == "+" else "+") for s in reversed(path)]


# ---------------------------------------------------------------------------
# Oracle (host, exact reference behavior, also returns the aligned pair)
# ---------------------------------------------------------------------------


class PathAlignment(NamedTuple):
    a: List[Step]   # candidate row with gap steps (id == -1)
    b: List[Step]   # read row with gap steps
    score: int


def _nw_matrix(a: Sequence[Step], b: Sequence[Step],
               match: int, mismatch: int, gap: int) -> np.ndarray:
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, max(n, m) + 1), dtype=np.int64)
    for j in range(0, n + 1):          # row-0 extent quirk: over n, not m
        dp[0, j] = j * gap
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = match if a[i - 1] == b[j - 1] else mismatch
            dp[i, j] = max(dp[i - 1, j - 1] + s,
                           dp[i - 1, j] + (gap if j < m else 0),
                           dp[i, j - 1] + gap)
    return dp


def nw_align_oracle(a: Sequence[Step], b: Sequence[Step],
                    match: int = 0, mismatch: int = -1, gap: int = -1) -> PathAlignment:
    a = [Step(s[0], s[1]) for s in a]
    b = [Step(s[0], s[1]) for s in b]
    dp = _nw_matrix(a, b, match, mismatch, gap)
    n, m = len(a), len(b)
    sa: List[Step] = []
    sb: List[Step] = []
    score = 0
    sblen = 0
    ii, jj = n, m
    while ii != 0 or jj != 0:
        if ii == 0:
            sa.append(Step(-1, "0"))
            sb.append(b[jj - 1])
            jj -= 1
        elif jj == 0:
            sa.append(a[ii - 1])
            sb.append(Step(-1, "0"))
            ii -= 1
        else:
            s = match if a[ii - 1] == b[jj - 1] else mismatch
            if dp[ii, jj] == dp[ii - 1, jj - 1] + s:
                sa.append(a[ii - 1])
                sb.append(b[jj - 1])
                sblen += 1
                ii -= 1
                jj -= 1
                score += s
            elif dp[ii - 1, jj] >= dp[ii, jj - 1]:
                sa.append(a[ii - 1])
                sb.append(Step(-1, "0"))
                ii -= 1
                if sblen > 0:
                    score -= 1
            else:
                sa.append(Step(-1, "0"))
                sb.append(b[jj - 1])
                sblen += 1
                jj -= 1
                score -= 1
    sa.reverse()
    sb.reverse()
    return PathAlignment(sa, sb, score)


def nw_score_oracle(a: Sequence[Step], b: Sequence[Step]) -> int:
    return nw_align_oracle(a, b).score


# ---------------------------------------------------------------------------
# Batched tensor implementation
# ---------------------------------------------------------------------------
#
# Encoding: a step is one int32 key = id * 4 + orientation code
# (0='+', 1='-', 2='0'); pads are negative and never match (candidate pads
# -1, read pads -2).

ORIENT_CODE = {"+": 0, "-": 1, "0": 2}

# Plain-version working set: the (C, R, m+1) rows are processed in candidate
# chunks of at most this many elements.
_REF_CHUNK_ELEMS = 1 << 24


def _encode(ids: np.ndarray, orients: np.ndarray, pad_key: int) -> np.ndarray:
    keys = ids.astype(np.int64) * 4 + orients.astype(np.int64)
    keys = np.where(ids < 0, pad_key, keys)
    return keys.astype(np.int32)


def encode_steps(steps: Sequence[Step], pad_to: int, pad_key: int = -1) -> Tuple[np.ndarray, int]:
    ids = np.full((pad_to,), -1, dtype=np.int32)
    orients = np.zeros((pad_to,), dtype=np.int8)
    for i, s in enumerate(steps):
        ids[i] = s.id
        orients[i] = ORIENT_CODE[s.orientation]
    return _encode(ids, orients, pad_key), len(steps)


def rc_keys_device(b_keys: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """Reverse-complement encoded read paths on the tensors' device: reverse
    each row's valid prefix and flip the orientation code ('-'<->'+',
    '0'->'+'); everything else becomes the read pad -2."""
    R, m = b_keys.shape
    jidx = torch.arange(m, dtype=torch.int32, device=b_keys.device)[None, :]
    src = b_len.to(torch.int32)[:, None] - 1 - jidx      # reversed index
    gathered = torch.gather(b_keys, 1, src.clamp(0, m - 1).long())
    flipped = (gathered % 4 == 0).to(torch.int32)
    out = torch.div(gathered, 4, rounding_mode="floor") * 4 + flipped
    keep = (src >= 0) & (gathered >= 0)
    return torch.where(keep, out, torch.full_like(out, -2)).to(torch.int32)


def _forward_exit_scores(a_keys, a_len, b_keys, b_len):
    """Forward DP that also propagates the traceback EXIT COLUMN — the
    whole score comes out of one scan, no walk.

    Telescoping proof (why only the exit column is needed): every
    traceback move is dp-consistent, and the interior traceback costs
    equal the dp costs (at a vertical move in column jj, sblen == m - jj,
    so 'sblen > 0' and 'jj < m' coincide).  Telescoping along the walk:
    score = dp[n][m] - dp[0][j_exit], where j_exit is the column at which
    the walk first leaves the interior (0 when it exits via column 0) and
    dp[0][j] = -j for j <= n, 0 beyond (the row-0 extent quirk).

    E(i, j) := exit column of the walk STARTING at (i, j):
      E(0, j) = j;  E(i, 0) = 0;  otherwise E(successor by the walk's
      move priority: diagonal, then up, then left).  Diagonal/up
      successors live on the previous row; LEFT successors chain within
      the current row to the nearest non-left cell (or column 0), which
      one cummax (last non-left position) + one gather resolves.

    a_keys: (C, n), a_len: (C,), b_keys: (R, m), b_len: (R,), all int32
    on one device; returns (C, R) int32 scores.  Rows past a candidate's
    length never reach its score, so the scan stops at max(a_len)."""
    C = a_keys.shape[0]
    R, m = b_keys.shape
    dev = b_keys.device
    i32 = torch.int32
    jidx = torch.arange(m + 1, dtype=i32, device=dev)
    a_len = a_len.to(i32)
    # (C, 1, m+1) row 0 (the extent quirk) and its exit columns
    row = torch.where(jidx[None, :] <= a_len[:, None], -jidx[None, :],
                      torch.zeros((), dtype=i32, device=dev))[:, None, :]
    row = row.expand(C, R, m + 1)
    row_e = jidx.expand(C, R, m + 1)
    gapv = torch.where(jidx[None, 1:] < b_len.to(i32)[:, None], -1, 0).to(i32)
    blen_idx = b_len.long()[None, :, None].expand(C, R, 1)
    zero_col = torch.zeros((C, R, 1), dtype=i32, device=dev)
    one_col = torch.ones((C, R, 1), dtype=torch.bool, device=dev)
    dp_fin = torch.gather(row, 2, blen_idx)[..., 0]
    e_fin = torch.gather(row_e, 2, blen_idx)[..., 0]
    n_rows = int(a_len.max()) if C else 0
    for i in range(n_rows):
        s = torch.where(b_keys[None, :, :] == a_keys[:, i, None, None], 0, -1).to(i32)
        cand = torch.maximum(row[..., :-1] + s, row[..., 1:] + gapv)
        c = torch.cat([zero_col, cand], dim=2)
        new = torch.cummax(c + jidx, dim=2).values - jidx
        diag = new[..., 1:] == row[..., :-1] + s
        up = row[..., 1:] >= new[..., :-1]
        e_fresh = torch.where(diag, row_e[..., :-1], row_e[..., 1:])
        e_cand = torch.cat([zero_col, e_fresh], dim=2)
        nonleft = torch.cat([one_col, diag | up], dim=2)
        last = torch.cummax(torch.where(nonleft, jidx, 0).to(i32), dim=2).values
        new_e = torch.gather(e_cand, 2, last.long())
        hit = (a_len == i + 1)[:, None]
        dp_fin = torch.where(hit, torch.gather(new, 2, blen_idx)[..., 0], dp_fin)
        e_fin = torch.where(hit, torch.gather(new_e, 2, blen_idx)[..., 0], e_fin)
        row, row_e = new, new_e
    corr = torch.where(e_fin <= a_len[:, None], e_fin, 0)
    return (dp_fin + corr).to(i32)


def nw_pair_scores_ref(a_keys, a_len, b_keys, b_len):
    """Plain PyTorch traceback scores for every (candidate, read) pair, on
    the tensors' own device.

    a_keys: (C, n) int32, a_len: (C,), b_keys: (R, m), b_len: (R,)
    -> (C, R) int32."""
    C = a_keys.shape[0]
    R, m = b_keys.shape
    out = torch.zeros((C, R), dtype=torch.int32, device=b_keys.device)
    if C == 0 or R == 0:
        return out
    step = max(1, _REF_CHUNK_ELEMS // (R * (m + 1)))
    for c0 in range(0, C, step):
        out[c0:c0 + step] = _forward_exit_scores(
            a_keys[c0:c0 + step], a_len[c0:c0 + step], b_keys, b_len)
    return out


def nw_pair_scores(a_keys, a_len, b_keys, b_len):
    """(C, R) traceback scores: the CUDA kernels for CUDA tensors (they
    launch or raise), the plain version for CPU tensors."""
    if b_keys.is_cuda:
        from . import nw_cuda

        return nw_cuda.nw_pair_scores_cuda(a_keys, a_len, b_keys, b_len)
    return nw_pair_scores_ref(a_keys, a_len, b_keys, b_len)


def nw_best_scores_ref(a_keys, a_len, b_keys, b_len):
    """max(forward, reverse-complement) scores, (C, R) int32, through the
    plain version on any device: the fw and rc read batches are stacked
    into one 2R-row scoring pass."""
    both = torch.cat([b_keys, rc_keys_device(b_keys, b_len)], dim=0)
    both_len = torch.cat([b_len, b_len], dim=0)
    scores = nw_pair_scores_ref(a_keys, a_len, both, both_len)
    R = b_keys.shape[0]
    return torch.maximum(scores[:, :R], scores[:, R:])


def nw_best_scores(a_keys, a_len, b_keys, b_len):
    """max(forward, reverse-complement) scores, (C, R) int32: the CUDA
    kernels for CUDA tensors (one pass over a read operand prepared for
    this call; they launch or raise), the plain version for CPU tensors."""
    if b_keys.is_cuda:
        from . import nw_cuda

        return nw_cuda.nw_best_scores_cuda(a_keys, a_len, b_keys, b_len)
    return nw_best_scores_ref(a_keys, a_len, b_keys, b_len)


def scores_prepared_ref(a_keys, a_len, operand):
    """Plain-version scores against a prepared read operand
    (nw_cuda.ReadOperand), (C, Rp) int32 in the operand's row order, on
    the operand's device: forward scores, or max(forward,
    reverse-complement) when the operand holds both planes."""
    planes = [nw_pair_scores_ref(a_keys, a_len, operand.plane(o), operand.b_len)
              for o in range(operand.ns)]
    return planes[0] if len(planes) == 1 else torch.maximum(*planes)


def scores_prepared(a_keys, a_len, operand):
    """Scores against a prepared read operand, (C, Rp) int32 in the
    operand's row order: the CUDA kernels for a CUDA operand (they launch
    or raise), the plain version for a CPU one."""
    if operand.device.type == "cuda":
        from . import nw_cuda

        return nw_cuda.scores_prepared(a_keys, a_len, operand)
    return scores_prepared_ref(a_keys, a_len, operand)


def pad_pow2(x: int, floor: int = 8) -> int:
    return max(floor, int(2 ** np.ceil(np.log2(max(x, 1)))))


def pad_bucket(x: int, floor: int = 8) -> int:
    """Geometric ~1.25x buckets rounded up to multiples of 8: the frontier
    (candidate) axis wastes at most ~25% padded compute vs pow2's ~2x.
    The search hot loop's scoring cost is proportional to the PADDED
    candidate count."""
    b = floor
    while b < x:
        b = -(-max(b + 8, int(b * 1.25)) // 8) * 8
    return b


def encode_path_batch(paths: Sequence[Sequence[Step]], pad_to: int,
                      pad_key: int = -2) -> Tuple[np.ndarray, np.ndarray]:
    keys = np.stack([encode_steps(p, pad_to, pad_key)[0] for p in paths]) \
        if paths else np.zeros((0, pad_to), np.int32)
    lens = np.array([len(p) for p in paths], dtype=np.int32)
    return keys, lens


def batched_best_scores(candidates: Sequence[Sequence[Step]],
                        read_paths: Sequence[Sequence[Step]],
                        device="cuda", read_chunk: int = 1024) -> np.ndarray:
    """Host wrapper: encode with power-of-two widths, score the reads in
    chunks on `device`, and return (C, R) int32 best scores."""
    if not candidates or not read_paths:
        return np.zeros((len(candidates), len(read_paths)), dtype=np.int32)
    device = torch.device(device)
    n_max = pad_pow2(max(len(c) for c in candidates))
    m_max = pad_pow2(max(len(r) for r in read_paths))
    a_keys, a_len = encode_path_batch(
        [[Step(*s) for s in c] for c in candidates], n_max, pad_key=-1)
    b_keys, b_len = encode_path_batch(
        [[Step(*s) for s in r] for r in read_paths], m_max, pad_key=-2)
    ak = torch.from_numpy(a_keys).to(device)
    al = torch.from_numpy(a_len).to(device)
    chunk = max(8, read_chunk)
    outs = []
    for start in range(0, b_keys.shape[0], chunk):
        bk = torch.from_numpy(b_keys[start:start + chunk]).to(device)
        bl = torch.from_numpy(b_len[start:start + chunk]).to(device)
        outs.append(nw_best_scores(ak, al, bk, bl).cpu().numpy())
    return np.concatenate(outs, axis=1).astype(np.int32)
