"""Frontier scoring step: NW scores, the membership filter and the
(bad, good, unaligned) tallies of a whole frontier, on the tensors' device.

This is the JAX package's per-device step (gfalign_tpu/parallel/
score_step.py `_local_step`); its mesh and shard_map wrapping are a later
slice.  Only the (C, 3) tallies leave the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nw_cuda import BLOCK_R, ReadOperand
from ..ops.nw_path import nw_best_scores, scores_prepared

# membership working set: the (C, R, m) intermediate is built in candidate
# chunks of at most this many elements
_MEMBER_CHUNK_ELEMS = 1 << 24


class ReadSide(NamedTuple):
    """What the filter and the tallies need of the reads, in one row order."""
    b_ids: torch.Tensor    # (R, m) node ids of the read keys, -2 at pads
    valid: torch.Tensor    # (1, R, m) b_ids >= 0
    real: torch.Tensor     # (1, R) b_len > 0: not padding


def read_side(b_keys: torch.Tensor, b_len: torch.Tensor) -> ReadSide:
    b_ids = torch.where(b_keys >= 0, torch.div(b_keys, 4, rounding_mode="floor"), -2)
    return ReadSide(b_ids, (b_ids >= 0)[None], (b_len > 0)[None, :])


class PreparedReads(NamedTuple):
    """A read batch prepared once for every frontier call of a search: the
    scorer's operand (both orientations, length-sorted, transposed) and the
    membership filter's view of the same rows in the same order."""
    operand: ReadOperand
    side: ReadSide


def prepare_reads(b_keys: torch.Tensor, b_len: torch.Tensor,
                  block_rows: int = BLOCK_R) -> PreparedReads:
    operand = ReadOperand(b_keys, b_len, block_rows=block_rows)
    return PreparedReads(operand, read_side(operand.keys, operand.b_len))


def _offending_steps(a_keys: torch.Tensor, side: ReadSide) -> torch.Tensor:
    """(C, R) count of each read's steps whose node is not on the candidate
    (reference src/eval.cpp:81-91).  Binary search against each candidate's
    sorted id list keeps the intermediate at (C, R, m); the naive
    broadcast-compare would build a (C, R, m, n) bool."""
    C, n = a_keys.shape
    R, m = side.b_ids.shape
    a_ids = torch.where(a_keys >= 0, torch.div(a_keys, 4, rounding_mode="floor"), -1)
    a_sorted = torch.sort(a_ids, dim=1).values.contiguous()
    flat = side.b_ids.reshape(1, R * m)
    out = torch.empty((C, R), dtype=torch.int64, device=a_keys.device)
    step = max(1, _MEMBER_CHUNK_ELEMS // max(R * m, 1))
    for c0 in range(0, C, step):
        cs = a_sorted[c0:c0 + step]
        q = flat.expand(cs.shape[0], R * m).contiguous()
        idx = torch.searchsorted(cs, q, out_int32=True).clamp_(max=n - 1)
        member = torch.gather(cs, 1, idx.long()) == q
        out[c0:c0 + step] = (side.valid & ~member.view(-1, R, m)).sum(-1)
    return out


def _tallies(scores: torch.Tensor, a_keys: torch.Tensor, side: ReadSide,
             filter_alignments: bool) -> torch.Tensor:
    """(C, 3) int32 [bad, good, unaligned] from (C, R) best scores.  The
    tallies are sums over reads, so any row order serves as long as the
    scores and the read side share it."""
    if filter_alignments:
        off = _offending_steps(a_keys, side)
        keep = (off == 0) & side.real
        unaligned = torch.where(side.real, off, 0).sum(-1)
    else:
        keep = side.real.expand_as(scores)
        unaligned = torch.zeros(scores.shape[0], dtype=torch.int64,
                                device=scores.device)
    bad = ((scores < 0) & keep).sum(-1)
    good = ((scores >= 0) & keep).sum(-1)
    return torch.stack([bad, good, unaligned], dim=-1).to(torch.int32)


def local_step(a_keys: torch.Tensor, a_len: torch.Tensor, b_keys: torch.Tensor,
               b_len: torch.Tensor, filter_alignments: bool) -> torch.Tensor:
    """(C, 3) int32 [bad, good, unaligned] of candidates a (C, n) against
    reads b (R, m).  Reads with b_len == 0 are padding and count nowhere.
    With filter_alignments, a read with any step off the candidate is
    dropped and its offending steps count as unaligned; without it every
    real read is kept and unaligned is 0."""
    scores = nw_best_scores(a_keys, a_len, b_keys, b_len)        # (C, R)
    return _tallies(scores, a_keys, read_side(b_keys, b_len), filter_alignments)


def local_step_prepared(a_keys: torch.Tensor, a_len: torch.Tensor,
                        reads: PreparedReads, filter_alignments: bool) -> torch.Tensor:
    """`local_step` against reads prepared by `prepare_reads`: scores,
    filter and tallies all stay in the operand's row order, and nothing
    that depends only on the reads is computed here."""
    scores = scores_prepared(a_keys, a_len, reads.operand)       # (C, Rp)
    return _tallies(scores, a_keys, reads.side, filter_alignments)
