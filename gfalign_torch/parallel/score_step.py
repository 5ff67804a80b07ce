"""Frontier scoring step: NW scores, the membership filter and the
(bad, good, unaligned) tallies of a whole frontier, on the tensors' device.

This is the JAX package's per-device step (gfalign_tpu/parallel/
score_step.py `_local_step`); its mesh and shard_map wrapping are a later
slice.  Only the (C, 3) tallies leave the device.
"""

from __future__ import annotations

import torch

from ..ops.nw_path import nw_best_scores

# membership working set: the (C, R, m) intermediate is built in candidate
# chunks of at most this many elements
_MEMBER_CHUNK_ELEMS = 1 << 24


def _offending_steps(a_keys: torch.Tensor, b_keys: torch.Tensor) -> torch.Tensor:
    """(C, R) count of each read's steps whose node is not on the candidate
    (reference src/eval.cpp:81-91).  Binary search against each candidate's
    sorted id list keeps the intermediate at (C, R, m); the naive
    broadcast-compare would build a (C, R, m, n) bool."""
    C, n = a_keys.shape
    R, m = b_keys.shape
    a_ids = torch.where(a_keys >= 0, torch.div(a_keys, 4, rounding_mode="floor"), -1)
    b_ids = torch.where(b_keys >= 0, torch.div(b_keys, 4, rounding_mode="floor"), -2)
    a_sorted = torch.sort(a_ids, dim=1).values.contiguous()
    flat = b_ids.reshape(1, R * m)
    valid = (b_ids >= 0)[None]
    out = torch.empty((C, R), dtype=torch.int64, device=a_keys.device)
    step = max(1, _MEMBER_CHUNK_ELEMS // max(R * m, 1))
    for c0 in range(0, C, step):
        cs = a_sorted[c0:c0 + step]
        q = flat.expand(cs.shape[0], R * m).contiguous()
        idx = torch.searchsorted(cs, q, out_int32=True).clamp_(max=n - 1)
        member = torch.gather(cs, 1, idx.long()) == q
        out[c0:c0 + step] = (valid & ~member.view(-1, R, m)).sum(-1)
    return out


def local_step(a_keys: torch.Tensor, a_len: torch.Tensor, b_keys: torch.Tensor,
               b_len: torch.Tensor, filter_alignments: bool) -> torch.Tensor:
    """(C, 3) int32 [bad, good, unaligned] of candidates a (C, n) against
    reads b (R, m).  Reads with b_len == 0 are padding and count nowhere.
    With filter_alignments, a read with any step off the candidate is
    dropped and its offending steps count as unaligned; without it every
    real read is kept and unaligned is 0."""
    scores = nw_best_scores(a_keys, a_len, b_keys, b_len)        # (C, R)
    real = (b_len > 0)[None, :]
    if filter_alignments:
        off = _offending_steps(a_keys, b_keys)
        keep = (off == 0) & real
        unaligned = torch.where(real, off, 0).sum(-1)
    else:
        keep = real.expand_as(scores)
        unaligned = torch.zeros(scores.shape[0], dtype=torch.int64,
                                device=scores.device)
    bad = ((scores < 0) & keep).sum(-1)
    good = ((scores >= 0) & keep).sum(-1)
    return torch.stack([bad, good, unaligned], dim=-1).to(torch.int32)
