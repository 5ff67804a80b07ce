"""Candidate-path scoring against read alignment paths.

Equivalent of the reference's evaluatePath (src/eval.cpp:63-108): optionally
drop reads touching nodes outside the candidate (counting `unaligned` per
offending step), NW-align each remaining read forward and reverse-complement,
classify best score < 0 as bad else good.

The batched entry point scores a whole frontier of candidates in one device
step (parallel/score_step.local_step: scores, membership filter and tallies
all on the device; only the (C, 3) tallies come back).  The reference
re-scores sequentially per expansion; scores are deterministic per
candidate, so batching preserves output parity.  Read paths are packed once
into a ReadBatch that keeps them on the device as a prepared read operand
(both orientations, sorted by length, transposed), so a frontier call
uploads only its candidates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.nw_cuda import BLOCK_R
from ..ops.nw_path import (ORIENT_CODE, Step, encode_path_batch,
                           nw_align_oracle, nw_pair_scores, pad_bucket,
                           pad_pow2, revcomp_path)
from ..parallel.score_step import local_step_prepared, prepare_reads
from ..utils.profiling import span


@dataclass
class PathScore:
    bad: int = 0
    good: int = 0
    unaligned: int = 0


class ReadBatch:
    """Read paths packed once: padded encoded keys (id * 4 + orientation
    code, pad -2), their lengths, and a device-resident copy for the
    frontier scorer."""

    def __init__(self, read_paths: Sequence[Sequence[Step]], device="cuda"):
        R = len(read_paths)
        m_max = pad_pow2(max((len(p) for p in read_paths), default=1))
        keys = np.full((R, m_max), -2, dtype=np.int32)
        lengths = np.zeros((R,), dtype=np.int32)
        for i, p in enumerate(read_paths):
            lengths[i] = len(p)
            for j, s in enumerate(p):
                keys[i, j] = s[0] * 4 + ORIENT_CODE[s[1]]
        self._set(keys, lengths, device)

    @classmethod
    def from_arrays(cls, b_keys: np.ndarray, lengths: np.ndarray,
                    ids: np.ndarray, device="cuda") -> "ReadBatch":
        """A batch from the JAX package's packed arrays (its ReadBatch's
        `b_keys`, `lengths` and `ids`), which must describe the same paths."""
        b_keys = np.asarray(b_keys, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        ids = np.asarray(ids)
        valid = np.arange(b_keys.shape[1])[None, :] < lengths[:, None]
        if (ids.shape != b_keys.shape or lengths.shape != b_keys.shape[:1]
                or not np.array_equal(np.where(valid, ids, -1),
                                      np.where(valid, b_keys >> 2, -1))
                or not np.array_equal(b_keys >= 0, valid)):
            raise ValueError("b_keys, lengths and ids describe different paths")
        batch = cls.__new__(cls)
        batch._set(b_keys, lengths, device)
        return batch

    def _set(self, b_keys: np.ndarray, lengths: np.ndarray, device) -> None:
        self.b_keys = b_keys
        self.lengths = lengths
        self.R, self.m = b_keys.shape
        self.device = torch.device(device)
        # empty read paths (GAF path '*') are real reads the device step
        # cannot tell from padding: both score 0 and touch no node, so each
        # is one kept `good` read for every candidate
        self.n_empty = int((lengths == 0).sum())
        self._device = None
        self._prepared = None

    def device_keys(self):
        """Device-resident (b_keys, b_len), uploaded once, rows padded with
        empty reads to a multiple of 8."""
        if self._device is None:
            padn = -self.R % 8
            b_keys = np.concatenate(
                [self.b_keys, np.full((padn, self.m), -2, np.int32)])
            b_len = np.concatenate([self.lengths, np.zeros((padn,), np.int32)])
            self._device = (torch.from_numpy(b_keys).to(self.device),
                            torch.from_numpy(b_len).to(self.device))
        return self._device

    def filter_against(self, candidate_ids: set) -> Tuple[np.ndarray, int]:
        """(keep mask, unaligned count) over the batch's reads, on the host
        (reference src/eval.cpp:81-91): a read is kept when every one of its
        steps lies on a node of `candidate_ids`, and each step that does not
        counts as unaligned.  The oracle of the device membership filter
        (parallel/score_step._offending_steps)."""
        if self.R == 0:
            return np.zeros(0, bool), 0
        valid = self.b_keys >= 0
        ids = np.where(valid, self.b_keys.astype(np.int64) >> 2, -1)
        member = np.isin(ids, np.fromiter(candidate_ids, dtype=np.int64,
                                          count=len(candidate_ids)))
        off_counts = (valid & ~member).sum(axis=1)
        return off_counts == 0, int(off_counts.sum())

    def prepared(self):
        """The reads as the frontier step wants them
        (parallel/score_step.PreparedReads: the scorer's operand with both
        orientations, length-sorted and transposed, and the membership
        filter's ids in the same row order), prepared once.  Row blocks are
        the kernels' on CUDA and 8 on the CPU, where the plain version's
        work is proportional to the padded read count."""
        if self._prepared is None:
            block = BLOCK_R if self.device.type == "cuda" else 8
            self._prepared = prepare_reads(*self.device_keys(), block_rows=block)
        return self._prepared


def native_scoring_ok(device) -> bool:
    """Whether frontier and evalPath scoring run in the native host library
    (nw_evaluate_frontier, nw_best_scores_batch) instead of the device step:
    on the CPU, where the plain torch scorer's per-call cost dominates a
    thin search and the C++ batch scorer computes the same int32 scores.
    Never on CUDA: there K1 and K2 score, and no search or evalPath scoring
    leaves the card unless a caller asks `search` for its native driver."""
    if torch.device(device).type != "cpu":
        return False
    from ..io import native

    return native.available()


def _as_batch(read_paths, device) -> ReadBatch:
    if isinstance(read_paths, ReadBatch):
        return read_paths
    return ReadBatch(read_paths, device)


def _frontier_buffer(candidates: Sequence[Sequence[Step]]):
    """One int32 buffer holding a frontier's keys (C, n) and then its
    lengths (C,), so that a single copy uploads both; returns (buffer, C,
    n).  Keys are padded with -1 to a power-of-two width, and C with empty
    candidates to a geometric bucket so that padded work stays within ~25%
    of the frontier."""
    oc = ORIENT_CODE
    lens = np.fromiter(map(len, candidates), np.int32, count=len(candidates))
    C, n = pad_bucket(len(candidates)), pad_pow2(int(lens.max()))
    buf = np.full((C * n + C,), -1, np.int32)
    a_keys = buf[:C * n].reshape(C, n)
    live = np.arange(n, dtype=np.int32)[None, :] < lens[:, None]
    a_keys[:len(candidates)][live] = [(s[0] << 2) | oc[s[1]]
                                      for c in candidates for s in c]
    buf[C * n:] = 0
    buf[C * n:C * n + len(candidates)] = lens
    return buf, C, n


def encode_frontier(candidates: Sequence[Sequence[Step]]):
    """(a_keys (C, n), a_len (C,)) of a frontier: views of `_frontier_buffer`."""
    buf, C, n = _frontier_buffer(candidates)
    return buf[:C * n].reshape(C, n), buf[C * n:]


def evaluate_candidates(candidates: Sequence[Sequence[Step]],
                        read_paths: Union[ReadBatch, Sequence[Sequence[Step]]],
                        filter_alignments: bool = True,
                        device="cuda") -> List[PathScore]:
    """Score a frontier of candidates in one device step on the batch's
    device (`device` applies only when `read_paths` is not a ReadBatch), or,
    where `native_scoring_ok`, in one fused native call (membership filter,
    fw/rc scoring and tallies).  On the device its parts are the spans
    search.evaluate.encode (the frontier buffer), .dispatch (the upload and
    the device step's launches), .fetch (the copy back, which waits for the
    device) and .unpack."""
    results = [PathScore() for _ in candidates]
    batch = _as_batch(read_paths, device)
    if batch.R == 0 or not candidates:
        return results
    if native_scoring_ok(batch.device):
        from ..io import native

        a_keys, a_len = encode_frontier(candidates)
        tallies = native.nw_evaluate_frontier(
            a_keys[:len(candidates)], a_len[:len(candidates)], batch.b_keys,
            batch.lengths, filter_alignments)
        for ci in range(len(candidates)):
            results[ci].bad = int(tallies[ci, 0])
            results[ci].good = int(tallies[ci, 1])
            results[ci].unaligned = int(tallies[ci, 2])
        return results
    with span("search.evaluate.encode"):
        buf, C, n = _frontier_buffer(candidates)
    with span("search.evaluate.dispatch"):
        reads = batch.prepared()
        on_device = torch.from_numpy(buf).to(reads.operand.device)   # the one upload
        step = local_step_prepared(on_device[:C * n].view(C, n), on_device[C * n:],
                                   reads, filter_alignments)
    with span("search.evaluate.fetch"):
        tallies = step.cpu()
    with span("search.evaluate.unpack"):
        tallies = tallies.numpy()
        for ci in range(len(candidates)):
            results[ci].bad = int(tallies[ci, 0])
            results[ci].good = int(tallies[ci, 1]) + batch.n_empty
            results[ci].unaligned = int(tallies[ci, 2])
    return results


def evaluate_path_printing(candidate: Sequence[Step],
                           read_paths: Sequence[Sequence[Step]],
                           read_names: Sequence[str],
                           id_to_name,
                           out,
                           device="cuda") -> PathScore:
    """Single-candidate scoring that also prints each read's best alignment
    (reference evalPath mode, src/eval.cpp:100-105): the read row of the
    pairwise alignment, then qName and best score, tab-separated.

    Orientation/score selection is ONE (1, 2R) scoring call (fw and rc rows
    stacked) on `device`, or in the native batch scorer where
    `native_scoring_ok`; the host then walks only the chosen orientation per
    read for the printed line with the native walk (nw_path_walk), whose
    oracle `nw_align_oracle` runs when `native.available()` is false."""
    from ..io import native

    result = PathScore()
    cand = [Step(s[0], s[1]) for s in candidate]
    rps = [[Step(s[0], s[1]) for s in rp] for rp in read_paths]
    rcps = [revcomp_path(rp) for rp in rps]
    R = len(rps)
    if R == 0:
        return result
    rows = rps + rcps
    ak, al = encode_path_batch([cand], pad_pow2(len(cand)), pad_key=-1)
    bk, bl = encode_path_batch(rows, pad_pow2(max(len(r) for r in rows)),
                               pad_key=-2)
    if native_scoring_ok(device):
        scores = native.nw_best_scores_batch(ak, al, bk, bl, with_rc=False)[0]
    else:
        device = torch.device(device)
        scores = nw_pair_scores(*(torch.from_numpy(x).to(device)
                                  for x in (ak, al, bk, bl))).cpu().numpy()[0]
    fw_s, rc_s = scores[:R], scores[R:2 * R]

    def keys(path):
        return np.array([s.id * 4 + ORIENT_CODE[s.orientation] for s in path],
                        np.int64)

    walk = native.available()
    a_keys = keys(cand)
    for i, qname in enumerate(read_names):
        use_fw = fw_s[i] > rc_s[i]                       # tie -> rc
        b = rps[i] if use_fw else rcps[i]
        score = int(fw_s[i] if use_fw else rc_s[i])
        walked = native.nw_path_walk(a_keys, keys(b)) if walk else None
        if walked is None:
            best = nw_align_oracle(cand, b)
            line = _alignment_string(best.a, best.b, id_to_name)
        else:
            line = _alignment_string_from_ops(cand, b, walked[1], id_to_name)
        if score < 0:
            result.bad += 1
        else:
            result.good += 1
        out.write(line + "\t" + qname + "\t" + str(score) + "\n")
    return result


def _alignment_string_from_ops(cand: Sequence[Step], b: Sequence[Step],
                               ops: str, id_to_name) -> str:
    """Rebuild _alignment_string's read row from the native walk's move
    ops ('M' diagonal, 'U' cand-step/read-gap, 'L' read-step/cand-gap)."""
    parts = []
    ia = ib = 0
    for op in ops:
        if op == "U":
            parts.append("-" * (len(id_to_name(cand[ia].id)) + 1) + ",")
            ia += 1
        elif op == "M":
            sb = b[ib]
            if cand[ia] == sb:
                parts.append("." * (len(id_to_name(sb.id)) + 1) + ",")
            else:
                parts.append(id_to_name(sb.id) + sb.orientation + ",")
            ia += 1
            ib += 1
        else:  # 'L'
            parts.append(id_to_name(b[ib].id) + b[ib].orientation + ",")
            ib += 1
    return "".join(parts)


def _alignment_string(a: List[Step], b: List[Step], id_to_name) -> str:
    """The read ("B") row of a pairwise path alignment
    (reference include/alignments.h:98-122 with doNotReturnRef=true):
    '-'*(width) for a gap, 'name+or' for a mismatch, '.'*(width) for a match;
    every cell is followed by ','."""
    parts = []
    for sa, sb in zip(a, b):
        if sb.id == -1:
            parts.append("-" * (len(id_to_name(sa.id)) + 1) + ",")
        elif sa != sb:
            parts.append(id_to_name(sb.id) + sb.orientation + ",")
        else:
            parts.append("." * (len(id_to_name(sb.id)) + 1) + ",")
    return "".join(parts)


def filter_mask(candidate: Sequence[Step],
                read_paths: Sequence[Sequence[Step]]) -> Tuple[np.ndarray, int]:
    """ReadBatch.filter_against for one candidate's node ids."""
    return _as_batch(read_paths, "cpu").filter_against({s[0] for s in candidate})


def distributed_evaluator(base=evaluate_candidates):
    """Multi-process evaluate_fn: each process scores its LOCAL read shard,
    then the (bad, good, unaligned) tallies are summed across processes
    (parallel/dist.allreduce_stats).  The search loop is deterministic
    given the summed scores, so every process evolves the same heap and
    produces identical output.  A process whose shard is empty, or whose
    frontier is, scores nothing but still takes part in the sum, and each
    shard's empty read paths are in its own `good` (ReadBatch.n_empty), so
    the sum stays exact.

    The CLI's evaluator for every distributed search: on one H100 neither
    this nor frontier_sharded_evaluator was the faster across read counts
    from 249 to 10,000 (PERF.md section 5)."""
    from ..parallel.dist import allreduce_stats

    def evaluate(candidates, read_paths, filter_alignments=True):
        local = base(candidates, read_paths, filter_alignments)
        flat = []
        for s in local:
            flat.extend((s.bad, s.good, s.unaligned))
        merged = allreduce_stats(flat)
        return [PathScore(merged[3 * i], merged[3 * i + 1], merged[3 * i + 2])
                for i in range(len(local))]

    # marker read by engine/search: a read-sharded evaluation maps to the
    # native driver's ring-sum mode, and its read count is summed
    evaluate.read_sharded = True
    return evaluate


def frontier_sharded_evaluator(base=evaluate_candidates):
    """Multi-process evaluate_fn for THIN read sets: every process holds the
    FULL read batch, scores a round-robin 1/Nth of the frontier's
    candidates, and the per-candidate tallies are summed across processes
    (each candidate's slots are zero everywhere except its owner, so the
    sum is an allgather).  Parallelism over the frontier: it divides the
    scoring work even when the read batch is too small to shard.  For
    callers of `search` that hold every read on every process; the CLI
    takes distributed_evaluator."""
    from ..parallel.dist import allreduce_stats, process_info

    def evaluate(candidates, read_paths, filter_alignments=True):
        pid, count = process_info()
        mine = list(range(pid, len(candidates), count))
        local = base([candidates[i] for i in mine], read_paths,
                     filter_alignments)
        flat = [0] * (3 * len(candidates))
        for slot, i in enumerate(mine):
            s = local[slot]
            flat[3 * i:3 * i + 3] = (s.bad, s.good, s.unaligned)
        merged = allreduce_stats(flat)
        return [PathScore(merged[3 * i], merged[3 * i + 1], merged[3 * i + 2])
                for i in range(len(candidates))]

    # marker read by engine/search: a frontier-sharded evaluation runs
    # inside the native driver when the /dev/shm ring is agreed
    evaluate.frontier_sharded = True
    return evaluate
