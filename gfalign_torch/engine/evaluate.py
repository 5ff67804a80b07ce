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
into a ReadBatch whose keys stay resident on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np
import torch

from ..ops.nw_cuda import TILE_R
from ..ops.nw_path import (ORIENT_CODE, Step, encode_path_batch,
                           nw_align_oracle, nw_pair_scores, pad_bucket,
                           pad_pow2, revcomp_path)
from ..parallel.score_step import local_step


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

    def device_keys(self):
        """Device-resident padded (b_keys, b_len), uploaded once.  Pad
        quantum: the kernel's read tile on CUDA, 8 on the CPU (the plain
        version's work is proportional to the padded read count)."""
        if self._device is None:
            quantum = TILE_R if self.device.type == "cuda" else 8
            padn = -self.R % quantum
            b_keys = np.concatenate(
                [self.b_keys, np.full((padn, self.m), -2, np.int32)])
            b_len = np.concatenate([self.lengths, np.zeros((padn,), np.int32)])
            self._device = (torch.from_numpy(b_keys).to(self.device),
                            torch.from_numpy(b_len).to(self.device))
        return self._device


def _as_batch(read_paths, device) -> ReadBatch:
    if isinstance(read_paths, ReadBatch):
        return read_paths
    return ReadBatch(read_paths, device)


def encode_frontier(candidates: Sequence[Sequence[Step]]):
    """(a_keys, a_len) of a frontier: keys padded with -1 to a power-of-two
    width, and C padded with empty candidates to a geometric bucket so that
    padded work stays within ~25% of the frontier."""
    oc = ORIENT_CODE
    keys_list = [[(s[0] << 2) | oc[s[1]] for s in c] for c in candidates]
    a_keys = np.full((pad_bucket(len(keys_list)),
                      pad_pow2(max(map(len, keys_list)))), -1, np.int32)
    a_len = np.zeros((a_keys.shape[0],), np.int32)
    for i, k in enumerate(keys_list):
        a_keys[i, :len(k)] = k
        a_len[i] = len(k)
    return a_keys, a_len


def evaluate_candidates(candidates: Sequence[Sequence[Step]],
                        read_paths: Union[ReadBatch, Sequence[Sequence[Step]]],
                        filter_alignments: bool = True,
                        device="cuda") -> List[PathScore]:
    """Score a frontier of candidates in one device step on the batch's
    device (`device` applies only when `read_paths` is not a ReadBatch)."""
    results = [PathScore() for _ in candidates]
    batch = _as_batch(read_paths, device)
    if batch.R == 0 or not candidates:
        return results
    a_keys, a_len = encode_frontier(candidates)
    b_keys, b_len = batch.device_keys()
    dev = b_keys.device
    tallies = local_step(torch.from_numpy(a_keys).to(dev),
                         torch.from_numpy(a_len).to(dev), b_keys, b_len,
                         filter_alignments).cpu().numpy()
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

    Orientation/score selection is ONE (1, 2R) scoring call on `device`
    (fw and rc rows stacked); the host then walks only the chosen
    orientation per read with the oracle for the printed line."""
    result = PathScore()
    cand = [Step(s[0], s[1]) for s in candidate]
    rps = [[Step(s[0], s[1]) for s in rp] for rp in read_paths]
    rcps = [revcomp_path(rp) for rp in rps]
    R = len(rps)
    if R == 0:
        return result
    rows = rps + rcps
    device = torch.device(device)
    ak, al = encode_path_batch([cand], pad_pow2(len(cand)), pad_key=-1)
    bk, bl = encode_path_batch(rows, pad_pow2(max(len(r) for r in rows)),
                               pad_key=-2)
    scores = nw_pair_scores(*(torch.from_numpy(x).to(device)
                              for x in (ak, al, bk, bl))).cpu().numpy()[0]
    fw_s, rc_s = scores[:R], scores[R:2 * R]

    for i, qname in enumerate(read_names):
        use_fw = fw_s[i] > rc_s[i]                       # tie -> rc
        b = rps[i] if use_fw else rcps[i]
        score = int(fw_s[i] if use_fw else rc_s[i])
        best = nw_align_oracle(cand, b)
        line = _alignment_string(best.a, best.b, id_to_name)
        if score < 0:
            result.bad += 1
        else:
            result.good += 1
        out.write(line + "\t" + qname + "\t" + str(score) + "\n")
    return result


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
