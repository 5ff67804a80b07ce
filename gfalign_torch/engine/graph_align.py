"""In-house sequence-to-graph aligner (the align mode).

The reference shells out to GraphAligner (src/main.cpp:167-169); this engine
is the framework's own pipeline with GraphAligner-compatible GAF output
(column contract + NM/AS/dv/id/cg tags).  PyTorch port of
gfalign_tpu/engine/graph_align.py: scoring runs on `device` (the CUDA
kernels of ops/seqalign_cuda.py, or their plain versions on the CPU), and
there is one scoring ladder, the device ladder.

Pipeline:
  1. enumerate oriented simple paths through the graph (both orientations;
     maximal per start state), building merged path sequences with edge
     overlaps dropped from the incoming segment (pLen of '>11<12>13' with
     6M/5M overlaps = 180-11 = 169, matching random2.gaf);
  2. score every (read x path-sequence) pair on device with the batched
     local-alignment kernel (ops/seqalign.py);
  3. select placements per read greedily by score over disjoint query
     regions (supplementary split, e.g. random1's rd1 -> ctg2 + ctg1);
  4. traceback only selected placements on host, trim the path to the
     minimal covering subpath, and emit GAF.

Records are emitted in read input order; a read's placements in descending
score order ('best first', as the fixtures show for split reads).
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.model import Graph
from ..io.fastq import encode_seq, load_reads
from ..io.stream import OutputStream
from ..ops import seqalign
from ..utils.log import lg

MIN_SCORE = 20          # reject spurious local hits (hifi preset)

# Host wall seconds per stage of the seeded aligner, summed over the calls
# since a caller last zeroed them: seeding (index, anchors, candidates),
# scoring (inside score_pairs: dispatch and the fetch that waits for the
# device) and traceback.
PHASE_SECONDS = {"seeding": 0.0, "scoring": 0.0, "traceback": 0.0}


@contextlib.contextmanager
def _timed(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[stage] += time.perf_counter() - t0



@dataclass
class AlignParams:
    """Tunable surface of the in-house aligner — the equivalents of the
    reference's GraphAligner preset knobs (src/main.cpp:177-182):

      * min_score       ~ --min-alignment-score: reject weaker placements;
      * seed_k          ~ --seeds-mxm-length (inverted sense): anchor
                          k-mer length — SHORTER seeds survive higher
                          error rates (p_clean ≈ (1-e)^k per position);
      * max_anchors / max_paths_per_anchor: seed-count budget per read;
      * band / wide_band ~ --precise-clipping stringency: the banded DP
                          width around the anchor diagonal — wider bands
                          tolerate the larger indel drift of noisy reads
                          before the full-DP safety net fires.
      * seed_sample     : keep 1/N of index k-mers (0 = auto by graph
                          size, 1 = keep every k-mer; --seed-sample).

    band/wide_band are kept multiples of 8 (run_graph_aligner rounds
    overrides up)."""

    min_score: int = MIN_SCORE
    seed_k: int = 15
    max_anchors: int = 12
    max_paths_per_anchor: int = 16
    band: int = 128
    wide_band: int = 512
    seed_sample: int = 0


# Reference preset table (src/main.cpp:178-182): hifi = GraphAligner
# '-x vg'; CLR adds '--seeds-mxm-length 1000 --min-alignment-score 1000
# --precise-clipping 0.75' for ~10-15%-error reads.  The in-house CLR
# mapping: shorter anchors (13-mers keep ~20% clean-seed odds per
# position at 12% error vs ~4% for 15-mers over both error flanks), more
# of them, a 4x-wider starting band for indel drift, and a higher score
# floor (tests/test_align_clr.py validates placement at 5% and 12%
# error).
PRESETS = {
    "hifi": AlignParams(),
    "CLR": AlignParams(min_score=50, seed_k=13, max_anchors=16,
                       max_paths_per_anchor=16, band=512, wide_band=1024),
}


class CapAudit:
    """Counts every place a bounding cap actually dropped candidate work, so
    no truncation is silent: align_reads reports the tallies on stderr and
    the seeded pipeline retries unplaced reads with the caps raised."""

    def __init__(self) -> None:
        from collections import defaultdict

        self.counts: Dict[str, int] = defaultdict(int)

    def hit(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def merge(self, other: "CapAudit") -> None:
        for k, v in other.counts.items():
            self.counts[k] += v

    def __bool__(self) -> bool:
        return bool(self.counts)

    def report(self, context: str) -> None:
        if self.counts:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(self.counts.items()))
            lg.warn(f"{context}: candidate caps bound ({detail})")


def _fmt_g(value: float) -> str:
    """C++ %g-style float (GraphAligner tag formatting): 6 significant
    digits, no trailing zeros."""
    return f"{value:g}"


def _overlap_len(cigar: str) -> int:
    if not cigar or cigar in ("*", "."):
        return 0
    total = 0
    for num, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        if op in "M=XD":
            total += int(num)
    return total


@dataclass
class OrientedPath:
    steps: List[Tuple[int, str]]          # (segment uid, orientation)
    seq: str = ""
    offsets: List[int] = None             # start offset of each step in seq
    seg_lens: List[int] = None
    n_bases: int = -1                     # total length when seq is elided
    # (the seeded aligner builds paths code-first; strings are never needed)
    step_pos: dict = None                 # lazy step -> first index map

    def __len__(self) -> int:
        return self.n_bases if self.n_bases >= 0 else len(self.seq)

    def path_string(self, graph: Graph) -> str:
        return "".join((">" if o == "+" else "<") + graph.segment(s).name
                       for s, o in self.steps)


def _oriented_seq(graph: Graph, sid: int, orientation: str) -> str:
    from ..graph.stats import revcomp

    seq = graph.segment(sid).seq
    return seq if orientation == "+" else revcomp(seq)


def build_path(graph: Graph, steps: List[Tuple[int, str]],
               overlaps: List[int]) -> OrientedPath:
    seq_parts: List[str] = []
    offsets: List[int] = []
    seg_lens: List[int] = []
    pos = 0
    for k, (sid, orientation) in enumerate(steps):
        s = _oriented_seq(graph, sid, orientation)
        drop = overlaps[k - 1] if k > 0 else 0
        offsets.append(pos - drop)
        seg_lens.append(len(s))
        seq_parts.append(s[drop:])
        pos += len(s) - drop
    return OrientedPath(steps, "".join(seq_parts), offsets, seg_lens)


def overlap_table(graph: Graph) -> Dict[Tuple[int, str, int, str], int]:
    """Directed (s1, o1, s2, o2) -> overlap length, both edge directions."""
    from ..graph.model import flip

    table: Dict[Tuple[int, str, int, str], int] = {}
    for e in graph.links:
        ov = _overlap_len(e.overlap)
        table.setdefault((e.s1, e.or1, e.s2, e.or2), ov)
        table.setdefault((e.s2, flip(e.or2), e.s1, flip(e.or1)), ov)
    return table


def build_oriented(graph: Graph, steps: List[Tuple[int, str]],
                   overlaps_lut: Dict[Tuple[int, str, int, str], int]) -> OrientedPath:
    overlaps = [overlaps_lut.get((steps[k][0], steps[k][1],
                                  steps[k + 1][0], steps[k + 1][1]), 0)
                for k in range(len(steps) - 1)]
    return build_path(graph, steps, overlaps)


class _SegCodes:
    """Lazy per-(segment, orientation) int8 code arrays."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self._cache: Dict[Tuple[int, str], np.ndarray] = {}

    def __getitem__(self, key: Tuple[int, str]) -> np.ndarray:
        c = self._cache.get(key)
        if c is None:
            c = encode_seq(_oriented_seq(self.graph, *key)).astype(np.int8)
            self._cache[key] = c
        return c


def build_oriented_codes(graph: Graph, steps: List[Tuple[int, str]],
                         overlaps_lut: Dict[Tuple[int, str, int, str], int],
                         seg_codes: _SegCodes) -> Tuple[OrientedPath, np.ndarray]:
    """build_oriented without the string detour: concatenates cached
    per-oriented-segment code arrays directly.  Returns
    (path-with-elided-seq, codes);
    offsets/seg_lens/len() match build_path exactly."""
    offsets: List[int] = []
    seg_lens: List[int] = []
    parts: List[np.ndarray] = []
    pos = 0
    prev = None
    for sid, orientation in steps:
        c = seg_codes[(sid, orientation)]
        drop = overlaps_lut.get(prev + (sid, orientation), 0) if prev else 0
        offsets.append(pos - drop)
        seg_lens.append(len(c))
        parts.append(c[drop:])
        pos += len(c) - drop
        prev = (sid, orientation)
    codes = (np.concatenate(parts) if parts else np.empty(0, np.int8))
    # n_bases must be the CLAMPED concatenated length (len(codes), i.e.
    # sum of max(0, len-drop)), not the raw pos recurrence: when an edge
    # declares an overlap longer than its successor segment, pos drifts
    # below len(codes), and DevicePools.path_idx's `pos != len(op)`
    # irregular-path guard relies on that mismatch to reject the path
    # (the guard recomputes the same unclamped recurrence; with
    # n_bases=pos it could never fire for code-built paths).
    return OrientedPath(steps, "", offsets, seg_lens,
                        n_bases=len(codes)), codes


def build_oriented_struct(graph: Graph, steps: List[Tuple[int, str]],
                          overlaps_lut) -> OrientedPath:
    """build_oriented_codes' OrientedPath WITHOUT materializing the code
    array: offsets/seg_lens/n_bases come from segment LENGTHS alone
    (identical arithmetic, incl. the clamped n_bases).  Candidate
    generation only needs the structure (chain ranking, deltas); codes
    are built lazily at scoring time — most chain-tail candidates are
    never scored."""
    offsets: List[int] = []
    seg_lens: List[int] = []
    pos = 0
    clamped = 0
    ps, po = -1, ""
    lut_get = overlaps_lut.get
    segment = graph.segment
    for sid, orientation in steps:
        # len(seq), NOT the declared LN length: a sequence-less segment
        # contributes ZERO bytes to the materialized code array
        # (codes_of)
        n = len(segment(sid).seq)
        drop = lut_get((ps, po, sid, orientation), 0) if ps >= 0 else 0
        offsets.append(pos - drop)
        seg_lens.append(n)
        pos += n - drop
        if n > drop:
            clamped += n - drop
        ps, po = sid, orientation
    return OrientedPath(steps, "", offsets, seg_lens, n_bases=clamped)


def enumerate_paths(graph: Graph, max_paths: int = 4096,
                    max_depth: Optional[int] = None,
                    audit: Optional[CapAudit] = None) -> List[OrientedPath]:
    """All maximal oriented simple paths (no repeated (segment, orientation)
    state), from every start state; contiguous subpaths of another
    enumerated path are dropped.  Caps that actually bind are counted on
    `audit` — never silently."""
    adj = graph.adjacency
    n = graph.n_segments
    max_depth = max_depth or min(2 * n, 64)
    raw: List[List[Tuple[int, str]]] = []

    def dfs(state_path: List[Tuple[int, str]], visited: set) -> None:
        if len(raw) >= max_paths:
            if audit is not None:
                audit.hit("enumerate_paths.max_paths")
            return
        sid, orientation = state_path[-1]
        extended = False
        if len(state_path) < max_depth:
            for e in adj[sid]:
                if e.or0 != orientation:
                    continue
                nxt = (e.nid, e.or1)
                if nxt in visited:
                    continue
                visited.add(nxt)
                state_path.append(nxt)
                dfs(state_path, visited)
                state_path.pop()
                visited.remove(nxt)
                extended = True
        elif audit is not None and any(
                e.or0 == orientation and (e.nid, e.or1) not in visited
                for e in adj[sid]):
            audit.hit("enumerate_paths.max_depth")
        if not extended:
            raw.append(list(state_path))

    for sid in range(n):
        if not graph.segment(sid).seq:
            continue
        for orientation in "+-":
            start = (sid, orientation)
            dfs([start], {start})

    # drop exact duplicates and contiguous subpaths
    raw.sort(key=len, reverse=True)
    kept: List[List[Tuple[int, str]]] = []
    kept_strs: List[str] = []
    for p in raw:
        s = ";".join(f"{a}{b}" for a, b in p)
        if any(s in ks for ks in kept_strs):
            continue
        kept.append(p)
        kept_strs.append(s)

    lut = overlap_table(graph)
    paths = [build_oriented(graph, steps, lut) for steps in kept]
    lg.verbose(f"Enumerated {len(paths)} oriented paths")
    return paths


@dataclass
class GafHit:
    score: int
    qstart: int
    qend: int
    path_str: str
    plen: int
    pstart: int
    pend: int
    matches: int
    nm: int
    blocklen: int
    cigar: str
    s2: int = 0      # best same-query-region competitor at a DIFFERENT location
    mapq: int = 60


def _mapq(s1: int, s2: int) -> int:
    """Multi-mapping confidence, minimap2-style score-gap model capped at 60
    (GraphAligner's cap): a unique placement keeps 60; a same-query-region
    competitor at a different graph location scales it by the relative score
    gap (equal-scoring alternative -> 0).  Competitors are collected where
    the placement loop overlap-rejects them, deduped by trimmed location so
    nested candidate paths containing the SAME placement don't count.

    Evidence bound (top-k pruning): only SCORED candidates can register
    as competitors, and a cleanly-placed read scores its CHAIN_TOP_K
    best chain-supported candidates (vote ties extended).  A same-score
    competitor whose anchor-vote support ranks below the cut — e.g. its
    copy of a repeat was starved by seed subsampling — is not seen and
    mapq reads higher than the full-candidate-set model would report.
    In practice repeat copies draw comparable anchors (mapq medians are
    unchanged across the bench workloads); accuracy-critical runs can
    raise --max-anchors or set --seed-sample 1 to tighten the evidence."""
    if s1 <= 0:
        return 0
    return max(0, min(60, (60 * (s1 - s2)) // s1))


def _trim_to_subpath(graph: Graph, path: OrientedPath,
                     pstart: int, pend: int) -> Tuple[str, int, int, int]:
    """Minimal covering subpath: steps whose [offset, offset+len) interval
    intersects [pstart, pend).  Returns (path string, new plen, new pstart,
    new pend)."""
    first = last = None
    n_steps = len(path.steps)
    for k, off in enumerate(path.offsets):
        lo, hi = off, off + path.seg_lens[k]
        if not (hi > pstart and lo < pend):
            continue
        # overlap-region attribution: a boundary segment only counts if the
        # alignment extends beyond the bases it shares with its neighbor
        # (random2.gaf read5 ends exactly at the 11/12 overlap and reports
        # '>11', not '>11<12')
        if k > 0 and pend <= path.offsets[k - 1] + path.seg_lens[k - 1]:
            continue
        if k + 1 < n_steps and pstart >= path.offsets[k + 1]:
            continue
        if first is None:
            first = k
        last = k
    if first is None:
        first = last = 0
    base = path.offsets[first]
    sub_steps = path.steps[first:last + 1]
    plen = path.offsets[last] + path.seg_lens[last] - base
    path_str = "".join((">" if o == "+" else "<") + graph.segment(s).name
                       for s, o in sub_steps)
    return path_str, plen, pstart - base, pend - base


def _cigar_str(cigar: List[Tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in cigar)


_SEG_RE = re.compile(r"[><]([^><]+)")


def _reject_ending_inside(graph: Graph, path: OrientedPath, v: int,
                          bi: int, bj: int, accepted, hits) -> bool:
    """Traceback-free rejection of the common nested-candidate case: an
    entry whose END row bi falls inside an accepted query interval (a, b]
    always loses the overlap test (its qstart < qend = bi <= b), so the
    full-DP traceback is wasted work — 6 of 7 entries per read land here.
    Skipping is only done when it provably matches _note_competitor's
    trimmed-segment-set rule: if the segment containing end column bj is in
    every touched hit's path, the sets intersect, so it is the same locus
    and no competitor note is needed.  Any other case (potential true
    multi-mapping) returns False and pays the exact traceback path.

    The proof only covers single-interval overlap: with an unknown qstart,
    the entry may ALSO overlap an earlier accepted interval ending before
    bi, whose competitor (s2) update the shortcut would skip — so when any
    such interval exists, fall back to the exact path."""
    touched = [h for (a, b), h in zip(accepted, hits) if a < bi <= b]
    if not touched:
        return False
    if any(b < bi for _, b in accepted):
        return False  # a second interval could overlap via the qstart side
    seg = None
    for k, off in enumerate(path.offsets):
        if off < bj <= off + path.seg_lens[k]:
            seg = graph.segment(path.steps[k][0]).name
            break
    if seg is None:
        return False
    return all(seg in _SEG_RE.findall(h.path_str) for h in touched)


def _note_competitor(graph: Graph, path: OrientedPath, pl,
                     shadowed: List[GafHit]) -> None:
    """An overlap-rejected placement is a multi-mapping competitor of the
    accepted hits it shadows — unless it sits at the SAME assembly locus.
    Candidate paths routinely nest and reverse (one placement shows up under
    many keys, prefixes, and the opposite-orientation walk), so 'same locus'
    is judged by trimmed-subpath SEGMENT overlap: a competitor touching any
    segment of the accepted placement is the same place, not multi-mapping.
    The surviving best distinct-locus score feeds the mapq gap model."""
    path_str, _, _, _ = _trim_to_subpath(graph, path, pl.pstart, pl.pend)
    segs = set(_SEG_RE.findall(path_str))
    for h in shadowed:
        if segs.isdisjoint(_SEG_RE.findall(h.path_str)):
            h.s2 = max(h.s2, pl.score)


SEED_THRESHOLD = 48   # above this many segments, switch to k-mer seeding
SEED_CHUNK = 32       # reads per seeded scoring batch
SCORE_CHUNK = 4096    # max pairs per device dispatch (bounds host + device memory)
CHAIN_TOL = 128       # diagonal corridor half-width for colinear anchors
CHAIN_TOP_K = 8       # banded-DP budget per read in the first scoring wave
# (ties at the boundary extend to at most 2x; reads that fail to place —
# or keep a scoreable uncovered region — open their full candidate list)

_CO_PAD = (1 << 31) - 1   # cum_off padding: past-the-end sentinel


class DevicePools:
    """Device-resident scoring state for banded dispatches: torch tensors
    on one explicit device, updated in place.

    Path BYTES never leave the host per dispatch:

      * reads upload once into a (r_cap, lr_cap) int8 pool;
      * the ORIENTED SEGMENT ARENA (fw + rc codes of every segment, ~2x
        graph size) uploads once;
      * a path is registered as per-step int32 tables (cum_off = path
        offset where each step's contribution starts; base_ptr = arena
        index - cum_off, overlap drop folded in) and its banded strip is
        assembled on the device per dispatch (ops/seqalign);
      * each dispatch ships only int32 row indices + deltas (KBs).

    Table capacities grow by pow2 doubling (rare: the first sync sees the
    whole candidate set); earlier rows keep their place."""

    def __init__(self, work: List[np.ndarray], graph: Graph, device):
        from ..graph.stats import revcomp
        from ..ops.nw_path import pad_pow2

        self.device = torch.device(device)
        self.lr_cap = pad_pow2(max((len(w) for w in work), default=16),
                               floor=16)
        r_cap = pad_pow2(len(work), floor=8)
        buf = np.full((r_cap, self.lr_cap), seqalign.PAD, np.int8)
        for r, w in enumerate(work):
            buf[r, :len(w)] = w
        self.reads = torch.from_numpy(buf).to(self.device)

        self.arena_start: Dict[Tuple[int, str], int] = {}
        parts: List[np.ndarray] = []
        pos = 0
        for sid in range(graph.n_segments):
            seq = graph.segment(sid).seq
            for orient, s in (("+", seq), ("-", revcomp(seq) if seq else "")):
                self.arena_start[(sid, orient)] = pos
                if s:
                    parts.append(encode_seq(s).astype(np.int8))
                    pos += len(s)
        arena = (np.concatenate(parts) if parts
                 else np.zeros(8, np.int8))
        self.arena = torch.from_numpy(arena).to(self.device)
        self._init_tables()

    def _init_tables(self) -> None:
        self.p_cap = 0
        self.s_cap = 8                      # max steps/path, pow2 growth
        self.cum_off = None                 # (p_cap, s_cap) int32
        self.base_ptr = None                # (p_cap, s_cap) int32
        self.plen = None                    # (p_cap,) int32
        self.path_row: Dict[tuple, int] = {}
        self.irregular: set = set()         # keys the arena mapping can't
        # represent (non-monotone offsets from overlap > segment); scored
        # by the host-array fallback instead
        self._pending: List[Tuple[int, np.ndarray, np.ndarray, int]] = []

    @classmethod
    def from_numpy(cls, arena, cum_off, base_ptr, plen, reads,
                   device) -> "DevicePools":
        """Pools holding the given tables: arena (A,) int8, cum_off and
        base_ptr (p_cap, s_cap) int32, plen (p_cap,) int32, reads
        (r_cap, lr_cap) int8, as numpy arrays (for example the JAX
        package's pools, so that both packages score the same state).
        Rows already in the tables have no key here: address them by their
        row index; `arena_start` is empty, so no further path can be
        registered."""
        self = cls.__new__(cls)
        self.device = torch.device(device)

        def put(x, dtype):
            return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(self.device)

        self.reads = put(reads, np.int8)
        self.lr_cap = self.reads.shape[1]
        self.arena = put(arena, np.int8)
        self.arena_start = {}
        self._init_tables()
        self.cum_off = put(cum_off, np.int32)
        self.base_ptr = put(base_ptr, np.int32)
        self.plen = put(plen, np.int32)
        self.p_cap, self.s_cap = self.cum_off.shape
        return self

    def update_reads(self, rows: List[int], work: List[np.ndarray]) -> None:
        """Re-upload masked read rows (placement masks accepted query
        regions between rounds); `rows` is small after round 1."""
        if not rows:
            return
        batch = np.full((len(rows), self.lr_cap), seqalign.PAD, np.int8)
        for i, r in enumerate(rows):
            batch[i, :len(work[r])] = work[r]
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        self.reads.index_copy_(0, idx, torch.from_numpy(batch).to(self.device))

    def path_idx(self, key: tuple, op: OrientedPath) -> Optional[int]:
        """Register/look up a path; returns its table row, or None when
        the path is irregular (caller falls back to host-array scoring)."""
        if key in self.irregular:
            return None
        row = self.path_row.get(key)
        if row is not None:
            return row
        n_steps = len(op.steps)
        co = np.empty(n_steps, np.int64)
        bp = np.empty(n_steps, np.int64)
        pos = 0
        for k, (sid, orient) in enumerate(op.steps):
            drop = pos - op.offsets[k]
            co[k] = pos
            bp[k] = self.arena_start[(sid, orient)] + drop - pos
            pos += op.seg_lens[k] - drop
        if pos != len(op) or np.any(np.diff(co) < 0) or n_steps == 0:
            self.irregular.add(key)
            return None
        row = len(self.path_row)
        self.path_row[key] = row
        self._pending.append((row, co.astype(np.int32),
                              bp.astype(np.int32), pos))
        return row

    def sync_paths(self) -> None:
        """Upload pending path tables; grow capacities by pow2 doubling."""
        if not self._pending:
            return
        from ..ops.nw_path import pad_pow2

        need_rows = len(self.path_row)
        need_s = max(self.s_cap,
                     pad_pow2(max(len(co) for _, co, _, _ in self._pending),
                              floor=8))
        if (self.cum_off is None or need_rows > self.p_cap
                or need_s > self.s_cap):
            p_cap = pad_pow2(need_rows, floor=8)
            old = (self.cum_off, self.base_ptr, self.plen)
            i32 = torch.int32
            self.cum_off = torch.full((p_cap, need_s), _CO_PAD, dtype=i32,
                                      device=self.device)
            self.base_ptr = torch.zeros((p_cap, need_s), dtype=i32,
                                        device=self.device)
            self.plen = torch.zeros((p_cap,), dtype=i32, device=self.device)
            if old[0] is not None:
                rows, cols = old[0].shape
                self.cum_off[:rows, :cols] = old[0]
                self.base_ptr[:rows, :cols] = old[1]
                self.plen[:rows] = old[2]
            self.p_cap, self.s_cap = p_cap, need_s
        first = self._pending[0][0]
        n = len(self._pending)
        co_b = np.full((n, self.s_cap), _CO_PAD, np.int32)
        bp_b = np.zeros((n, self.s_cap), np.int32)
        pl_b = np.zeros((n,), np.int32)
        for i, (row, co, bp, plen) in enumerate(self._pending):
            assert row == first + i  # rows are assigned sequentially
            co_b[i, :len(co)] = co
            bp_b[i, :len(bp)] = bp
            pl_b[i] = plen
        self.cum_off[first:first + n] = torch.from_numpy(co_b).to(self.device)
        self.base_ptr[first:first + n] = torch.from_numpy(bp_b).to(self.device)
        self.plen[first:first + n] = torch.from_numpy(pl_b).to(self.device)
        self._pending = []


def align_reads(graph: Graph, reads: Sequence[Tuple[str, str]],
                min_score: int = MIN_SCORE,
                params: Optional[AlignParams] = None,
                device="cuda") -> List[Tuple[str, int, List[GafHit]]]:
    """Returns [(read name, read length, hits sorted by descending score)].

    Small graphs use exact exhaustive path enumeration; larger graphs use
    k-mer seed-and-extend candidate generation (engine/seeding.py).
    `params` carries the preset-tunable surface (AlignParams); when given
    it supersedes `min_score`.  Scoring runs on `device`."""
    device = torch.device(device)
    if params is None:
        params = AlignParams(min_score=min_score)
    if graph.n_segments > SEED_THRESHOLD:
        return _align_seeded(graph, reads, params, device)
    audit = CapAudit()
    paths = enumerate_paths(graph, audit=audit)
    audit.report("align(exhaustive)")
    return _align_with_paths(graph, reads, paths, params.min_score, device)


def _align_seeded(graph: Graph, reads, params: AlignParams, device):
    min_score = params.min_score
    """Seeded mode scores (read, candidate-path) PAIRS, not the read x path
    cross product: each read's anchors nominate a handful of paths, so the
    work is O(sum of candidates) with pow2 shape buckets."""
    from collections import defaultdict

    from ..ops.nw_path import pad_pow2
    from .seeding import (KmerIndex, anchors_with_diag_batch,
                          paths_around_anchor)

    # auto-subsample the seed index at assembly scale: postings ~= 2x
    # total bases; cap around ~24M so the index build stays bounded
    # (GFALIGN_TORCH_SEED_SAMPLE overrides; 1 = keep every k-mer)
    import os as _os

    total_bases = 2 * sum(
        (seg.length or len(seg.seq))
        for seg in (graph.segment(s) for s in range(graph.n_segments)))
    env_mod = _os.environ.get("GFALIGN_TORCH_SEED_SAMPLE")
    auto_sampled = False
    if env_mod is not None:
        sample_mod = max(1, int(env_mod))
    elif params.seed_sample:
        sample_mod = max(1, params.seed_sample)
    else:
        sample_mod = max(1, -(-total_bases // 24_000_000))
        auto_sampled = sample_mod > 1
    with _timed("seeding"):
        index = KmerIndex(graph, k=params.seed_k, sample_mod=sample_mod)
    if sample_mod > 1:
        msg = (f"seed index subsampled 1/{sample_mod} "
               f"({len(index.kmers)} postings)")
        if auto_sampled:
            # auto-engaged sampling changes anchor sets by default —
            # always announce it (accuracy-sensitive runs disable with
            # --seed-sample 1 or GFALIGN_TORCH_SEED_SAMPLE=1)
            lg.warn(msg + "; --seed-sample 1 keeps every k-mer")
        else:
            lg.verbose(msg)
    lut = overlap_table(graph)
    seg_codes = _SegCodes(graph)
    path_cache: Dict[tuple, OrientedPath] = {}
    code_cache: Dict[tuple, np.ndarray] = {}

    def codes_of(key: tuple) -> np.ndarray:
        """Materialize (and cache) a candidate's concatenated code array —
        byte-identical to build_oriented_codes' output; deferred to
        scoring time because chain-tail candidates usually never score."""
        codes = code_cache.get(key)
        if codes is None:
            parts: List[np.ndarray] = []
            prev = None
            for sid, orientation in key:
                c = seg_codes[(sid, orientation)]
                drop = lut.get(prev + (sid, orientation), 0) if prev else 0
                parts.append(c[drop:])
                prev = (sid, orientation)
            codes = (np.concatenate(parts) if parts
                     else np.empty(0, np.int8))
            code_cache[key] = codes
        return codes
    cand_deltas: Dict[Tuple[int, tuple], int] = {}  # (read, key) -> diagonal
    cand_chain: Dict[Tuple[int, tuple], int] = {}   # (read, key) -> colinear
    # anchor-vote support (the candidate ranking key for top-k scoring)

    def gen_candidates(r: int, seq: str, anchors: List[tuple],
                       max_paths: int, audit: CapAudit) -> List[tuple]:
        cands: List[tuple] = []
        seen = set()
        for anchor, seg_diag, _votes in anchors:
            # corridor dedup: a long read's own segments all rank as
            # anchors, and each would re-enumerate the same corridor of
            # paths; an anchor already inside a kept candidate adds no new
            # corridor (the DP extends across the whole path anyway)
            if any(anchor in key for key in cands):
                continue
            for steps in paths_around_anchor(graph, anchor, len(seq),
                                             max_paths, audit=audit):
                key = tuple(steps)
                if key in seen:
                    continue
                seen.add(key)
                if key not in path_cache:
                    path_cache[key] = build_oriented_struct(graph, steps,
                                                            lut)
                # expected alignment diagonal: anchor segment's offset in
                # this path + the anchor's in-segment diagonal vote — the
                # banded scorer centers its band here
                anchor_idx = key.index(anchor)
                cand_deltas[(r, key)] = (
                    path_cache[key].offsets[anchor_idx] + seg_diag)
                cands.append(key)
        # chain-colinearity rank: a candidate's support is the summed vote
        # count of the read's anchors that lie ON this path with a
        # projected diagonal inside the banded corridor — the minimap2-
        # style colinear-chain weight, computed from votes already in
        # hand.  Wrong-locus candidates (most pairs at assembly scale) get
        # only their seeding anchor's votes; the true placement accumulates
        # every colinear anchor.  Candidates are sorted by it (stable:
        # generation order breaks ties) so the placement loop can score
        # just a top-k prefix.
        for key in cands:
            delta = cand_deltas[(r, key)]
            op = path_cache[key]
            step_pos = op.step_pos
            if step_pos is None:
                # first-occurrence index per step (simple paths never
                # repeat a state, so this equals tuple.index); cached on
                # the path
                step_pos = {}
                for k_idx, st in enumerate(key):
                    if st not in step_pos:
                        step_pos[st] = k_idx
                op.step_pos = step_pos
            chain = 0
            for a2, d2, v2 in anchors:
                k_idx = step_pos.get(a2)
                if k_idx is not None and \
                        abs(op.offsets[k_idx] + d2 - delta) <= CHAIN_TOL:
                    chain += v2
            cand_chain[(r, key)] = chain
        cands.sort(key=lambda key: -cand_chain[(r, key)])
        return cands

    read_audits = [CapAudit() for _ in reads]
    with _timed("seeding"):
        anchor_lists = anchors_with_diag_batch(
            index, [encode_seq(seq) for _, seq in reads],
            params.max_anchors, audits=read_audits)
        cand_lists: List[List[tuple]] = [
            gen_candidates(r, seq, anchor_lists[r],
                           params.max_paths_per_anchor, read_audits[r])
            for r, (_, seq) in enumerate(reads)]

    # working read codes: placement-round masking (work[r][a:b] = PAD)
    # writes into these arrays, and the device pool re-uploads masked rows
    work = [np.array(encode_seq(seq), dtype=np.int8) for _, seq in reads]

    all_hits: List[List[GafHit]] = [[] for _ in reads]
    accepted: List[List[Tuple[int, int]]] = [[] for _ in reads]
    active = [r for r in range(len(reads)) if cand_lists[r]]
    pools = DevicePools(work, graph, device)
    dirty_reads: set = set()   # rows masked since the last pool sync

    def score_pairs_full(pairs):
        """Bucketed full-DP pairwise scoring -> {pair_index: (v, bi, bj, 0)}."""
        buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for n, (r, key) in enumerate(pairs):
            lr_b = pad_pow2(len(work[r]), floor=16)
            lp_b = pad_pow2(len(path_cache[key]), floor=16)
            buckets[(lr_b, lp_b)].append(n)
        results = {}
        for (lr_b, lp_b), idxs in buckets.items():
          # chunked dispatches: a round can hold far more pairs than one
          # (N, lr_b) + (N, lp_b) batch should
          for c0 in range(0, len(idxs), SCORE_CHUNK):
            chunk = idxs[c0:c0 + SCORE_CHUNK]
            n_pad = pad_pow2(len(chunk), floor=8)
            rc = np.full((n_pad, lr_b), seqalign.PAD, np.int8)
            pc = np.full((n_pad, lp_b), seqalign.PAD, np.int8)
            for slot, n in enumerate(chunk):
                r, key = pairs[n]
                rc[slot, :len(work[r])] = work[r]
                pcodes = codes_of(key)
                pc[slot, :len(pcodes)] = pcodes
            best, bi, bj = (x.cpu().numpy() for x in
                            seqalign.batched_pair_scores(
                                torch.from_numpy(rc).to(device),
                                torch.from_numpy(pc).to(device)))
            for slot, n in enumerate(chunk):
                # 0: scored by the full DP -> traceback must be full too
                results[n] = (int(best[slot]), int(bi[slot]), int(bj[slot]),
                              0)
        return results

    BAND = params.band
    WIDE_BAND = params.wide_band

    def score_pairs(pairs):
        """Banded-first scoring: anchors supply the expected diagonal, so
        each pair costs O(Lr x BAND) instead of O(Lr x Lp); pairs whose
        banded best touches the band edge or misses min_score are rescored
        with the full DP (wrong-diagonal / out-of-band safety net)."""
        if not pairs:
            return {}
        deltas = [cand_deltas.get(p) for p in pairs]
        if any(d is None for d in deltas):
            return score_pairs_full(pairs)

        # flush masked reads + register every path key BEFORE the first
        # dispatch, so the path tables grow at most once per round
        if dirty_reads:
            pools.update_reads(sorted(dirty_reads), work)
            dirty_reads.clear()
        rows = [pools.path_idx(key, path_cache[key]) for _, key in pairs]
        pools.sync_paths()
        irregular = [n for n, row in enumerate(rows) if row is None]

        def banded_round(idx_list, width, results, keep_low=False,
                         keep_edge=False):
            """Banded-score pairs[n] for n in idx_list at `width`; stores
            accepted results and returns (edge_flagged, sub_threshold)
            index lists for the next ladder rung.  keep_low/keep_edge make
            this the terminal rung for that class — sub-threshold pairs
            are rejected by the placement loop anyway, and edge-flagged
            ones fail the traceback parity gates into the exact host
            walk.

            Dispatches ship only row indices; read codes and the segment
            arena live on device (see DevicePools) and path strips are
            assembled there."""
            redo_edge, redo_low = [], []
            # dispatch ALL chunks before fetching any result: device
            # execution overlaps host chunk prep (the fetch is the
            # synchronization point)
            inflight = []
            for c0 in range(0, len(idx_list), SCORE_CHUNK):  # bounded dispatch
                chunk = idx_list[c0:c0 + SCORE_CHUNK]
                ridx = np.zeros((len(chunk),), np.int32)
                pidx = np.zeros((len(chunk),), np.int32)
                dl = np.zeros((len(chunk),), np.int32)
                for slot, n in enumerate(chunk):
                    r, key = pairs[n]
                    ridx[slot] = r
                    pidx[slot] = pools.path_row[key]
                    dl[slot] = deltas[n]
                inflight.append((chunk, seqalign.banded_arena_scores(
                    pools.arena, pools.cum_off, pools.base_ptr, pools.plen,
                    pools.reads, ridx, pidx, dl, width=width,
                    materialize=False)))
            for chunk, out in inflight:
                best, bi, bj, edge = (x.cpu().numpy() for x in out)
                for slot, n in enumerate(chunk):
                    if edge[slot] and not keep_edge:
                        redo_edge.append(n)
                    elif best[slot] < min_score and not keep_low:
                        redo_low.append(n)
                    else:
                        # width > 0: banded traceback eligible at this width
                        results[n] = (int(best[slot]), int(bi[slot]),
                                      int(bj[slot]), width)
            return redo_edge, redo_low

        results: Dict[int, Tuple[int, int, int, int]] = {}
        if irregular:
            # paths the arena mapping can't represent: exact host-array DP
            sub = score_pairs_full([pairs[n] for n in irregular])
            for slot, n in enumerate(irregular):
                results[n] = sub[slot]
        e1, l1 = banded_round([n for n, row in enumerate(rows)
                               if row is not None], BAND, results)
        redo = e1 + l1
        if redo:
            # one widening for everything: band misses are usually small
            # diagonal drift.  Sub-threshold pairs that stay weak in the
            # 4x band are genuinely weak (masked reads of later placement
            # rounds score low everywhere; rescoring them at full width
            # would build huge full-DP batches).
            redo, _ = banded_round(redo, WIDE_BAND, results, keep_low=True)
        if redo:
            # only band-EDGE survivors ride further: their optimum may
            # genuinely continue outside the band
            lr_b = pad_pow2(max(len(work[pairs[n][0]]) for n in redo), floor=16)
            lp_b = pad_pow2(max(len(path_cache[pairs[n][1]]) for n in redo),
                            floor=16)
            if lr_b * lp_b <= 4096 * 8192:
                sub = score_pairs_full([pairs[n] for n in redo])
                for slot, n in enumerate(redo):
                    results[n] = sub[slot]
            else:
                # the full DP is not run beyond this area (the rule decides
                # which result is emitted, so it is kept as it stands);
                # terminal rung: a 4 x WIDE_BAND anchored band, accepted
                # as-is.  A placement needing more drift than that around
                # its anchor diagonal is effectively unplaceable by this
                # candidate — the min_score filter and the traceback parity
                # gates keep anything emitted honest.
                banded_round(redo, 4 * WIDE_BAND, results, keep_low=True,
                             keep_edge=True)
        return results

    # sound cross-round pruning: masking accepted regions only DEGRADES
    # cell scores (match -> blocked), so a (read, candidate) pair that
    # scored below min_score once can never recover — drop it from later
    # rounds (the placement loop breaks below min_score, and s2/mapq
    # competitors also require >= min_score, so behavior is identical).
    # Rounds 2-4 used to re-score every candidate of still-active reads.
    dead_pairs: set = set()

    def placement_rounds(active: List[int]) -> None:
      # Two-wave scoring with chain-ranked top-k: each read's first wave
      # scores only its CHAIN_TOP_K best-supported candidates (ties at the
      # boundary extend, capped at 2x, so an equal-support multi-mapping
      # competitor is never dropped from the mapq evidence).  A read that
      # places nothing — or keeps a scoreable uncovered region (chimeric /
      # supplementary case whose second locus may rank below the cut) —
      # opens its full candidate list on the next iteration.  Scores are
      # cached per (read, candidate) and invalidated when the read is
      # masked, so the tail-opening iteration re-scores nothing it already
      # paid for; with pruning inactive (few candidates) the flow is
      # identical to the previous 4-round loop (mask_rounds keeps the same
      # 4-masking budget per read).
      score_cache: Dict[Tuple[int, tuple], Tuple[int, int, int, int]] = {}
      mask_rounds: Dict[int, int] = {r: 0 for r in active}
      open_k: Dict[int, int] = {}
      for r in active:
          keys = cand_lists[r]
          k = min(CHAIN_TOP_K, len(keys))
          if k < len(keys):
              edge = cand_chain.get((r, keys[k - 1]), 0)
              while (k < len(keys) and k < 2 * CHAIN_TOP_K
                     and cand_chain.get((r, keys[k]), 0) == edge):
                  k += 1
          open_k[r] = k
      for _iter in range(8):
        if not active:
            break
        pairs_all = [(r, key) for r in active
                     for key in cand_lists[r][:open_k[r]]
                     if (r, key) not in dead_pairs]
        to_score = [p for p in pairs_all if p not in score_cache]
        with _timed("scoring"):
            scored = score_pairs(to_score)
        for n, p in enumerate(to_score):
            score_cache[p] = scored[n]
        by_read: Dict[int, List[tuple]] = defaultdict(list)
        for r, key in pairs_all:
            v, bi, bj, banded = score_cache[(r, key)]
            if v < min_score:
                dead_pairs.add((r, key))
            by_read[r].append((v, bi, bj, banded, key))
        next_active = []
        for r in active:
            entries = sorted(by_read[r], key=lambda e: -e[0])
            placed = False
            rcodes = work[r]
            qlen = len(rcodes)
            for v, bi, bj, banded, key in entries:
                if v < min_score:
                    break
                path = path_cache[key]
                if _reject_ending_inside(graph, path, v, bi, bj,
                                         accepted[r], all_hits[r]):
                    continue
                pl = None
                with _timed("traceback"):
                    if banded:  # band width used by the scorer (0 = full DP)
                        # banded traceback (O(Lr x band)); parity-gated —
                        # None falls through to the exact full-matrix walk
                        delta = cand_deltas.get((r, key))
                        if delta is not None:
                            pl = seqalign.banded_traceback(
                                rcodes, codes_of(key), bi, bj, delta, banded,
                                v)
                    if pl is None:
                        pl = seqalign.traceback(rcodes, codes_of(key), bi, bj)
                if pl.score < min_score:
                    continue
                shadowed = [h for (a, b), h in zip(accepted[r], all_hits[r])
                            if not (pl.qend <= a or pl.qstart >= b)]
                if shadowed:
                    _note_competitor(graph, path, pl, shadowed)
                    continue
                path_str, plen, ps, pe = _trim_to_subpath(
                    graph, path, pl.pstart, pl.pend)
                accepted[r].append((pl.qstart, pl.qend))
                blocklen = sum(x for x, _ in pl.cigar)
                all_hits[r].append(GafHit(pl.score, pl.qstart, pl.qend,
                                          path_str, plen, ps, pe, pl.matches,
                                          pl.nm, blocklen, _cigar_str(pl.cigar)))
                placed = True
            if placed:
                for a, b in accepted[r]:
                    work[r][a:b] = seqalign.PAD
                dirty_reads.add(r)
                mask_rounds[r] += 1
                for key in cand_lists[r]:
                    score_cache.pop((r, key), None)  # masked read changed
            still = _longest_uncovered(qlen, accepted[r]) >= min_score
            if (not placed or still) and open_k[r] < len(cand_lists[r]):
                open_k[r] = len(cand_lists[r])   # open the chain tail
                next_active.append(r)
            elif placed and still and mask_rounds[r] < 4:
                next_active.append(r)
        active = next_active

    placement_rounds(active)

    # adaptive caps: a read left unplaced (or with a scoreable uncovered
    # stretch) while its candidate generation hit a cap gets one retry with
    # the caps raised 4x — a correct placement must never be lost to a
    # default bound
    retry = [r for r in range(len(reads))
             if read_audits[r]
             and (not all_hits[r]
                  or _longest_uncovered(len(reads[r][1]),
                                        accepted[r]) >= min_score)]
    if retry:
        with _timed("seeding"):
            retry_anchors = anchors_with_diag_batch(
                index, [encode_seq(reads[r][1]) for r in retry],
                4 * params.max_anchors)
            for i, r in enumerate(retry):
                read_audits[r].hit("reads_retried_with_raised_caps")
                cand_lists[r] = gen_candidates(
                    r, reads[r][1], retry_anchors[i],
                    4 * params.max_paths_per_anchor, CapAudit())
        placement_rounds([r for r in retry if cand_lists[r]])

    audit = CapAudit()
    for ra in read_audits:
        audit.merge(ra)
    audit.report("align(seeded)")

    for hits in all_hits:
        for h in hits:
            h.mapq = _mapq(h.score, h.s2)
    return [(name, len(seq), sorted(all_hits[r], key=lambda h: -h.score))
            for r, (name, seq) in enumerate(reads)]


def _align_with_paths(graph: Graph, reads: Sequence[Tuple[str, str]],
                      paths: List[OrientedPath],
                      min_score: int = MIN_SCORE,
                      device="cuda") -> List[Tuple[str, int, List[GafHit]]]:
    if not paths or not reads:
        return [(name, len(seq), []) for name, seq in reads]

    # pow2 shape buckets, as the JAX package pads them
    from ..ops.nw_path import pad_pow2
    max_lr = pad_pow2(max(len(seq) for _, seq in reads), floor=16)
    max_lp = pad_pow2(max(len(p.seq) for p in paths), floor=16)
    R, P = len(reads), len(paths)
    P_pad = pad_pow2(P, floor=1)  # bucket the path dim too (all-PAD dummies
    # never reach min_score, so they are inert)
    read_codes = np.full((R, max_lr), seqalign.PAD, dtype=np.int8)
    for i, (_, seq) in enumerate(reads):
        read_codes[i, :len(seq)] = encode_seq(seq)
    path_codes = np.full((P_pad, max_lp), seqalign.PAD, dtype=np.int8)
    for i, p in enumerate(paths):
        path_codes[i, :len(p.seq)] = encode_seq(p.seq)

    path_dev = torch.from_numpy(path_codes).to(device)

    all_hits: List[List[GafHit]] = [[] for _ in reads]
    accepted: List[List[Tuple[int, int]]] = [[] for _ in reads]
    active = list(range(R))
    work_codes = read_codes.copy()
    # iterative placement: a read's best placement can shadow a lower-scoring
    # supplementary placement on the SAME path, so mask accepted query
    # regions and re-score until nothing new qualifies (random2's read8 finds
    # '<11' only after its '<13' region is masked)
    for _round in range(4):
        if not active:
            break
        # pad the active batch to a power-of-2 bucket (all-PAD rows score 0)
        bucket = max(8, 1 << (len(active) - 1).bit_length())
        batch = np.full((bucket, max_lr), seqalign.PAD, dtype=np.int8)
        batch[:len(active)] = work_codes[active]
        best, bi, bj = (x.cpu().numpy() for x in
                        seqalign.batched_local_scores(
                            torch.from_numpy(batch).to(device), path_dev))
        best, bi, bj = best[:len(active)], bi[:len(active)], bj[:len(active)]
        next_active = []
        for ai, r in enumerate(active):
            name, seq = reads[r]
            rcodes = work_codes[r, :len(seq)]
            order = np.argsort(-best[ai], kind="stable")
            placed = False
            for pi in order:
                if best[ai, pi] < min_score or pi >= P:
                    break
                pcodes = path_codes[pi, :len(paths[pi].seq)]
                if _reject_ending_inside(graph, paths[pi], int(best[ai, pi]),
                                         int(bi[ai, pi]), int(bj[ai, pi]),
                                         accepted[r], all_hits[r]):
                    continue
                pl = seqalign.traceback(rcodes, pcodes,
                                        int(bi[ai, pi]), int(bj[ai, pi]))
                if pl.score < min_score:
                    continue
                shadowed = [h for (a, b), h in zip(accepted[r], all_hits[r])
                            if not (pl.qend <= a or pl.qstart >= b)]
                if shadowed:
                    _note_competitor(graph, paths[pi], pl, shadowed)
                    continue
                path_str, plen, ps, pe = _trim_to_subpath(
                    graph, paths[pi], pl.pstart, pl.pend)
                accepted[r].append((pl.qstart, pl.qend))
                blocklen = sum(n for n, _ in pl.cigar)
                all_hits[r].append(GafHit(pl.score, pl.qstart, pl.qend,
                                          path_str, plen, ps, pe, pl.matches,
                                          pl.nm, blocklen, _cigar_str(pl.cigar)))
                placed = True
            if placed:
                for a, b in accepted[r]:
                    work_codes[r, a:b] = seqalign.PAD
                uncovered = _longest_uncovered(len(seq), accepted[r])
                if uncovered >= min_score:
                    next_active.append(r)
        active = next_active

    out = []
    for r, (name, seq) in enumerate(reads):
        hits = sorted(all_hits[r], key=lambda h: -h.score)
        for h in hits:
            h.mapq = _mapq(h.score, h.s2)
        out.append((name, len(seq), hits))
    return out


def _longest_uncovered(qlen: int, intervals: List[Tuple[int, int]]) -> int:
    covered = sorted(intervals)
    longest = 0
    pos = 0
    for a, b in covered:
        longest = max(longest, a - pos)
        pos = max(pos, b)
    return max(longest, qlen - pos)


def emit_gaf(results, write) -> None:
    for name, qlen, hits in results:
        for h in hits:
            as_score = h.blocklen - 2.94 * h.nm
            dv = h.nm / h.blocklen if h.blocklen else 0.0
            ident = h.matches / h.blocklen if h.blocklen else 0.0
            write("\t".join([
                name, str(qlen), str(h.qstart), str(h.qend), "+",
                h.path_str, str(h.plen), str(h.pstart), str(h.pend),
                str(h.matches), str(h.blocklen), str(h.mapq),
                f"NM:i:{h.nm}", f"AS:f:{_fmt_g(as_score)}", f"dv:f:{_fmt_g(dv)}",
                f"id:f:{_fmt_g(ident)}", f"cg:Z:{h.cigar}",
            ]) + "\n")


def run_graph_aligner(graph: Graph, read_files, out_file: str,
                      preset: str = "hifi", overrides=None,
                      echo: bool = False, out=None, shard=None,
                      device="cuda") -> None:
    if graph is None:
        print("align: missing input graph (-f)", file=sys.stderr)
        raise SystemExit(1)
    reads = load_reads(read_files)
    params = PRESETS.get(preset)
    if params is None:
        # reference parity: unknown preset names abort (src/main.cpp:185-188)
        print(f"Could not find preset: {preset}")
        raise SystemExit(1)
    if overrides:
        import dataclasses

        params = dataclasses.replace(params, **overrides)
        # band widths are kept multiples of 8, as the JAX package rounds
        # them: the rounded values are echoed and used
        params = dataclasses.replace(
            params, band=-(-params.band // 8) * 8,
            wide_band=-(-max(params.wide_band, params.band) // 8) * 8)
    if echo and (shard is None or shard[0] == 0):
        # analogue of the reference's `Invoking: <GraphAligner cmd>` echo
        # (src/main.cpp:167-168): print the fully resolved in-house
        # invocation so runs are reproducible from the log.  When the GAF
        # itself streams to stdout (no -o / stdout-extension dispatch),
        # the echo moves to stderr so the record stream stays pure.
        from ..io.stream import STDOUT_EXTS

        to_stdout = (not out_file) or out_file in STDOUT_EXTS
        echo_out = sys.stderr if to_stdout else (out or sys.stdout)
        echo_out.write(
            f"Invoking: gfalign-tpu-align -p {preset}"
            f" --seed-k {params.seed_k} --min-score {params.min_score}"
            f" --max-anchors {params.max_anchors}"
            f" --max-paths-per-anchor {params.max_paths_per_anchor}"
            f" --band {params.band} --wide-band {params.wide_band}\n")
    if shard is not None and shard[1] > 1:
        from ..parallel.dist import allgather_bytes

        allgather_bytes(b"")  # raises: distributed align is a later slice
    results = align_reads(graph, reads, params=params, device=device)
    n_hits = sum(len(h) for _, _, h in results)
    lg.verbose(f"Aligned {len(reads)} reads: {n_hits} records")
    if out_file:
        stream = OutputStream(out_file)
        emit_gaf(results, stream.write)
        stream.close()
    else:
        emit_gaf(results, sys.stdout.write)
