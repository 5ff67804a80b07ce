"""Building blocks of both align engines (engine/graph_align.py's
exhaustive one and engine/seeded.py's): oriented paths and their code
arrays, path enumeration, the cap audit, GAF hits with their trimming and
mapq, and the accept step that every walk's placement passes through."""

from __future__ import annotations

import re
from dataclasses import dataclass
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.model import Graph
from ..io.fastq import encode_seq
from ..utils.log import lg


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


def _longest_uncovered(qlen: int, intervals: List[Tuple[int, int]]) -> int:
    covered = sorted(intervals)
    longest = 0
    pos = 0
    for a, b in covered:
        longest = max(longest, a - pos)
        pos = max(pos, b)
    return max(longest, qlen - pos)


def accept(graph: Graph, path: OrientedPath, pl,
           accepted_r: List[Tuple[int, int]], hits_r: List[GafHit],
           min_score: int) -> bool:
    """Whether the walk's Placement `pl` on `path` is accepted: one below
    min_score is not, one over an accepted query interval is a competitor
    of the hits it shadows, any other joins the read's intervals and hits."""
    if pl.score < min_score:
        return False
    shadowed = [h for (a, b), h in zip(accepted_r, hits_r)
                if not (pl.qend <= a or pl.qstart >= b)]
    if shadowed:
        _note_competitor(graph, path, pl, shadowed)
        return False
    path_str, plen, ps, pe = _trim_to_subpath(graph, path, pl.pstart, pl.pend)
    accepted_r.append((pl.qstart, pl.qend))
    blocklen = sum(n for n, _ in pl.cigar)
    hits_r.append(GafHit(pl.score, pl.qstart, pl.qend, path_str, plen, ps, pe,
                         pl.matches, pl.nm, blocklen, _cigar_str(pl.cigar)))
    return True


def finish(reads, all_hits: List[List[GafHit]]):
    """[(read name, read length, its hits best first, with their mapq)]."""
    out = []
    for (name, seq), hits in zip(reads, all_hits):
        for h in hits:
            h.mapq = _mapq(h.score, h.s2)
        out.append((name, len(seq), sorted(hits, key=attrgetter("score"),
                                           reverse=True)))
    return out
