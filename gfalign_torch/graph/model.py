"""In-memory assembly-graph model (functional equivalent of the gfalibs
InSequences/InSegment/InEdge surface that gfalign consumes — reconstructed
from call sites, see SURVEY.md section 2.3; no gfalibs code exists in the
reference snapshot).

Design notes (TPU-first):
  * Segments get dense integer uIds assigned on first mention (S/L/J/P/E/G/O
    lines), so every downstream structure is an integer tensor.
  * The bidirected adjacency is kept both as per-node Python lists (exact
    traversal-order parity with the reference's std::vector adjacency,
    needed for byte-equal search output) and as padded numpy arrays for
    device-side frontier expansion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Segment:
    name: str
    seq: str = ""            # may be "" if GFA used '*'
    length: int = 0
    tags: List[Tuple[str, str, str]] = field(default_factory=list)  # (label, type, content)


@dataclass
class Link:
    """An edge (GFA1 L line / GFA2 E line).  Orientations are '+'/'-'."""
    s1: int
    or1: str
    s2: int
    or2: str
    overlap: str = "*"       # CIGAR (L col 6) or GFA2 alignment field
    tags: List[Tuple[str, str, str]] = field(default_factory=list)


@dataclass
class Gap:
    """A gap (GFA1.2 J line / GFA2 G line)."""
    gid: str
    s1: int
    or1: str
    s2: int
    or2: str
    dist: int = 0
    tags: List[Tuple[str, str, str]] = field(default_factory=list)


@dataclass
class GfaPath:
    """A path / ordered group (GFA1 P line, GFA2 O line).

    steps[i] = (segment uId, orientation); seps[i] describes the junction
    between steps[i] and steps[i+1]: ("edge", cigar) or ("gap", dist).
    The GFA1.2 dialect of the reference fixtures uses ','-separated steps for
    edge junctions and ';'-separated steps for gap junctions, with column 4
    carrying the per-junction CIGAR / gap length
    (reference testFiles/random2.gfa:10-11).
    """
    name: str
    steps: List[Tuple[int, str]] = field(default_factory=list)
    seps: List[Tuple[str, object]] = field(default_factory=list)


class AdjEntry:
    """One directed entry of the bidirected adjacency list: standing on the
    source node with orientation `or0`, you may step to node `nid` entering
    with orientation `or1` (same Edge{or0, id, or1, weight} tuple the
    reference traverses, src/eval.cpp:136-151)."""

    __slots__ = ("or0", "nid", "or1", "weight")

    def __init__(self, or0: str, nid: int, or1: str, weight: int = 1):
        self.or0 = or0
        self.nid = nid
        self.or1 = or1
        self.weight = weight

    def key(self) -> Tuple[str, int, str]:
        return (self.or0, self.nid, self.or1)


def flip(orientation: str) -> str:
    return "-" if orientation == "+" else "+"


class Graph:
    def __init__(self) -> None:
        self.segments: List[Optional[Segment]] = []   # indexed by uId; None = name seen but no S line yet
        self.name_to_id: Dict[str, int] = {}
        self.links: List[Link] = []
        self.gaps: List[Gap] = []
        self.paths: List[GfaPath] = []
        self.header_tags: List[Tuple[str, str, str]] = []
        self._adj: Optional[List[List[AdjEntry]]] = None

    # -- vocab ------------------------------------------------------------

    def uid(self, name: str) -> int:
        """Return the uId for a segment name, assigning one on first mention."""
        got = self.name_to_id.get(name)
        if got is None:
            got = len(self.segments)
            self.name_to_id[name] = got
            self.segments.append(None)
        return got

    def lookup(self, name: str) -> Optional[int]:
        return self.name_to_id.get(name)

    def add_segment(self, name: str, seq: str, tags=None) -> int:
        sid = self.uid(name)
        seg = Segment(name=name, seq=seq, length=len(seq), tags=list(tags or []))
        if seq == "*":
            seg.seq = ""
            seg.length = 0
            for lab, typ, content in seg.tags:
                if lab == "LN" and typ == "i":
                    seg.length = int(content)
        self.segments[sid] = seg
        return sid

    def segment(self, sid: int) -> Segment:
        seg = self.segments[sid]
        if seg is None:
            # Name was referenced (L/P line) but never defined by an S line.
            name = next(n for n, i in self.name_to_id.items() if i == sid)
            seg = Segment(name=name)
            self.segments[sid] = seg
        return seg

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def segment_names(self) -> List[str]:
        return [self.segment(i).name for i in range(self.n_segments)]

    # -- adjacency --------------------------------------------------------

    def build_adjacency(self) -> List[List[AdjEntry]]:
        """Bidirected adjacency from the L/E edges, in file order with the
        mirror (reverse-complement) entry appended at the destination node as
        each edge is read (matches the expansion order the reference's search
        inherits from gfalibs InSequences::buildEdgeGraph)."""
        adj: List[List[AdjEntry]] = [[] for _ in range(self.n_segments)]
        for e in self.links:
            adj[e.s1].append(AdjEntry(e.or1, e.s2, e.or2))
            adj[e.s2].append(AdjEntry(flip(e.or2), e.s1, flip(e.or1)))
        self._adj = adj
        return adj

    @property
    def adjacency(self) -> List[List[AdjEntry]]:
        if self._adj is None:
            self.build_adjacency()
        return self._adj

    def adjacency_arrays(self):
        """Padded (n_nodes, max_degree) arrays for device-side frontier
        expansion: neighbor id (-1 pad), required source orientation
        (0='+',1='-'), entry orientation."""
        adj = self.adjacency
        max_deg = max((len(a) for a in adj), default=1) or 1
        n = self.n_segments
        nbr = np.full((n, max_deg), -1, dtype=np.int32)
        src_or = np.zeros((n, max_deg), dtype=np.int8)
        dst_or = np.zeros((n, max_deg), dtype=np.int8)
        for i, entries in enumerate(adj):
            for j, e in enumerate(entries):
                nbr[i, j] = e.nid
                src_or[i, j] = 0 if e.or0 == "+" else 1
                dst_or[i, j] = 0 if e.or1 == "+" else 1
        return nbr, src_or, dst_or

    # -- subgraph ---------------------------------------------------------

    def subgraph(self, nodelist: List[str]) -> "Graph":
        """Subgraph induced by a node-name list (reference mode 2 delegates
        to gfalibs InSequences::subgraph, src/input-gfalign.cpp:100-108):
        retained segments, edges/gaps with both endpoints retained, and paths
        whose every step is retained."""
        keep = set(nodelist)
        sub = Graph()
        old_to_new: Dict[int, int] = {}
        for sid in range(self.n_segments):
            seg = self.segment(sid)
            if seg.name in keep:
                nid = sub.add_segment(seg.name, seg.seq, seg.tags)
                if seg.seq == "" and seg.length:
                    sub.segments[nid].length = seg.length
                old_to_new[sid] = nid
        for e in self.links:
            if e.s1 in old_to_new and e.s2 in old_to_new:
                sub.links.append(Link(old_to_new[e.s1], e.or1, old_to_new[e.s2], e.or2, e.overlap, list(e.tags)))
        for g in self.gaps:
            if g.s1 in old_to_new and g.s2 in old_to_new:
                sub.gaps.append(Gap(g.gid, old_to_new[g.s1], g.or1, old_to_new[g.s2], g.or2, g.dist, list(g.tags)))
        for p in self.paths:
            if all(sid in old_to_new for sid, _ in p.steps):
                sub.paths.append(GfaPath(p.name, [(old_to_new[s], o) for s, o in p.steps], list(p.seps)))
        sub.header_tags = list(self.header_tags)
        return sub
