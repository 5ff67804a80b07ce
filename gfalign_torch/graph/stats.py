"""Assembly / graph statistics report.

Re-derivation of the gfalibs Report::reportStats output contract from the
reference's golden outputs (validateFiles/test.1.tst:4-36, test.4.tst:4-56;
gfalibs itself is not vendored in the reference snapshot).  Definitions that
the goldens pin down:

  * scaffolds = GFA paths; scaffold length = sum of step segment lengths +
    gap lengths (edge-junction overlaps are NOT subtracted: path
    '11+,12-,13+' with 4M,5M overlaps reports length 180);
  * contigs = individual segment steps of paths (6 contigs for 2 paths x 3
    steps, lengths {55,60,65} twice);
  * base composition is counted over *oriented* scaffold sequences
    (96:91:77:96 for random2 matches only the orientation-applied count);
  * the scaffold/contig averages print 'nan' for 0/0 but the gap average
    prints '0.00';
  * the edge-statistics block is only printed when the graph has edges
    (absent for random1, present for random2);
  * the whole report is printed in fixed 2-decimal mode, and that mode
    leaks into any later output of the process (SURVEY.md section 4 quirk 1).
"""

from __future__ import annotations

from typing import List, Tuple

from ..utils.fmt import cout, label
from .model import Graph, flip

_RC_TABLE = str.maketrans("ATCGatcg", "TAGCtagc")


def revcomp(seq: str) -> str:
    return seq.translate(_RC_TABLE)[::-1]


def _n50_stats(lengths: List[int]) -> Tuple[int, float, int]:
    """(N50, auN, L50) over a length multiset."""
    total = sum(lengths)
    if total == 0:
        return 0, 0.0, 0
    aun = sum(l * l for l in lengths) / total
    n50 = 0
    l50 = 0
    acc = 0
    for l in sorted(lengths, reverse=True):
        acc += l
        l50 += 1
        if acc >= total / 2:
            n50 = l
            break
    return n50, aun, l50


def _fmt_avg(total: float, count: int) -> str:
    if count == 0:
        return "nan"
    return cout.fmt(total / count)


class GraphStats:
    """All derived statistics; compute once, print via report()."""

    def __init__(self, graph: Graph) -> None:
        self.graph = graph
        g = graph
        self.scaffold_lengths: List[int] = []
        self.contig_lengths: List[int] = []
        self.gap_lengths: List[int] = []
        self.base_counts = {"A": 0, "C": 0, "G": 0, "T": 0}
        self.soft_masked = 0
        # per-SEGMENT composition, computed once (np.bincount over the raw
        # bytes, ~1000x the per-character Python loop at assembly scale) and
        # re-used per path step; a '-' step's counts are the complement swap
        # of the forward counts (revcomp preserves case and N, so
        # soft-masked and ignored-base tallies are orientation-invariant)
        import numpy as np

        seg_comp: dict = {}
        for path in g.paths:
            length = 0
            for sid, orientation in path.steps:
                seg = g.segment(sid)
                length += seg.length
                self.contig_lengths.append(seg.length)
                cached = seg_comp.get(sid)
                if cached is None:
                    arr = np.frombuffer(seg.seq.encode(), np.uint8)
                    lower = (arr >= 97) & (arr <= 122)
                    up = np.where(lower, arr - 32, arr)
                    bc = np.bincount(up, minlength=128)
                    cached = ({"A": int(bc[65]), "C": int(bc[67]),
                               "G": int(bc[71]), "T": int(bc[84])},
                              int(lower.sum()))
                    seg_comp[sid] = cached
                counts, soft = cached
                self.soft_masked += soft
                if orientation == "+":
                    for b in "ACGT":
                        self.base_counts[b] += counts[b]
                else:
                    self.base_counts["A"] += counts["T"]
                    self.base_counts["T"] += counts["A"]
                    self.base_counts["C"] += counts["G"]
                    self.base_counts["G"] += counts["C"]
            for kind, value in path.seps:
                if kind == "gap":
                    length += int(value)
                    self.gap_lengths.append(int(value))
            self.scaffold_lengths.append(length)
        self.segment_lengths = [g.segment(i).length for i in range(g.n_segments)]
        self.n_edges = len(g.links)
        self._components()

    def _components(self) -> None:
        g = self.graph
        n = g.n_segments
        parent = list(range(n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        used_ends = set()
        for e in g.links:
            parent[find(e.s1)] = find(e.s2)
            used_ends.add((e.s1, "R" if e.or1 == "+" else "L"))
            used_ends.add((e.s2, "L" if e.or2 == "+" else "R"))
        comp_len = {}
        comp_size = {}
        for sid in range(n):
            root = find(sid)
            comp_len[root] = comp_len.get(root, 0) + g.segment(sid).length
            comp_size[root] = comp_size.get(root, 0) + 1
        self.dead_ends = 2 * n - len(used_ends)
        isolated = [r for r, s in comp_size.items() if s == 1]
        self.disconnected_components = len(isolated)
        self.disconnected_length = sum(comp_len[r] for r in isolated)
        self.connected_components = len(comp_size) - self.disconnected_components
        self.largest_component_length = max(comp_len.values(), default=0)
        self.separated_components = len(comp_size)
        # simple bubbles: node pairs joined by >=2 parallel one-segment arms
        adj = g.adjacency
        self.bubbles = 0
        seen_pairs = set()
        for sid in range(n):
            for exit_or in "+-":
                # targets reachable via exactly one intermediate segment
                arm_targets = {}
                for e1 in adj[sid]:
                    if e1.or0 != exit_or:
                        continue
                    for e2 in adj[e1.nid]:
                        if e2.or0 != e1.or1 or e2.nid == sid:
                            continue
                        arm_targets.setdefault((e2.nid, e2.or1), set()).add(e1.nid)
                for (t, t_or), arms in arm_targets.items():
                    if len(arms) >= 2:
                        key = tuple(sorted([(sid, exit_or), (t, flip(t_or))]))
                        if key not in seen_pairs:
                            seen_pairs.add(key)
                            self.bubbles += 1
        self.circular_segments = sum(1 for e in g.links if e.s1 == e.s2)
        self.circular_paths = 0
        for path in g.paths:
            if not path.steps:
                continue
            last_sid, last_or = path.steps[-1]
            first_sid, first_or = path.steps[0]
            for e in adj[last_sid]:
                if e.or0 == last_or and e.nid == first_sid and e.or1 == first_or:
                    self.circular_paths += 1
                    break

    # -- printing ---------------------------------------------------------

    def report(self, out) -> None:
        cout.set_fixed2()
        w = out.write
        f = cout.fmt
        scaf = self.scaffold_lengths
        contig = self.contig_lengths
        gaps = self.gap_lengths
        scaf_n50, scaf_aun, scaf_l50 = _n50_stats(scaf)
        ctg_n50, ctg_aun, ctg_l50 = _n50_stats(contig)
        gap_n50, gap_aun, gap_l50 = _n50_stats(gaps)
        w(label("+++Assembly summary+++") + "\n")
        w(label("# scaffolds") + str(len(scaf)) + "\n")
        w(label("Total scaffold length") + str(sum(scaf)) + "\n")
        w(label("Average scaffold length") + _fmt_avg(sum(scaf), len(scaf)) + "\n")
        w(label("Scaffold N50") + str(scaf_n50) + "\n")
        w(label("Scaffold auN") + f(scaf_aun) + "\n")
        w(label("Scaffold L50") + str(scaf_l50) + "\n")
        w(label("Largest scaffold") + str(max(scaf, default=0)) + "\n")
        w(label("Smallest scaffold") + str(min(scaf, default=0)) + "\n")
        w(label("# contigs") + str(len(contig)) + "\n")
        w(label("Total contig length") + str(sum(contig)) + "\n")
        w(label("Average contig length") + _fmt_avg(sum(contig), len(contig)) + "\n")
        w(label("Contig N50") + str(ctg_n50) + "\n")
        w(label("Contig auN") + f(ctg_aun) + "\n")
        w(label("Contig L50") + str(ctg_l50) + "\n")
        w(label("Largest contig") + str(max(contig, default=0)) + "\n")
        w(label("Smallest contig") + str(min(contig, default=0)) + "\n")
        w(label("# gaps in scaffolds") + str(len(gaps)) + "\n")
        w(label("Total gap length in scaffolds") + str(sum(gaps)) + "\n")
        w(label("Average gap length in scaffolds")
          + f(sum(gaps) / len(gaps) if gaps else 0.0) + "\n")
        w(label("Gap N50 in scaffolds") + str(gap_n50) + "\n")
        w(label("Gap auN in scaffolds") + f(gap_aun) + "\n")
        w(label("Gap L50 in scaffolds") + str(gap_l50) + "\n")
        w(label("Largest gap in scaffolds") + str(max(gaps, default=0)) + "\n")
        w(label("Smallest gap in scaffolds") + str(min(gaps, default=0)) + "\n")
        bc = self.base_counts
        w(label("Base composition (A:C:G:T)")
          + f"{bc['A']}:{bc['C']}:{bc['G']}:{bc['T']}" + "\n")
        total_bases = sum(bc.values())
        gc = (bc["C"] + bc["G"]) / total_bases * 100 if total_bases else float("nan")
        w(label("GC content %") + f(gc) + "\n")
        w(label("# soft-masked bases") + str(self.soft_masked) + "\n")
        segs = self.segment_lengths
        w(label("# segments") + str(len(segs)) + "\n")
        w(label("Total segment length") + str(sum(segs)) + "\n")
        w(label("Average segment length") + _fmt_avg(sum(segs), len(segs)) + "\n")
        w(label("# gaps") + str(len(self.graph.gaps)) + "\n")
        w(label("# paths") + str(len(self.graph.paths)) + "\n")
        if self.n_edges > 0:
            w(label("# edges") + str(self.n_edges) + "\n")
            w(label("Average degree")
              + f(self.n_edges / len(segs) if segs else 0.0) + "\n")
            w(label("# connected components") + str(self.connected_components) + "\n")
            w(label("Largest connected component length") + str(self.largest_component_length) + "\n")
            w(label("# dead ends") + str(self.dead_ends) + "\n")
            w(label("# disconnected components") + str(self.disconnected_components) + "\n")
            w(label("Total length disconnected components") + str(self.disconnected_length) + "\n")
            w(label("# separated components") + str(self.separated_components) + "\n")
            w(label("# bubbles") + str(self.bubbles) + "\n")
            w(label("# circular segments") + str(self.circular_segments) + "\n")
            w(label("# circular paths") + str(self.circular_paths) + "\n")


def report_stats(graph: Graph, out) -> None:
    GraphStats(graph).report(out)
