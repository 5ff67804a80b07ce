"""evalGFA: decorate GFA edges with read-support counts.

Equivalent of reference src/eval.cpp:34-61: build the alignment-derived
bidirected edge-weight table, then append `RC:i:<weight>` (0 when
unsupported) to every GFA link.
"""

from __future__ import annotations

from ..graph.model import Graph
from ..utils.log import lg
from .alignments import AlignmentSet, build_edge_weights, edge_weight


def eval_gfa(graph: Graph, alignments: AlignmentSet) -> None:
    weights = build_edge_weights(alignments, graph.name_to_id)
    for e in graph.links:
        w = edge_weight(weights, e.s1, e.or1, e.s2, e.or2)
        lg.verbose(f"Edge {e.s1}{e.or1} -> {e.s2}{e.or2}: weight {w}")
        e.tags.append(("RC", "i", str(w)))
