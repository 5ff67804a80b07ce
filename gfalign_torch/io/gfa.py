"""GFA1 / GFA1.2 / GFA2 parser (functional equivalent of gfalibs readGFA as
consumed by the reference; dialect taken from the reference fixtures
testFiles/random2.gfa and testFiles/random2.gfa2).

Supported records:
  H                              header (tags kept)
  S name seq [tags]              GFA1 segment
  S name len seq [tags]          GFA2 segment
  L s1 o1 s2 o2 cigar [tags]     GFA1 link
  E s1 o1 s2 o2 cigar [tags]     GFA2 edge (gfastats dialect, mirrors L)
  J s1 o1 s2 o2 dist [tags]      GFA1.2 gap
  G gid s1o s2o dist [tags]      GFA2 gap
  P name steps junctions         GFA1 path; ','=edge junction, ';'=gap
                                 junction; column 4 lists per-junction
                                 CIGARs / gap lengths in order
  O name tok tok ...             GFA2 ordered group; tokens are 'seg±' or
                                 gap ids referencing G lines

Segment uIds are assigned on first mention in any record.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Tuple

from ..graph.model import Gap, GfaPath, Graph, Link
from ..utils.profiling import span
from .stream import iter_lines


def _parse_tags(cols: List[str]) -> List[Tuple[str, str, str]]:
    tags = []
    for col in cols:
        parts = col.split(":", 2)
        if len(parts) == 3:
            tags.append((parts[0], parts[1], parts[2]))
    return tags


def _parse_path_line(graph: Graph, name: str, steps_col: str, junction_col: str) -> GfaPath:
    path = GfaPath(name)
    tokens = re.split(r"([,;])", steps_col)
    junctions = junction_col.split(",") if junction_col and junction_col != "*" else []
    jidx = 0
    for tok in tokens:
        if tok in (",", ";"):
            value = junctions[jidx] if jidx < len(junctions) else ("*" if tok == "," else "0")
            jidx += 1
            if tok == ",":
                path.seps.append(("edge", value))
            else:
                path.seps.append(("gap", int(value)))
        elif tok:
            orientation = tok[-1]
            seg_name = tok[:-1]
            path.steps.append((graph.uid(seg_name), orientation))
    return path


def parse_gfa_lines(lines: Iterable[str], graph: Graph = None) -> Graph:
    graph = graph if graph is not None else Graph()
    is_gfa2 = False
    pending_o_lines: List[List[str]] = []
    for raw in lines:
        if not raw or raw.startswith("#"):
            continue
        cols = raw.rstrip("\n").split("\t")
        rtype = cols[0]
        if rtype == "H":
            graph.header_tags.extend(_parse_tags(cols[1:]))
            for lab, typ, content in graph.header_tags:
                if lab == "VN" and content.startswith("2"):
                    is_gfa2 = True
        elif rtype == "S":
            if is_gfa2 or (len(cols) >= 4 and cols[2].isdigit()):
                # GFA2: S <name> <len> <seq> [tags]
                sid = graph.add_segment(cols[1], cols[3] if cols[3] != "*" else "*", _parse_tags(cols[4:]))
                if cols[3] == "*":
                    graph.segments[sid].length = int(cols[2])
            else:
                graph.add_segment(cols[1], cols[2], _parse_tags(cols[3:]))
        elif rtype in ("L", "E"):
            graph.links.append(
                Link(graph.uid(cols[1]), cols[2], graph.uid(cols[3]), cols[4],
                     cols[5] if len(cols) > 5 else "*", _parse_tags(cols[6:]))
            )
        elif rtype == "J":
            graph.gaps.append(
                Gap("", graph.uid(cols[1]), cols[2], graph.uid(cols[3]), cols[4],
                    int(cols[5]) if len(cols) > 5 and cols[5] not in ("*", "") else 0,
                    _parse_tags(cols[6:]))
            )
        elif rtype == "G":
            s1, o1 = cols[2][:-1], cols[2][-1]
            s2, o2 = cols[3][:-1], cols[3][-1]
            graph.gaps.append(
                Gap(cols[1], graph.uid(s1), o1, graph.uid(s2), o2,
                    int(cols[4]) if cols[4] not in ("*", "") else 0, _parse_tags(cols[5:]))
            )
        elif rtype == "P":
            graph.paths.append(_parse_path_line(graph, cols[1], cols[2], cols[3] if len(cols) > 3 else "*"))
        elif rtype == "O":
            pending_o_lines.append(cols)
    # O lines may reference G lines appearing later, so resolve them last.
    gap_by_id = {g.gid: g for g in graph.gaps if g.gid}
    edge_overlap = {}
    from .. graph.model import flip

    for e in graph.links:
        edge_overlap.setdefault((e.s1, e.or1, e.s2, e.or2), e.overlap)
        edge_overlap.setdefault((e.s2, flip(e.or2), e.s1, flip(e.or1)), e.overlap)
    for cols in pending_o_lines:
        path = GfaPath(cols[1])
        tokens = cols[2].split(" ") if len(cols) == 3 else cols[2:]
        pending_gap = None
        for tok in tokens:
            if tok in gap_by_id:
                pending_gap = gap_by_id[tok].dist
            elif tok:
                step = (graph.uid(tok[:-1]), tok[-1])
                if path.steps:
                    if pending_gap is not None:
                        path.seps.append(("gap", pending_gap))
                    else:
                        # adjacent segments: an edge junction; recover the
                        # overlap from the matching E record when present
                        prev = path.steps[-1]
                        path.seps.append(("edge", edge_overlap.get(
                            (prev[0], prev[1], step[0], step[1]), "*")))
                path.steps.append(step)
                pending_gap = None
        graph.paths.append(path)
    return graph


def read_gfa(path: str) -> Graph:
    """Read a GFA file.  Plain and gzipped files take the native columnar
    parse (threaded C++ chunk parse, native/gfalign_host.cpp, which inflates
    gz in memory -- the role of gfalibs' gz-capable StreamObj + threaded
    readGFA, reference src/input-gfalign.cpp:42-45); stdin takes the line
    parser above, which is also the oracle when `native.available()` is
    false.  Both produce identical graphs (tests/test_torch_native.py).
    The span io.read_gfa."""
    with span("io.read_gfa"):
        if path != "-":
            import pathlib

            from . import native

            if pathlib.Path(path).is_file() and native.available():
                graph = _read_gfa_native(path)
                if graph is not None:
                    return graph
        return parse_gfa_lines(iter_lines(path))


def _read_gfa_native(path: str) -> Graph:
    from . import native

    parsed = native.parse_gfa(path)
    if parsed is None:
        return None
    (dict_names, seg_uids, seg_lens, seg_seqs, seg_tags, link_ids,
     link_orients, link_overlaps, link_tags, other_lines) = parsed
    graph = Graph()
    # pre-seed the vocabulary in native first-mention order
    for name in dict_names:
        graph.uid(name)
    for i, sid in enumerate(seg_uids):
        name = dict_names[sid]
        tags = _parse_tags(seg_tags[i].split("\t")) if seg_tags[i] else []
        graph.add_segment(name, seg_seqs[i], tags)
        if seg_seqs[i] == "*" and seg_lens[i] >= 0:
            graph.segments[sid].length = int(seg_lens[i])
    orient = "+-"
    for i in range(len(link_ids)):
        tags = _parse_tags(link_tags[i].split("\t")) if link_tags[i] else []
        graph.links.append(Link(int(link_ids[i, 0]),
                                orient[link_orients[i, 0]],
                                int(link_ids[i, 1]),
                                orient[link_orients[i, 1]],
                                link_overlaps[i] or "*", tags))
    # rare records (H/J/G/P/O) re-use the sequential parser against the
    # same graph; every name they mention is already in the vocabulary, so
    # uId assignment is unaffected (O groups may still add new names, as
    # in the sequential parser)
    parse_gfa_lines(other_lines, graph=graph)
    return graph

