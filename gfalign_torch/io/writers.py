"""GFA writers (gfalibs Report::writeToStream equivalent).

The reference snapshot does not vendor gfalibs, so the exact byte format of
its GFA writer is not recoverable; this writer defines a clean canonical
emission that round-trips everything our parser reads:

  H line, S lines (sequence + original tags, LN added when absent),
  L lines (overlap + tags, including appended RC decorations),
  J lines (GFA1.2 gaps), P lines (original ','/';' junction structure).

Output format is chosen by extension: *.gfa2 -> GFA2 (S len column, E/G/O
records), anything else -> GFA1.2.
"""

from __future__ import annotations

from ..graph.model import Graph
from .stream import OutputStream


def _tags_str(tags) -> str:
    return "".join(f"\t{lab}:{typ}:{content}" for lab, typ, content in tags)


def write_gfa1(graph: Graph, write) -> None:
    write("H\tVN:Z:1.2\n")
    for sid in range(graph.n_segments):
        seg = graph.segment(sid)
        seq = seg.seq if seg.seq else "*"
        tags = list(seg.tags)
        if not any(lab == "LN" for lab, _, _ in tags):
            tags.append(("LN", "i", str(seg.length)))
        write(f"S\t{seg.name}\t{seq}{_tags_str(tags)}\n")
    for e in graph.links:
        write(f"L\t{graph.segment(e.s1).name}\t{e.or1}\t{graph.segment(e.s2).name}"
              f"\t{e.or2}\t{e.overlap}{_tags_str(e.tags)}\n")
    for g in graph.gaps:
        write(f"J\t{graph.segment(g.s1).name}\t{g.or1}\t{graph.segment(g.s2).name}"
              f"\t{g.or2}\t{g.dist}{_tags_str(g.tags)}\n")
    for p in graph.paths:
        steps_str = ""
        junctions = []
        for i, (sid, orientation) in enumerate(p.steps):
            if i > 0:
                kind, value = p.seps[i - 1] if i - 1 < len(p.seps) else ("edge", "*")
                steps_str += ";" if kind == "gap" else ","
                junctions.append(str(value))
            steps_str += graph.segment(sid).name + orientation
        write(f"P\t{p.name}\t{steps_str}\t{','.join(junctions) if junctions else '*'}\n")


def write_gfa2(graph: Graph, write) -> None:
    write("H\tVN:Z:2.0\n")
    for sid in range(graph.n_segments):
        seg = graph.segment(sid)
        seq = seg.seq if seg.seq else "*"
        write(f"S\t{seg.name}\t{seg.length}\t{seq}{_tags_str(seg.tags)}\n")
    for e in graph.links:
        write(f"E\t{graph.segment(e.s1).name}\t{e.or1}\t{graph.segment(e.s2).name}"
              f"\t{e.or2}\t{e.overlap}{_tags_str(e.tags)}\n")
    gap_ids = {}
    gap_lines = []
    for gi, g in enumerate(graph.gaps):
        gid = g.gid or f"gap{gi}"
        gap_ids[(g.s1, g.or1, g.s2, g.or2, g.dist)] = gid
        gap_lines.append(f"G\t{gid}\t{graph.segment(g.s1).name}{g.or1}"
                         f"\t{graph.segment(g.s2).name}{g.or2}\t{g.dist}"
                         f"{_tags_str(g.tags)}\n")
    # a path's gap junction must reference a G record carrying ITS distance;
    # reuse a matching record, else synthesize one
    path_tokens = []
    n_synth = 0
    for pi, p in enumerate(graph.paths):
        tokens = []
        for i, (sid, orientation) in enumerate(p.steps):
            if i > 0 and i - 1 < len(p.seps) and p.seps[i - 1][0] == "gap":
                prev_sid, prev_or = p.steps[i - 1]
                dist = int(p.seps[i - 1][1])
                key = (prev_sid, prev_or, sid, orientation, dist)
                gid = gap_ids.get(key)
                if gid is None:
                    gid = f"pgap{n_synth}"
                    n_synth += 1
                    gap_ids[key] = gid
                    gap_lines.append(
                        f"G\t{gid}\t{graph.segment(prev_sid).name}{prev_or}"
                        f"\t{graph.segment(sid).name}{orientation}\t{dist}\n")
                tokens.append(gid)
            tokens.append(graph.segment(sid).name + orientation)
        path_tokens.append(tokens)
    for line in gap_lines:
        write(line)
    for p, tokens in zip(graph.paths, path_tokens):
        write(f"O\t{p.name}\t{' '.join(tokens)}\n")


def write_graph(graph: Graph, out_file: str) -> None:
    stream = OutputStream(out_file)
    if stream.ext.startswith("gfa2"):
        write_gfa2(graph, stream.write)
    else:
        write_gfa1(graph, stream.write)
    stream.close()


def write_decorated_gfa(graph: Graph, src_path: str, out_file: str) -> None:
    """Input-preserving evalGFA decoration: echo the source GFA verbatim,
    appending the RC:i tag eval_gfa computed to each edge record (L/E line)
    in file order; every other line passes through untouched.

    This is the likeliest match for gfalibs' (non-vendored) writer as used
    by the reference decorate path (src/input-gfalign.cpp:96): the output
    differs from the input only in the appended read-support tags.  The
    canonical writer above remains the path for subgraph output, where a
    new graph is synthesized rather than an input re-emitted.
    """
    from .stream import iter_lines

    stream = OutputStream(out_file)
    edge_i = 0
    for line in iter_lines(src_path):
        if line[:2] in ("L\t", "E\t") and edge_i < len(graph.links):
            # eval_gfa appended its RC tag last; any RC already present in
            # the input line stays where it was
            tags = graph.links[edge_i].tags
            edge_i += 1
            rc = next((t for t in reversed(tags) if t[0] == "RC"), None)
            if rc is not None:
                line = f"{line}\t{rc[0]}:{rc[1]}:{rc[2]}"
        stream.write(line + "\n")
    stream.close()
