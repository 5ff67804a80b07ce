"""evalPath: score one user-given path string against all read alignments
(reference src/eval.cpp:196-242)."""

from __future__ import annotations

import re
import sys
from typing import List

from ..graph.model import Graph
from ..ops.nw_path import Step
from .alignments import AlignmentSet
from .evaluate import evaluate_path_printing


def eval_path(graph: Graph, alignments: AlignmentSet, path_str: str, out=None,
              device="cuda") -> None:
    out = out or sys.stdout
    components = re.split(r"[;,]", path_str)
    if components and components[0] == "":
        print("Error: cannot handle starting gap. Terminating.", file=sys.stderr)
        raise SystemExit(1)
    steps: List[Step] = []
    for comp in components:
        if comp == "":
            continue
        orientation = comp[-1]
        name = comp[:-1]
        uid = graph.name_to_id.get(name)
        if uid is None:
            print(f"Error: cannot find node ({name}). Terminating.", file=sys.stderr)
            raise SystemExit(1)
        steps.append(Step(uid, orientation))
    uniques = sorted({graph.segment(s.id).name for s in steps})
    read_paths = [[Step(i, o) for i, o in p]
                  for p in alignments.paths_as_ids(graph.name_to_id)]
    read_names = [r.qname for r in alignments.records]

    # print the candidate path, then per-read alignments (reference
    # src/eval.cpp:72-73 prints via evaluatePath's printAlignments flag)
    out.write(",".join(graph.segment(s.id).name + s.orientation for s in steps) + "\n")
    result = evaluate_path_printing(steps, read_paths, read_names,
                                    lambda sid: graph.segment(sid).name, out,
                                    device)
    alt = result.bad - result.good - len(uniques)
    out.write(f"{result.bad}\t{result.good}\t{alt}\t{len(steps)}\t{len(uniques)}\n")
