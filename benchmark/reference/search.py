"""Plain reference of gfalign's tangle search (`gfalign search`), on the
standard library and numpy alone.

It follows the upstream tool's semantics (gfalign src/eval.cpp `dijkstra`
and `evaluatePath`, src/alignments.cpp's path alignment), written out
here without anything of the program under test:

  * the graph's bidirected adjacency: each link (s1 o1 -> s2 o2), in file
    order, gives s1 the entry (o1, s2, o2) and s2 its mirror
    (flip o2, s1, flip o1);
  * the node table: every node-file row (name, count >= 1; the first row
    of a name wins, every row adds its count to the node total), then the
    source and the destination with count 1;
  * best-first search from (source, undetermined orientation): a popped
    path extends along each adjacency entry of its last node whose source
    orientation agrees, into a node of the table whose visits stay within
    its count; each extension is scored against the read paths, gets the
    priority bad - good - (distinct nodes), lower first, ties first in,
    and is either queued or, at the destination, reported;
  * scoring: a read path counts only when every one of its nodes lies on
    the candidate (the membership filter); it is aligned forward and
    reverse-complemented with the path alignment below, and its better
    score is bad below 0 and good otherwise;
  * a destination path is printed when it has more distinct nodes than the
    best so far, or as many with a lower priority (and at least
    `min_nodes`), or always with `return_all`.

`search_rows` returns the lines the tool prints.  `both_strands=False`
aligns each read path forward only, leaving out the reverse complement:
the control the benchmark holds its comparison to.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

Step = Tuple[int, str]

MATCH, MISMATCH, GAP = 0, -1, -1


def _flip(o: str) -> str:
    return "-" if o == "+" else "+"


def path_score(a: Sequence[Step], b: Sequence[Step]) -> int:
    """Score of read path `b` against candidate `a` as the upstream path
    alignment reports it: a matrix over the candidate's rows whose row 0
    holds j * GAP over the candidate's extent (0 beyond), column 0 is 0,
    and in the read's last column a vertical move is free; the score is
    then summed along the traceback (diagonal first, then vertical when it
    is no worse than horizontal), where a vertical move costs 1 only once
    some read step has been emitted, a horizontal move always costs 1, and
    moves along row 0 or column 0 are free."""
    n, m = len(a), len(b)
    width = max(n, m) + 1
    dp = [[0] * width for _ in range(n + 1)]
    for j in range(n + 1):
        dp[0][j] = j * GAP
    for i in range(1, n + 1):
        ai, prev, row = a[i - 1], dp[i - 1], dp[i]
        for j in range(1, m + 1):
            s = MATCH if ai == b[j - 1] else MISMATCH
            v = prev[j - 1] + s
            up = prev[j] + (GAP if j < m else 0)
            if up > v:
                v = up
            left = row[j - 1] + GAP
            row[j] = v if v >= left else left
    score, emitted = 0, 0
    i, j = n, m
    while i or j:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            s = MATCH if a[i - 1] == b[j - 1] else MISMATCH
            if dp[i][j] == dp[i - 1][j - 1] + s:
                score += s
                emitted += 1
                i -= 1
                j -= 1
            elif dp[i - 1][j] >= dp[i][j - 1]:
                if emitted:
                    score -= 1
                i -= 1
            else:
                emitted += 1
                score -= 1
                j -= 1
    return score


def revcomp_path(p: Sequence[Step]) -> Tuple[Step, ...]:
    return tuple((i, "-" if o == "+" else "+") for i, o in reversed(p))


class _Scorer:
    """(bad, good) of a candidate against the read paths, each distinct
    read path aligned once a candidate."""

    def __init__(self, read_paths: Sequence[Sequence[Step]],
                 table_ids: set, both_strands: bool):
        mult: Dict[Tuple[Step, ...], int] = {}
        for p in read_paths:
            key = tuple(p)
            mult[key] = mult.get(key, 0) + 1
        self.both = both_strands
        self.empty = mult.pop((), 0)      # empty paths: kept, score 0, good
        # a read with a node outside the node table lies on no candidate,
        # so only the others are ever looked at
        self.paths = [(p, revcomp_path(p), frozenset(i for i, _ in p), k)
                      for p, k in mult.items()
                      if all(i in table_ids for i, _ in p)]

    def __call__(self, cand: Sequence[Step]) -> Tuple[int, int]:
        ids = {i for i, _ in cand}
        bad, good = 0, self.empty
        for fw, rc, nodes, k in self.paths:
            if not nodes <= ids:
                continue
            best = path_score(cand, fw)
            if self.both and best < 0:
                best = path_score(cand, rc)
            if best < 0:
                bad += k
            else:
                good += k
        return bad, good


def search_rows(names: Sequence[str],
                links: Sequence[Tuple[str, str, str, str]],
                node_rows: Sequence[str],
                source: str, destination: str,
                read_paths: Sequence[Sequence[Tuple[str, str]]],
                max_steps: int = 100000, min_nodes: int = 0,
                return_all: bool = False,
                both_strands: bool = True) -> List[str]:
    """The lines `gfalign search` prints.  `names` are the segments in GFA
    order (their ids), `links` the L lines in file order, `node_rows` the
    node file's rows, `read_paths` each record's path as (name,
    orientation) steps."""
    uid = {nm: k for k, nm in enumerate(names)}
    adj: List[List[Tuple[str, int, str]]] = [[] for _ in names]
    for n1, o1, n2, o2 in links:
        adj[uid[n1]].append((o1, uid[n2], o2))
        adj[uid[n2]].append((_flip(o2), uid[n1], _flip(o1)))

    records: Dict[str, Tuple[int, int]] = {}
    node_total = 0
    for row in node_rows:
        cols = row.split("\t")
        count = int(cols[1]) if len(cols) > 1 else 1
        if count < 1:
            continue
        node_total += count
        records.setdefault(cols[0], (uid[cols[0]], count))
    for nm in (source, destination):
        node_total += 1
        records.setdefault(nm, (uid.get(nm, 0), 1))
    budget = {u: c for u, c in records.values()}
    dest = records[destination][0]

    score = _Scorer([[(uid[n], o) for n, o in p] for p in read_paths],
                    set(budget), both_strands)
    cache: Dict[Tuple[Step, ...], Tuple[int, int]] = {}

    heap = [(0, 0, ((records[source][0], "0"),), ())]
    seq = 1
    best_alt, best_uniques, found, steps = 2 ** 31 - 1, 0, 0, 0
    out: List[str] = []
    while heap and steps < max_steps:
        _, _, path, visits = heapq.heappop(heap)
        last_id, last_or = path[-1]
        seen = dict(visits)
        for or0, nid, or1 in adj[last_id]:
            if last_or != "0" and last_or != or0:
                continue
            if nid not in budget or budget[nid] - seen.get(nid, 0) <= 0:
                continue
            head = path if last_or != "0" else path[:-1] + ((last_id, or0),)
            cand = head + ((nid, or1),)
            got = cache.get(cand)
            if got is None:
                got = cache[cand] = score(cand)
            bad, good = got
            uniques = len({i for i, _ in cand})
            alt = bad - good - uniques
            if nid != dest:
                nv = dict(seen)
                nv[nid] = nv.get(nid, 0) + 1
                heapq.heappush(heap, (alt, seq, cand, tuple(nv.items())))
                seq += 1
                continue
            found += 1
            counts: Dict[int, int] = {}
            for i, _ in cand:
                counts[i] = counts.get(i, 0) + 1
            hamiltonian = (len(cand) + 2 == node_total
                           and all(counts.get(u) == c for u, c in records.values()))
            better = uniques >= min_nodes and (
                best_uniques < uniques
                or (best_uniques == uniques and best_alt > alt))
            if better:
                best_alt, best_uniques = alt, uniques
            if return_all or better:
                walk = ",".join(names[i] + o for i, o in cand)
                out.append(f"{found}\t{bad}\t{good}\t{alt}\t{len(cand)}\t"
                           f"{uniques}\t{'T' if hamiltonian else 'F'}\t{walk}")
        steps += 1
    if steps >= max_steps:
        out.append(f"Reached maximum number of steps ({steps})")
    return out
