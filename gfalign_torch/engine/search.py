"""Tangle path search: best-first source->destination enumeration.

The reference's `dijkstra` (src/eval.cpp:110-193) pops the best partial path
from a Fibonacci heap and, for each admissible adjacent edge, re-scores ALL
read paths against the extended candidate (quadratic NW per read).  Our
redesign keeps the host-side heap (output order must match the sequential
reference) but scores every expansion of a popped path as ONE batched device
call (`evaluate_candidates`), which is where all the FLOPs are.

Heap tie-breaking: equal priorities pop in insertion order (FIFO).  This
matches the observable ordering of validateFiles/test.6.tst and makes
multi-batch runs deterministic (SURVEY.md section 4 quirk 9).

Priority: alt = bad - good - #unique-node-names; lower is better.
A path may visit a node at most `count` times (NodeTable budget, decremented
per visit).  Reaching the destination reports the path; an improving path
(more uniques, or equal uniques with lower alt, and >= minNodes uniques) is
printed unless --return-all-paths prints every discovered path.
"""

from __future__ import annotations

import heapq
import operator
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..graph.model import Graph
from ..ops.nw_path import Step
from ..utils.log import lg
from ..utils.profiling import count, span
from . import evaluate
from .alignments import AlignmentSet
from .evaluate import evaluate_candidates


class NodeTable:
    """Node-name -> (uId, allowed visit count) multiset
    (reference include/nodetable.h:4-68).

    nodeCount sums counts over every add() attempt — including duplicate
    inserts, which keep the FIRST record but still bump nodeCount.  The
    Hamiltonian test requires path-step count + 2 == nodeCount, so it can
    only pass when source and destination also appear in the node file
    (SURVEY.md section 4 quirk 3)."""

    def __init__(self) -> None:
        self.records: Dict[str, Tuple[int, int]] = {}  # name -> (uid, count)
        self.node_count = 0

    @classmethod
    def from_file(cls, node_file: str, name_to_id: Dict[str, int]) -> "NodeTable":
        table = cls()
        with open(node_file) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                cols = line.split("\t")
                count = 1
                if len(cols) > 1:
                    count = int(cols[1])
                    if count < 1:
                        continue
                table.node_count += count
                uid = name_to_id.get(cols[0])
                if uid is None:
                    print(f"Error: node not in graph (pIUd: {cols[0]})", file=sys.stderr)
                    raise SystemExit(1)
                if cols[0] not in table.records:
                    table.records[cols[0]] = (uid, count)
        return table

    def add(self, name: str, uid: int, count: int) -> None:
        if count < 1:
            return
        if name not in self.records:
            self.records[name] = (uid, count)
        self.node_count += count

    def check_hamiltonian(self, path_nodes: Dict[int, int], path_len: int) -> bool:
        if path_len + 2 != self.node_count:
            return False
        for _, (uid, count) in self.records.items():
            if path_nodes.get(uid) != count:
                return False
        return True


@dataclass
class PartialPath:
    steps: List[Step]
    # times each node name was ENTERED past the seed step; remaining budget
    # for a name = NodeTable count - visits.get(name, 0).  Keyed only by
    # visited names, so the per-expansion copy is O(path length), not
    # O(node-table size) like a full remaining-count dict would be.
    visits: Dict[str, int]
    # interned trie id: every distinct step sequence gets one small int
    # (assigned in deterministic discovery order), so all cache keys are
    # O(1) int hashes instead of O(path) tuple-of-Step hashes — those
    # dominated the commit loop once scoring went native
    pid: int = -1


def _ring_agreed() -> bool:
    """Whether the C++ driver can run this process's distributed search:
    one process, or every process maps the /dev/shm tally ring (an answer
    all processes share)."""
    from ..parallel import dist

    if dist.process_info()[1] == 1:
        return True
    return bool(dist._shm_ring())


def _native_search(graph: Graph, table: NodeTable, source: str,
                   destination: str, read_batch, max_steps: int,
                   min_nodes: int, return_all_paths: bool, out,
                   spec_depth: int, speculate: int, dist_mode=None) -> bool:
    """Run the C++ search driver (native/gfalign_host.cpp search_native);
    True when it handled the search (output written).  The driver is the
    same algorithm as the Python loop in `search` -- the same heap order,
    speculation and caches, so byte-equal output
    (tests/test_torch_native.py) -- with the frontier scoring of
    nw_evaluate_frontier on the host, minus the Python bookkeeping per
    step.

    dist_mode "frontier" (reads replicated) shards the speculative
    frontier round-robin over the processes, "read" (reads sharded) sums
    every candidate's tallies over them; both exchange through the
    /dev/shm tally ring (parallel/dist._ShmRing), which the caller has
    checked every process maps."""
    import numpy as np

    from ..io import native

    n = graph.n_segments
    if n == 0:
        return False
    source_uid = table.records[source][0]
    dest_uid = table.records[destination][0]
    if not (0 <= source_uid < n and 0 <= dest_uid < n):
        return False
    pid, nproc, ring = 0, 1, None
    if dist_mode is not None:
        from ..parallel import dist

        pid, nproc = dist.process_info()
        if nproc > 1:
            ring = dist._shm_ring()
            # fresh batch numbering for this search: each process zeroes
            # its own ring cells, then one barrier makes that visible
            ring.reset_local()
            dist.barrier()
            native.set_wait_timeout(dist.wait_seconds())
    adj = graph.adjacency
    counts = np.fromiter((len(a) for a in adj), np.int32, count=n)
    adj_off = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=adj_off[1:])
    E = int(adj_off[-1])
    adj_nid = np.empty(E, np.int32)
    adj_or0 = np.empty(E, np.int8)
    adj_or1 = np.empty(E, np.int8)
    oc = {"+": 0, "-": 1}
    k = 0
    for a in adj:
        for e in a:
            adj_nid[k] = e.nid
            adj_or0[k] = oc[e.or0]
            adj_or1[k] = oc[e.or1]
            k += 1
    seg_names = [graph.segment(i).name for i in range(n)]
    budget = np.full(n, -1, np.int32)
    for i, nm in enumerate(seg_names):
        rec = table.records.get(nm)
        if rec is not None:
            budget[i] = rec[1]
    n_rec = len(table.records)
    rec_uids = np.fromiter((uid for uid, _ in table.records.values()),
                           np.int32, count=n_rec)
    rec_counts = np.fromiter((c for _, c in table.records.values()),
                             np.int32, count=n_rec)
    enc = [s.encode() for s in seg_names]
    name_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, enc), np.int64, count=n),
              out=name_off[1:])
    lg.verbose("Starting search")
    got = native.native_search(
        adj_off, adj_nid, adj_or0, adj_or1, n, budget, rec_uids, rec_counts,
        table.node_count, source_uid, dest_uid,
        read_batch.b_keys, read_batch.lengths, max_steps, min_nodes,
        return_all_paths, spec_depth, speculate, b"".join(enc), name_off,
        pid=pid, nproc=nproc, ring_buf=ring.address if ring else None,
        ring_width=ring.WIDTH if ring else 0,
        ring_slots=ring.SLOTS if ring else 0,
        ring_sum_mode=dist_mode == "read")
    if got is None:
        return False
    out.write(got.decode())
    lg.verbose("Search completed")
    return True


def search(graph: Graph,
           alignments: Optional[AlignmentSet],
           node_file: str,
           source: str,
           destination: str,
           max_steps: int = 100000,
           min_nodes: int = 0,
           return_all_paths: bool = False,
           out=None,
           evaluate_fn=None,
           spec_depth: int = 2,
           speculate: Optional[int] = None,
           device="cuda",
           use_native: Optional[bool] = None) -> None:
    """Print the search TSV to `out`.  Frontiers score on `device` through
    `evaluate_fn` (default `evaluate_candidates`).  `use_native` picks the
    C++ driver (`_native_search`), which scores on the host: None takes it
    where `native_scoring_ok(device)` holds (the CPU), True takes it on any
    device, False keeps the Python driver; so on CUDA every frontier goes
    through K1 unless the caller asks for the host.  A caller's own `evaluate_fn` keeps the
    Python driver, except the distributed evaluators of engine/evaluate
    (`distributed_evaluator`, `frontier_sharded_evaluator`), which the C++
    driver runs over the /dev/shm tally ring when every process maps it.

    Speculation width depends only on values every process of a
    distributed run holds alike (the read count summed over a read-sharded
    run), so all processes make the same frontier calls and so the same
    collectives."""
    out = out or sys.stdout
    with span("search.load"):
        adj = graph.adjacency
        name_to_id = graph.name_to_id
        read_paths: List[List[Step]] = []
        if alignments is not None:
            read_paths = [[Step(i, o) for i, o in p]
                          for p in alignments.paths_as_ids(name_to_id)]
        from .evaluate import ReadBatch
        read_batch = ReadBatch(read_paths, device)
        dist_mode = None
        if getattr(evaluate_fn, "read_sharded", False):
            dist_mode = "read"
        elif getattr(evaluate_fn, "frontier_sharded", False):
            dist_mode = "frontier"
        n_reads = read_batch.R
        if dist_mode == "read":
            from ..parallel.dist import allreduce_stats
            n_reads = allreduce_stats([read_batch.R])[0]
        if speculate is None:
            # wider speculation cuts dispatch/sync count; its cost (scoring
            # candidates that never pop) scales with the read batch, so go
            # wide only when reads are few.  The global count: processes
            # whose shards straddle 512 must still speculate alike.
            speculate = 256 if n_reads <= 512 else 64

        table = NodeTable.from_file(node_file, name_to_id)
        # unknown source/destination names default-insert uId 0, matching phmap
        # operator[] (reference src/eval.cpp:127-128)
        table.add(source, name_to_id.get(source, 0), 1)
        table.add(destination, name_to_id.get(destination, 0), 1)
        dest_uid = table.records[destination][0]

    if use_native is not False and (evaluate_fn is None or dist_mode):
        asked = use_native
        if use_native is None:
            use_native = evaluate.native_scoring_ok(read_batch.device)
        if use_native and dist_mode and not _ring_agreed():
            if asked:
                raise RuntimeError("the C++ search driver runs distributed only "
                                   "over /dev/shm, which not every process maps")
            use_native = False
        if use_native and _native_search(
                graph, table, source, destination, read_batch, max_steps,
                min_nodes, return_all_paths, out, spec_depth, speculate,
                dist_mode):
            return
    evaluate_fn = evaluate_fn or evaluate_candidates

    heap: List[Tuple[int, int, PartialPath]] = []
    seq = 0
    first = PartialPath([Step(table.records[source][0], "0")], {}, pid=0)
    heapq.heappush(heap, (0, seq, first))
    seq += 1

    # path interning: (parent pid, orientation fix, step) -> child pid.
    # A step sequence uniquely determines its prefix chain, so identical
    # sequences always intern to the same id; ids are assigned in
    # deterministic discovery order (identical across processes).
    intern: Dict[Tuple[int, str, Step], int] = {}
    next_pid = [1]

    # expansions are a pure function of the step sequence (visits counts
    # derive from the steps), so memoize by interned path id: the
    # speculation machinery re-enumerates the same paths it later pops,
    # and this enumeration was over half the non-scoring loop time
    exp_cache: Dict[int, list] = {}

    seg_name = [graph.segment(i).name for i in range(graph.n_segments)]

    def admissible_expansions(u: PartialPath):
        got = exp_cache.get(u.pid)
        if got is not None:
            return got
        exps = []
        last = u.steps[-1]
        records_get = table.records.get
        for v in adj[last.id]:
            if last.orientation != "0" and last.orientation != v.or0:
                continue
            name = seg_name[v.nid]
            rec = records_get(name)
            if rec is None or rec[1] - u.visits.get(name, 0) <= 0:
                continue
            new_steps = list(u.steps)
            fix = ""
            if new_steps[-1].orientation == "0":
                new_steps[-1] = Step(new_steps[-1].id, v.or0)
                fix = v.or0
            step = Step(v.nid, v.or1)
            new_steps.append(step)
            ikey = (u.pid, fix, step)
            cpid = intern.get(ikey)
            if cpid is None:
                cpid = next_pid[0]
                next_pid[0] += 1
                intern[ikey] = cpid
            # segment names and ids are bijective, and only the COUNT of
            # unique names is ever consumed (alt, min_nodes, printing), so
            # dedupe on ids — no name lookups, no sort
            n_uniques = len({s.id for s in new_steps})
            exps.append((v, name, new_steps, n_uniques, cpid))
        exp_cache[u.pid] = exps
        return exps

    # Speculative scoring: candidate scores are deterministic and
    # independent of heap state, so while scoring a popped path's
    # expansions we also score the expansions of the next few heap tops in
    # the same device batch.  Output order is untouched — later pops just
    # hit the cache instead of the device.
    score_cache: Dict[int, "object"] = {}  # interned pid -> PathScore
    # NOTE: must not depend on the LOCAL read shard (empty on some hosts in
    # distributed runs) or processes would issue different collective
    # sequences; with no reads the extra speculation is harmless
    # `speculate` heap tops are speculated per dispatch; spec_depth =
    # generations of descent speculation per dispatch (see below)

    best_alt = 2 ** 31 - 1
    best_uniques = 0
    path_counter = 0
    steps = 0
    lg.verbose("Starting search")
    # work counters, added to the registry when the loop ends: frontier
    # calls and candidates scored (speculation included)
    frontier_calls = n_scored = 0
    # search.driver: the loop's own host work; search.frontier: each call
    # of evaluate_fn as the loop makes it (a distributed evaluator's
    # exchange included)
    with span("search.driver") as driver:
        while heap and steps < max_steps:
            _, _, u = heapq.heappop(heap)
            expansions = admissible_expansions(u)
            if not expansions:
                steps += 1
                continue
            to_score = []
            seen_keys = set()
            for _, _, new_steps, _, cpid in expansions:
                if cpid not in score_cache and cpid not in seen_keys:
                    seen_keys.add(cpid)
                    to_score.append((cpid, new_steps))
            if speculate and to_score:
                # descent speculation: when dispatching anyway, also score the
                # next `spec_depth` GENERATIONS below this pop in the same
                # batch — in a best-first descent the just-pushed children (not
                # yet on the heap, invisible to the heap-top speculation) are
                # usually the next pops.  Gated on to_score: running this on
                # cache-hit pops would issue a tiny dispatch per pop and defeat
                # the batching entirely.
                frontier = [(u.visits, e) for e in expansions]
                for _depth in range(spec_depth):
                    nxt = []
                    for visits, (v, name, new_steps, _, cpid) in frontier:
                        if v.nid == dest_uid:
                            continue
                        child_visits = dict(visits)
                        child_visits[name] = child_visits.get(name, 0) + 1
                        child = PartialPath(new_steps, child_visits, pid=cpid)
                        for g in admissible_expansions(child):
                            gpid = g[4]
                            if gpid not in score_cache and gpid not in seen_keys:
                                seen_keys.add(gpid)
                                to_score.append((gpid, g[2]))
                            nxt.append((child_visits, g))
                    frontier = nxt
                    if len(to_score) > 4096:
                        break
            if speculate and to_score:
                # speculation pool: sort a short PREFIX of the heap array instead
                # of heapq.nsmallest over the whole heap (O(len(heap)) per pop,
                # hostile at the reference's 100k-step cap).  The array prefix of
                # a binary heap is biased toward the smallest elements, and a
                # wrong guess only costs an unused cache entry — output order
                # never depends on speculation.  Deterministic across processes:
                # identical heap arrays everywhere.
                pool = sorted(heap[:4 * speculate],
                              key=operator.itemgetter(0, 1))
                for _, _, spec in pool[:speculate]:
                    for _, _, new_steps, _, cpid in admissible_expansions(spec):
                        if cpid not in score_cache and cpid not in seen_keys:
                            seen_keys.add(cpid)
                            to_score.append((cpid, new_steps))
            if to_score:
                with driver.paused(), span("search.frontier"):
                    results = evaluate_fn([s for _, s in to_score], read_batch,
                                          filter_alignments=True)
                frontier_calls += 1
                n_scored += len(to_score)
                if len(score_cache) > 200000:
                    # evict the oldest half (dict preserves insertion order):
                    # a wholesale clear() caused periodic full re-scoring
                    # storms at the reference's default 100k-step cap.
                    # Deterministic across processes — every process inserts
                    # the same keys in the same order.
                    from itertools import islice
                    for k in list(islice(score_cache, len(score_cache) // 2)):
                        del score_cache[k]
                if len(exp_cache) > 200000:
                    from itertools import islice
                    for k in list(islice(exp_cache, len(exp_cache) // 2)):
                        del exp_cache[k]
                for (key, _), sc in zip(to_score, results):
                    score_cache[key] = sc
            scores = [score_cache[e[4]] for e in expansions]
            for (v, name, new_steps, n_uniques, cpid), sc in zip(expansions,
                                                                 scores):
                alt = sc.bad - sc.good - n_uniques
                if v.nid != dest_uid:
                    new_visits = dict(u.visits)
                    new_visits[name] = new_visits.get(name, 0) + 1
                    heapq.heappush(heap, (alt, seq,
                                          PartialPath(new_steps, new_visits,
                                                      pid=cpid)))
                    seq += 1
                else:
                    path_counter += 1
                    path_nodes: Dict[int, int] = {}
                    for s in new_steps:
                        path_nodes[s.id] = path_nodes.get(s.id, 0) + 1
                    hamiltonian = table.check_hamiltonian(path_nodes, len(new_steps))
                    print_path = False
                    if n_uniques >= min_nodes and (
                            best_uniques < n_uniques
                            or (best_uniques == n_uniques and best_alt > alt)):
                        best_alt = alt
                        best_uniques = n_uniques
                        print_path = True
                    if return_all_paths or print_path:
                        path_str = ",".join(graph.segment(s.id).name + s.orientation
                                            for s in new_steps)
                        out.write(f"{path_counter}\t{sc.bad}\t{sc.good}\t{alt}\t"
                                  f"{len(new_steps)}\t{n_uniques}\t"
                                  f"{'T' if hamiltonian else 'F'}\t{path_str}\n")
            steps += 1
    count("search.frontier_calls", frontier_calls)
    count("search.candidates_scored", n_scored)
    if steps >= max_steps:
        out.write(f"Reached maximum number of steps ({steps})\n")
    lg.verbose("Search completed")
