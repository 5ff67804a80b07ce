"""GAF record model and alignment-set operations.

Functional equivalent of the reference's alignment layer
(src/alignments.cpp / include/alignments.h).  This is the JAX package's
record-list path; its native columnar loader is not part of the port yet,
and the two produce identical output there (tests/test_native.py).

Byte-parity quirks intentionally reproduced (all observable in the goldens):
  * summary averages divide load-time totals by the *current* record count,
    so after `filter` the averages are inflated (validateFiles/test.7.tst:5-11;
    reference src/alignments.cpp:248-280 vs 459-472);
  * the duplicate-marking scratch vector only resets when a duplicate run
    ends, so singleton reads leak into the next group's supplementary
    counting (src/alignments.cpp:304-326) — random2's supplementary count of
    1 depends on this;
  * the terminal-supplementary window test `pEnd >= pLen - 500` is unsigned:
    for pLen < 500 it wraps and is always false (src/alignments.cpp:345);
  * unknown path node names map to uId 0, mirroring phmap operator[]
    default-insertion (src/alignments.cpp:86).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.model import flip
from ..utils.fmt import cout, label
from ..utils.log import lg

_U32 = 1 << 32
_PATH_TOKEN = re.compile(r"[><][^><]+")


def _shard_keep(shard: Tuple[int, int], shard_by: str, idx: int, qname: str) -> bool:
    if shard_by == "qname":
        import zlib

        return zlib.crc32(qname.encode()) % shard[1] == shard[0]
    return idx % shard[1] == shard[0]


def _dup_stats_walk(qnames: Sequence[str], cols: np.ndarray,
                    collect_pairs: bool = False):
    """The reference's markDuplicates + countSupplementary counters over
    bare metadata (no records), fully vectorized: qnames must be
    name-sorted; cols is (N, 5) int64 [qStart, qEnd, pLen, pStart, pEnd].
    Reproduces the scratch-leak (SURVEY.md §4 quirk 8: singletons since
    the last duplicate-run flush join that run's supplementary group) and
    the unsigned terminal window (src/alignments.cpp:345 semantics).
    Returns (primary, secondary, supplementary, terminal_supplementary)
    and, with collect_pairs, also the terminal pairs' walk indices in
    emission order.  Equality with the scalar reference walk
    (the JAX package's _dup_stats_oracle) is fuzz-tested there
    (tests/test_dist.py)."""
    n = len(qnames)
    empty = (0, 0, 0, 0)
    if n == 0:
        return (empty + ([],)) if collect_pairs else empty
    names = np.asarray(qnames, dtype=object)
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    np.not_equal(names[1:], names[:-1], out=new_run[1:])
    run_starts = np.flatnonzero(new_run)
    n_runs = len(run_starts)
    primary, secondary = n_runs, n - n_runs
    run_ends = np.append(run_starts[1:], n)          # exclusive
    # a flush happens at the LAST record of every duplicate (len>=2) run;
    # group g = all records after the previous flush up to flush g inclusive
    flush_at = run_ends[run_ends - run_starts >= 2] - 1
    n_groups = len(flush_at)
    if n_groups == 0:
        counters = (primary, secondary, 0, 0)
        return (counters + ([],)) if collect_pairs else counters
    idx = np.arange(n)
    grp = np.searchsorted(flush_at, idx)
    idx = idx[grp < n_groups]                        # trailing records: never flushed
    g = grp[idx]
    qstart, qend = cols[idx, 0], cols[idx, 1]
    order = np.lexsort((idx, qstart, g))             # stable qStart sort per group
    gi, qs, qe, oi = g[order], qstart[order], qend[order], idx[order]
    first = np.empty(len(order), dtype=bool)
    first[0] = True
    np.not_equal(gi[1:], gi[:-1], out=first[1:])
    prev_qe = np.empty_like(qe)
    prev_qe[0] = 0
    prev_qe[1:] = qe[:-1]
    supp = (~first) & (prev_qe != 0) & (qs > prev_qe)
    supplementary = int(supp.sum())
    sizes = np.bincount(gi, minlength=n_groups)
    counts = np.bincount(gi[supp], minlength=n_groups)
    cand = np.flatnonzero((sizes == 2) & (counts == 1))
    terminal = 0
    pairs: List[Tuple[int, int]] = []
    if cand.size:
        group_first = np.flatnonzero(first)
        s0 = group_first[cand]
        g0, g1 = oi[s0], oi[s0 + 1]
        # unsigned terminal window: pEnd0 >= (pLen0 - 500) mod 2^32
        win = (cols[g0, 2] - 500) % _U32
        ok = (cols[g0, 4] >= win) & (cols[g1, 3] <= 500)
        terminal = int(ok.sum())
        if collect_pairs:
            pairs = list(zip(g0[ok].tolist(), g1[ok].tolist()))
    counters = (primary, secondary, supplementary, terminal)
    return (counters + (pairs,)) if collect_pairs else counters


def _parse_tagtail(tail: str) -> List[Tuple[str, str, str]]:
    """Typed tags from the raw text after column 12.  Like the reference,
    only the third ':'-field survives as content (src/alignments.cpp:223-227)."""
    tags = []
    if not tail:
        return tags
    for col in tail.split("\t"):
        parts = col.split(":")
        if len(parts) >= 2 and parts[0] and parts[1]:
            tags.append((parts[0][:2], parts[1][0], parts[2] if len(parts) > 2 else ""))
    return tags


@dataclass
class GafRecord:
    qname: str
    qlen: int
    qstart: int
    qend: int
    strand: str
    path: str
    plen: int
    pstart: int
    pend: int
    matches: int
    blocklen: int
    mapq: int
    tagtail: str = ""      # raw tag text; parsed lazily
    pos: int = 0
    _tags: Optional[List[Tuple[str, str, str]]] = None

    @property
    def tags(self) -> List[Tuple[str, str, str]]:
        if self._tags is None:
            self._tags = _parse_tagtail(self.tagtail)
        return self._tags

    @classmethod
    def from_line(cls, line: str, pos: int = 0) -> "GafRecord":
        cols = line.split("\t")
        tail = "\t".join(cols[12:]) if len(cols) > 12 else ""
        return cls(cols[0], int(cols[1]), int(cols[2]), int(cols[3]), cols[4][0],
                   cols[5], int(cols[6]), int(cols[7]), int(cols[8]), int(cols[9]),
                   int(cols[10]), int(cols[11]), tail, pos)

    def to_line(self) -> str:
        parts = [self.qname, str(self.qlen), str(self.qstart), str(self.qend),
                 self.strand, self.path, str(self.plen), str(self.pstart),
                 str(self.pend), str(self.matches), str(self.blocklen), str(self.mapq)]
        for lab, typ, content in self.tags:
            parts.append(f"{lab}:{typ}:{content}")
        return "\t".join(parts) + "\n"

    # -- path-string walkers ---------------------------------------------

    def path_tokens(self) -> List[Tuple[str, str]]:
        """[('name', '+'|'-')] from a '>'/'<'-prefixed GAF path string."""
        return [(m[1:], "+" if m[0] == ">" else "-") for m in _PATH_TOKEN.findall(self.path)]

    def path_ids(self, name_to_id: Dict[str, int]) -> List[Tuple[int, str]]:
        return [(name_to_id.get(name, 0), orientation) for name, orientation in self.path_tokens()]

    def is_contained(self, headers: set) -> bool:
        return all(name in headers for name, _ in self.path_tokens())

    def path_nodes_count(self) -> int:
        return len(self.path_tokens())


class AlignmentSet:
    """The InAlignments equivalent: GafRecord objects parsed line by line.
    All mutations (sort, filter) are index orders applied to the record
    list."""

    def __init__(self) -> None:
        self.records: List[GafRecord] = []
        # load-time totals (never recomputed after filtering — quirk)
        self.tot_qlen = 0
        self.tot_algseq = 0
        self.tot_plus = 0
        self.tot_minus = 0
        self.tot_plen = 0
        self.tot_mapq = 0
        self.tot_matches = 0
        self.tot_blocklen = 0
        self.primary = 0
        self.secondary = 0
        self.supplementary = 0
        self.terminal_supplementary = 0
        self.terminal_flag = False

    # -- representations --------------------------------------------------

    @property
    def count(self) -> int:
        return len(self.records)

    def qname_at(self, i: int) -> str:
        return self.records[i].qname

    def numeric_at(self, i: int, col: int) -> int:
        """col in the native order: 0 qlen 1 qstart 2 qend 3 strand 4 plen
        5 pstart 6 pend 7 matches 8 blocklen 9 mapq."""
        r = self.records[i]
        return (r.qlen, r.qstart, r.qend, 0 if r.strand == "+" else 1,
                r.plen, r.pstart, r.pend, r.matches, r.blocklen, r.mapq)[col]

    def line_at(self, i: int) -> str:
        return self.records[i].to_line()

    def _apply_order(self, order) -> None:
        """Permute/subset the records by an index sequence."""
        self.records = [self.records[int(i)] for i in order]

    # -- load ------------------------------------------------------------

    def load(self, path: str, terminal_flag: bool = False,
             shard: Optional[Tuple[int, int]] = None,
             shard_by: str = "index") -> None:
        """Load a GAF file.  `shard=(process_index, process_count)` keeps
        only this host's records — the multi-host input contract
        (parallel/dist.py); totals then cover the local shard and are
        merged with merge_distributed().  shard_by: "index" (round-robin,
        best load balance) or "qname" (stable-hash grouping, keeps duplicate
        groups host-local so markDuplicates stays correct)."""
        from ..io.stream import iter_lines

        self.terminal_flag = terminal_flag
        pos = 0
        for line in iter_lines(path):
            if not line:
                continue
            idx = pos
            pos += 1
            if shard and not _shard_keep(shard, shard_by, idx,
                                         line.split("\t", 1)[0]):
                continue
            rec = GafRecord.from_line(line, idx)
            self.records.append(rec)
            self._accumulate(rec)
        lg.verbose(f"Loaded {self.count} alignments from {path}")

    def _accumulate(self, rec: GafRecord) -> None:
        self.tot_qlen += rec.qlen
        self.tot_algseq += rec.qend - rec.qstart
        if rec.strand == "+":
            self.tot_plus += 1
        else:
            self.tot_minus += 1
        self.tot_plen += rec.plen
        self.tot_matches += rec.matches
        self.tot_blocklen += rec.blocklen
        self.tot_mapq += rec.mapq

    # -- distributed -----------------------------------------------------

    def merge_distributed(self, dup_counts: bool = True) -> None:
        """Multi-host stat merge: replace the load-time totals (computed on
        this host's shard) with their psum across all hosts.  Totals are
        exact for any sharding.  dup_counts=True additionally psums the
        duplicate-marking counters of per-host mark_duplicates runs — exact
        under qname sharding EXCEPT for the reference's cross-group
        scratch-leak quirk; pass dup_counts=False after the exact
        mark_duplicates_distributed (which already set global values)."""
        from ..parallel.dist import allreduce_stats

        merged = allreduce_stats([
            self.count, self.tot_qlen, self.tot_algseq, self.tot_plus,
            self.tot_minus, self.tot_plen, self.tot_mapq, self.tot_matches,
            self.tot_blocklen])
        (self._count_override, self.tot_qlen, self.tot_algseq, self.tot_plus,
         self.tot_minus, self.tot_plen, self.tot_mapq, self.tot_matches,
         self.tot_blocklen) = merged
        if dup_counts:
            (self.primary, self.secondary, self.supplementary,
             self.terminal_supplementary) = allreduce_stats([
                 self.primary, self.secondary, self.supplementary,
                 self.terminal_supplementary])

    def _orig_indices(self) -> np.ndarray:
        return np.array([r.pos for r in self.records], dtype=np.int64)

    def mark_duplicates_distributed(self, out=None) -> None:
        """EXACT multi-host duplicate/supplementary marking.  Per-host
        marking misses the reference's cross-group scratch leak (SURVEY.md
        §4 quirk 8): singletons ADJACENT IN THE GLOBAL NAME ORDER leak into
        the next duplicate group's supplementary count, and those
        singletons may live on other hosts.  Every host therefore gathers
        each record's metadata — qname, original file index, and the five
        numeric columns the walk reads — rebuilds the exact single-host
        name-sorted order (stable by file index), and runs the reference
        walk on the global sequence; all hosts set identical counters.
        Metadata is O(total records) per host (same order as the load
        itself).  Terminal-supplementary record PRINTING (-t): the walk
        collects pair indices from the gathered metadata, then one more
        allgather ships just those records' printed lines from their
        owning hosts — every process writes the identical pair lines to
        `out` in emission order (pass out=None to skip)."""
        from ..parallel.dist import allgather_bytes

        cols_local = np.zeros((self.count, 6), dtype=np.int64)
        for k, col in enumerate((1, 2, 4, 5, 6)):  # qStart qEnd pLen pStart pEnd
            cols_local[:, k + 1] = [self.numeric_at(i, col)
                                    for i in range(self.count)]
        cols_local[:, 0] = self._orig_indices()
        # length-prefixed framing (count + qname-blob byte length): immune to
        # empty qnames, which would desynchronize a newline-join/split
        import struct

        qbytes = "".join(self.qname_at(i) + "\n"
                         for i in range(self.count)).encode()
        payload = (struct.pack("<qq", self.count, len(qbytes))
                   + qbytes + cols_local.tobytes())
        qnames: List[str] = []
        cols_parts = []
        part_sizes: List[int] = []
        for part in allgather_bytes(payload):
            n_rec, qlen = struct.unpack_from("<qq", part)
            qnames.extend(part[16:16 + qlen].decode().split("\n")[:n_rec])
            cols_parts.append(
                np.frombuffer(part[16 + qlen:], np.int64).reshape(-1, 6))
            part_sizes.append(len(cols_parts[-1]))
        cols = np.concatenate(cols_parts) if cols_parts else np.zeros((0, 6), np.int64)
        assert len(qnames) == len(cols)
        order = sorted(range(len(qnames)),
                       key=lambda i: (qnames[i], int(cols[i, 0])))
        (self.primary, self.secondary, self.supplementary,
         self.terminal_supplementary, pairs) = _dup_stats_walk(
             [qnames[i] for i in order], cols[order][:, 1:],
             collect_pairs=True)
        if self.terminal_flag and out is not None and pairs:
            self._print_terminal_pairs_distributed(pairs, order, part_sizes,
                                                   out)

    def _print_terminal_pairs_distributed(self, pairs, order, part_sizes,
                                          out) -> None:
        """Ship just the terminal-pair record lines from their owning hosts
        (one allgather of '<gathered-row>\\x00<line>' frames), then write
        them in walk-emission order — identical on every process."""
        import struct

        from ..parallel.dist import allgather_bytes, process_info

        rank, _ = process_info()
        offsets = np.concatenate([[0], np.cumsum(part_sizes)])
        my_lo, my_hi = int(offsets[rank]), int(offsets[rank + 1])
        wanted = [order[w] for pair in pairs for w in pair]
        frames = []
        for g in wanted:
            if my_lo <= g < my_hi:
                frames.append(f"{g}\x00{self.line_at(g - my_lo)}")
        blob = "\x01".join(frames).encode()
        lines: dict = {}
        for part in allgather_bytes(struct.pack("<q", len(blob)) + blob):
            (blen,) = struct.unpack_from("<q", part)
            text = part[8:8 + blen].decode()
            for frame in text.split("\x01") if text else []:
                g, _, line = frame.partition("\x00")
                lines[int(g)] = line
        for g in wanted:
            out.write(lines[g])

    # -- stats -----------------------------------------------------------

    def _avg(self, total: int) -> float:
        n = getattr(self, "_count_override", None) or self.count
        return total / n if n else float("nan")

    def print_stats(self, out, tabular: bool = False) -> None:
        n = getattr(self, "_count_override", None) or self.count
        fr = cout.fmt_rounded
        if not tabular:
            out.write(label("+++Alignment summary+++") + "\n")
        out.write(label("# alignments") + str(n) + "\n")
        out.write(label("Average read length") + fr(self._avg(self.tot_qlen)) + "\n")
        out.write(label("Average aligned sequence") + fr(self._avg(self.tot_algseq)) + "\n")
        denom = self.tot_plus + self.tot_minus
        plus_pct = self.tot_plus / denom * 100 if denom else float("nan")
        minus_pct = self.tot_minus / denom * 100 if denom else float("nan")
        out.write(label("Alignment orientation (+/-)")
                  + f"{self.tot_plus}({fr(plus_pct)}%):{self.tot_minus}({fr(minus_pct)}%)\n")
        out.write(label("Average path length") + fr(self._avg(self.tot_plen)) + "\n")
        out.write(label("Average alignment quality") + fr(self._avg(self.tot_mapq)) + "\n")
        out.write(label("Average matches #") + fr(self._avg(self.tot_matches)) + "\n")
        out.write(label("Average block length") + fr(self._avg(self.tot_blocklen)) + "\n")
        out.write(label("Primary alignments") + str(self.primary) + "\n")
        out.write(label("Secondary alignments") + str(self.secondary) + "\n")
        out.write(label("Supplementary alignments") + str(self.supplementary) + "\n")
        out.write(label("Terminal supplementary alignments") + str(self.terminal_supplementary) + "\n")

    # -- sorting / duplicate marking -------------------------------------

    def sort_by_name(self) -> None:
        # stable by qName (deterministic superset of the reference's
        # non-stable std::sort, SURVEY.md section 4 quirk 9)
        self._apply_order(sorted(range(self.count), key=self.qname_at))

    def _walk_cols(self) -> Tuple[List[str], np.ndarray]:
        """(qnames, (N,5) [qStart qEnd pLen pStart pEnd]) for the dup walk."""
        qnames = [self.qname_at(i) for i in range(self.count)]
        cols = np.array([[self.numeric_at(i, c) for c in (1, 2, 4, 5, 6)]
                         for i in range(self.count)], dtype=np.int64)
        return qnames, cols.reshape(-1, 5)

    def mark_duplicates(self, out=None) -> None:
        qnames, cols = self._walk_cols()
        primary, secondary, supplementary, terminal, pairs = _dup_stats_walk(
            qnames, cols, collect_pairs=True)
        self.primary += primary
        self.secondary += secondary
        self.supplementary += supplementary
        self.terminal_supplementary += terminal
        if self.terminal_flag and out is not None:
            for g0, g1 in pairs:
                out.write(self.line_at(g0) + self.line_at(g1))

    # -- filtering -------------------------------------------------------

    def filter_by_nodelist(self, nodelist: Sequence[str], min_nodes: int) -> None:
        headers = set(nodelist)
        self.records = [r for r in self.records
                        if r.is_contained(headers) and r.path_nodes_count() >= min_nodes]

    # -- output ----------------------------------------------------------

    def output(self, file: str, stdout) -> None:
        from ..io.stream import OutputStream

        stream = OutputStream(file)
        if stream.out_file:  # writing records to a file => stats to stdout
            self.print_stats(stdout)
        for i in range(self.count):
            stream.write(self.line_at(i))
        stream.close()

    # -- tensorization ---------------------------------------------------

    def paths_as_ids(self, name_to_id: Dict[str, int]) -> List[List[Tuple[int, str]]]:
        return [rec.path_ids(name_to_id) for rec in self.records]


# -- alignment-derived edge graph (evalGFA support counting) ---------------


def _canonical(s1: int, o1: str, s2: int, o2: str) -> Tuple:
    a = (s1, o1, s2, o2)
    b = (s2, flip(o2), s1, flip(o1))
    return min(a, b)


def build_edge_weights(alignments: AlignmentSet, name_to_id: Dict[str, int]) -> Dict[Tuple, int]:
    """Count read support for each bidirected edge implied by GAF paths.

    Equivalent to the reference's per-record linear-scan adjacency build
    (src/alignments.cpp:353-403) but as one canonical-key counting pass.
    The palindromic self-loop case (an edge equal to its own mirror) is
    resolved at lookup time (see edge_weight)."""
    weights: Dict[Tuple, int] = {}
    for rec in alignments.records:
        steps = rec.path_ids(name_to_id)
        for (s1, o1), (s2, o2) in zip(steps, steps[1:]):
            key = _canonical(s1, o1, s2, o2)
            weights[key] = weights.get(key, 0) + 1
    return weights


def edge_weight(weights: Dict[Tuple, int], s1: int, o1: str, s2: int, o2: str) -> int:
    """Support weight for a directed edge query; 0 when unsupported.

    A palindromic edge (its mirror is itself: s1==s2 and o2==flip(o1)) gets
    2c-1: the reference increments both the forward entry and its mirror,
    which are the same list element in that case (src/alignments.cpp:384-394)."""
    key = _canonical(s1, o1, s2, o2)
    c = weights.get(key, 0)
    if c == 0:
        return 0
    if s1 == s2 and o2 == flip(o1):
        return 2 * c - 1
    return c
