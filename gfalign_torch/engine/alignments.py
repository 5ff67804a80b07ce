"""GAF record model and alignment-set operations.

Functional equivalent of the reference's alignment layer
(src/alignments.cpp / include/alignments.h), re-designed struct-of-arrays:
the 9 numeric GAF columns live in numpy arrays so stats are vectorized
reductions and path tokenization happens once into padded int tensors for
device kernels.

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
    (`_dup_stats_oracle` below) is fuzz-tested in
    tests/test_torch_oracles.py."""
    n = len(qnames)
    empty = (0, 0, 0, 0)
    if n == 0:
        return (empty + ([],)) if collect_pairs else empty
    if hasattr(qnames, "as_bytes_array"):
        names = qnames.as_bytes_array()  # lazy column: no str churn
    else:
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


def _dup_stats_oracle(qnames: Sequence[str], cols: np.ndarray,
                      collect_pairs: bool = False):
    """Scalar reference transcription of markDuplicates+countSupplementary
    (src/alignments.cpp:304-351) over bare metadata: the fuzz oracle for
    the vectorized _dup_stats_walk."""
    primary = secondary = supplementary = terminal = 0
    pairs: List[Tuple[int, int]] = []
    scratch: List[int] = []
    prev: Optional[str] = None
    n = len(qnames)
    for i in range(n):
        scratch.append(i)
        name = qnames[i]
        if name == prev:
            secondary += 1
            if i + 1 == n or qnames[i + 1] != name:
                group = sorted(scratch, key=lambda j: cols[j, 0])
                pos = 0
                count = 0
                for j in group:
                    if pos != 0 and cols[j, 0] > pos:
                        supplementary += 1
                        count += 1
                    pos = cols[j, 1]
                if len(group) == 2 and count == 1:
                    if (cols[group[0], 4] >= ((cols[group[0], 2] - 500) % _U32)
                            and cols[group[1], 3] <= 500):
                        terminal += 1
                        pairs.append((group[0], group[1]))
                scratch = []
        else:
            primary += 1
            prev = name
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
    """The InAlignments equivalent, columnar-first.

    The native loader keeps records as parallel columns (numeric array +
    name/path/tag string lists + tokenized paths); GafRecord objects are
    materialized lazily only for code paths that need them.  All mutations
    (sort, filter, shard) are expressed as index orders applied to every
    live representation, so they stay consistent."""

    def __init__(self) -> None:
        self._records: Optional[List[GafRecord]] = None
        self._numeric: Optional[np.ndarray] = None   # (N, 10) int64
        self._qnames: Optional[List[str]] = None
        self._paths: Optional[List[str]] = None
        self._tails: Optional[List[str]] = None
        self._orig: Optional[np.ndarray] = None      # original file indices
        self.tokens = None  # io.native.GafTokens columnar path tokens
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
        if self._records is not None:
            return len(self._records)
        return len(self._qnames) if self._qnames is not None else 0

    @property
    def records(self) -> List[GafRecord]:
        if self._records is None:
            self._records = [self._make_record(i) for i in range(self.count)]
        return self._records

    @records.setter
    def records(self, value: List[GafRecord]) -> None:
        self._records = value
        self._numeric = self._qnames = self._paths = self._tails = None

    def _make_record(self, i: int) -> GafRecord:
        row = self._numeric[i]
        return GafRecord(self._qnames[i], int(row[0]), int(row[1]), int(row[2]),
                         "-" if row[3] else "+", self._paths[i], int(row[4]),
                         int(row[5]), int(row[6]), int(row[7]), int(row[8]),
                         int(row[9]), self._tails[i], i)

    def qname_at(self, i: int) -> str:
        if self._records is not None:
            return self._records[i].qname
        return self._qnames[i]

    def numeric_at(self, i: int, col: int) -> int:
        """col in the native order: 0 qlen 1 qstart 2 qend 3 strand 4 plen
        5 pstart 6 pend 7 matches 8 blocklen 9 mapq."""
        if self._records is not None:
            r = self._records[i]
            return (r.qlen, r.qstart, r.qend, 0 if r.strand == "+" else 1,
                    r.plen, r.pstart, r.pend, r.matches, r.blocklen, r.mapq)[col]
        return int(self._numeric[i, col])

    def line_at(self, i: int) -> str:
        if self._records is not None:
            return self._records[i].to_line()
        row = self._numeric[i]
        parts = [self._qnames[i], str(int(row[0])), str(int(row[1])),
                 str(int(row[2])), "-" if row[3] else "+", self._paths[i],
                 str(int(row[4])), str(int(row[5])), str(int(row[6])),
                 str(int(row[7])), str(int(row[8])), str(int(row[9]))]
        for lab, typ, content in _parse_tagtail(self._tails[i]):
            parts.append(f"{lab}:{typ}:{content}")
        return "\t".join(parts) + "\n"

    def _apply_order(self, order) -> None:
        """Permute/subset every live representation by an index array."""
        order = np.asarray(order, dtype=np.int64)
        if self._records is not None:
            self._records = [self._records[int(i)] for i in order]
        if self._numeric is not None:
            self._numeric = (self._numeric[order] if len(order)
                             else self._numeric[:0])

            def _take(col):
                if hasattr(col, "take"):
                    return col.take(order)
                return [col[int(i)] for i in order]

            self._qnames = _take(self._qnames)
            self._paths = _take(self._paths)
            self._tails = _take(self._tails)
        if self._orig is not None:
            self._orig = self._orig[order] if len(order) else self._orig[:0]
        if self.tokens is not None:
            self.tokens = self.tokens.subset(order)

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
        self.terminal_flag = terminal_flag
        if not self._load_native(path, shard, shard_by):
            from ..io.stream import iter_lines

            if self._records is None:
                self._records = []
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
                self._records.append(rec)
                self._accumulate(rec)
        lg.verbose(f"Loaded {self.count} alignments from {path}")

    def _load_native(self, path: str, shard: Optional[Tuple[int, int]] = None,
                     shard_by: str = "index") -> bool:
        """Fast path: multithreaded C++ columnar parse (io/native.py).  The
        line parser reads stdin, and is the oracle when
        `native.available()` is false."""
        import os

        from ..io import native

        if path == "-" or not os.path.isfile(path) or not native.available():
            return False
        # gz inputs stay on the native path: the C++ loader inflates them
        # in-memory (read_file/inflate_gz) before the threaded chunk parse
        from ..io import cache

        parsed = cache.load_gaf_cache(path)
        from_cache = parsed is not None
        if parsed is None:
            parsed = native.parse_gaf(path, want_tokens=True)
        if parsed is None:
            return False
        numeric, qnames, paths, tails, tokens = parsed
        if not from_cache:
            cache.store_gaf_cache(path, numeric, qnames, paths, tails, tokens)
        if shard:
            keep = np.asarray(
                [i for i in range(len(qnames))
                 if _shard_keep(shard, shard_by, i, qnames[i])], np.int64)
            numeric = numeric[keep]
            if hasattr(qnames, "take"):
                qnames, paths, tails = (qnames.take(keep), paths.take(keep),
                                        tails.take(keep))
            else:
                qnames = [qnames[int(i)] for i in keep]
                paths = [paths[int(i)] for i in keep]
                tails = [tails[int(i)] for i in keep]
            tokens = tokens.subset(keep)
            self._orig = keep
        else:
            self._orig = np.arange(len(qnames), dtype=np.int64)
        self.tokens = tokens
        self._numeric = numeric
        self._qnames = qnames
        self._paths = paths
        self._tails = tails
        if len(qnames):
            self.tot_qlen += int(numeric[:, 0].sum())
            self.tot_algseq += int((numeric[:, 2] - numeric[:, 1]).sum())
            self.tot_minus += int(numeric[:, 3].sum())
            self.tot_plus += len(qnames) - int(numeric[:, 3].sum())
            self.tot_plen += int(numeric[:, 4].sum())
            self.tot_matches += int(numeric[:, 7].sum())
            self.tot_blocklen += int(numeric[:, 8].sum())
            self.tot_mapq += int(numeric[:, 9].sum())
        return True

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
        if self._orig is not None:
            return self._orig
        if self._records is not None:
            return np.array([r.pos for r in self._records], dtype=np.int64)
        return np.arange(self.count, dtype=np.int64)

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
        if self._records is None and self._numeric is not None:
            cols_local[:, 1:] = self._numeric[:, [1, 2, 4, 5, 6]]
        else:
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
        # non-stable std::sort, SURVEY.md section 4 quirk 9).  Columnar
        # loads argsort the NUL-padded bytes matrix — byte order equals
        # str order for UTF-8, and NUL-padding sorts prefixes first, so
        # this matches Python's sorted(); ~10x the keyed Python sort at
        # 10M records.
        if hasattr(self._qnames, "as_bytes_array"):
            order = np.argsort(self._qnames.as_bytes_array(), kind="stable")
        else:
            order = sorted(range(self.count), key=self.qname_at)
        self._apply_order(order)

    def _walk_cols(self) -> Tuple[List[str], np.ndarray]:
        """(qnames, (N,5) [qStart qEnd pLen pStart pEnd]) for the dup walk."""
        if self._records is None and self._numeric is not None:
            return self._qnames, self._numeric[:, [1, 2, 4, 5, 6]]
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
        if self.tokens is not None and self.count:
            tok = self.tokens
            member = np.asarray([name in headers for name in tok.names], bool)
            lengths = np.diff(tok.offsets)
            ok_steps = member[tok.step_ids] if tok.step_ids.size else np.zeros(0, bool)
            contained = np.ones(self.count, dtype=bool)
            nonempty = lengths > 0
            if ok_steps.size:
                starts = tok.offsets[:-1][nonempty]
                contained[nonempty] = np.minimum.reduceat(ok_steps, starts) > 0
            keep = contained & (lengths >= min_nodes)
            self._apply_order(np.nonzero(keep)[0])
        else:
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
        if self.tokens is not None:
            tok = self.tokens
            translate = [name_to_id.get(name, 0) for name in tok.names]
            orient = "+-"
            out = []
            for i in range(self.count):
                s, e = int(tok.offsets[i]), int(tok.offsets[i + 1])
                out.append([(translate[tok.step_ids[j]],
                             orient[tok.step_orients[j]]) for j in range(s, e)])
            return out
        return [rec.path_ids(name_to_id) for rec in self.records]

    def paths_padded(self, name_to_id: Dict[str, int], pad_to: Optional[int] = None):
        """(ids, orients, lengths) padded int32/int8 arrays for device
        scoring; orientation encoded 0='+', 1='-'; id pad = -1."""
        if self.tokens is not None:
            return self._paths_padded_tokens(name_to_id, pad_to)
        ids_list = self.paths_as_ids(name_to_id)
        n = len(ids_list)
        max_len = max((len(p) for p in ids_list), default=1) or 1
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        ids = np.full((n, max_len), -1, dtype=np.int32)
        orients = np.zeros((n, max_len), dtype=np.int8)
        lengths = np.zeros((n,), dtype=np.int32)
        for i, p in enumerate(ids_list):
            lengths[i] = len(p)
            for j, (sid, orientation) in enumerate(p):
                ids[i, j] = sid
                orients[i, j] = 0 if orientation == "+" else 1
        return ids, orients, lengths


    def _paths_padded_tokens(self, name_to_id, pad_to=None):
        tok = self.tokens
        n = self.count
        lengths = np.diff(tok.offsets).astype(np.int32)
        max_len = max(int(lengths.max()) if n else 1, 1)
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        # dictionary id -> graph uid (unknown names -> 0, phmap-style)
        translate = np.asarray([name_to_id.get(name, 0) for name in tok.names],
                               dtype=np.int32)
        idx = tok.offsets[:-1, None] + np.arange(max_len, dtype=np.int32)[None, :]
        mask = np.arange(max_len, dtype=np.int32)[None, :] < lengths[:, None]
        safe = np.clip(idx, 0, max(tok.step_ids.size - 1, 0))
        if tok.step_ids.size:
            ids = np.where(mask, translate[tok.step_ids[safe]], -1).astype(np.int32)
            orients = np.where(mask, tok.step_orients[safe], 0).astype(np.int8)
        else:
            ids = np.full((n, max_len), -1, np.int32)
            orients = np.zeros((n, max_len), np.int8)
        return ids, orients, lengths


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
    tok = getattr(alignments, "tokens", None)
    if tok is not None and tok.step_ids.size:
        return _edge_weights_vectorized(tok, name_to_id)
    weights: Dict[Tuple, int] = {}
    for rec in alignments.records:
        steps = rec.path_ids(name_to_id)
        for (s1, o1), (s2, o2) in zip(steps, steps[1:]):
            key = _canonical(s1, o1, s2, o2)
            weights[key] = weights.get(key, 0) + 1
    return weights


def _edge_weights_vectorized(tok, name_to_id: Dict[str, int]) -> Dict[Tuple, int]:
    """Canonical-key pair counting as numpy group-by (same result as the
    per-record loop; used automatically when columnar tokens exist)."""
    translate = np.asarray([name_to_id.get(name, 0) for name in tok.names],
                           dtype=np.int64)
    ids = translate[tok.step_ids]
    ors = tok.step_orients.astype(np.int64)
    a, oa = ids[:-1], ors[:-1]
    b, ob = ids[1:], ors[1:]
    # drop pairs spanning record boundaries
    boundary = np.zeros(len(ids), dtype=bool)
    boundary[tok.offsets[1:-1]] = True  # first step of each later record
    valid = ~boundary[1:]
    a, oa, b, ob = a[valid], oa[valid], b[valid], ob[valid]
    if not len(a):
        return {}
    k1 = a * 2 + oa
    k2 = b * 2 + ob
    m1 = b * 2 + (1 - ob)
    m2 = a * 2 + (1 - oa)
    take_mirror = (m1 < k1) | ((m1 == k1) & (m2 < k2))
    c1 = np.where(take_mirror, m1, k1)
    c2 = np.where(take_mirror, m2, k2)
    packed = c1 << 32 | c2
    uniq, counts = np.unique(packed, return_counts=True)
    weights: Dict[Tuple, int] = {}
    orient = "+-"
    for key, cnt in zip(uniq.tolist(), counts.tolist()):
        u1 = key >> 32
        u2 = key & 0xFFFFFFFF
        weights[(u1 >> 1, orient[u1 & 1], u2 >> 1, orient[u2 & 1])] = int(cnt)
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
