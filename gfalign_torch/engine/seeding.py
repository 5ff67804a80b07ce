"""k-mer seeding for the align mode on large graphs.

The exhaustive oriented-path enumeration in graph_align is exact but
exponential in branchy regions; on graphs beyond a few dozen segments the
aligner switches to seed-and-extend:

  1. index every k-mer of every segment (both strands, host-side numpy
     rolling hash);
  2. a read's k-mer hits vote for (segment, orientation) anchors;
  3. candidate paths are enumerated only around anchors — extending left
     and right along the graph until the merged sequence covers the read
     length plus slack, with a branching cap;
  4. the usual batched device scoring runs on this per-read candidate set.

This mirrors the role of GraphAligner's minimizer seeding (the reference
outsources the whole problem, src/main.cpp:167-169); exactness of placement
comes from the DP, seeding only bounds the search space.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from ..graph.model import Graph
from ..io.fastq import encode_seq

K = 15
MAX_ANCHORS_PER_READ = 12
MAX_PATHS_PER_ANCHOR = 16
SLACK = 64


def _kmer_codes(codes: np.ndarray, k: int = K) -> np.ndarray:
    """Packed 2-bit k-mer integers at every position (positions containing
    N/pad return -1)."""
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.int64)
    valid = codes < 4
    packed = np.zeros(n - k + 1, dtype=np.int64)
    ok = np.ones(n - k + 1, dtype=bool)
    for off in range(k):
        packed = (packed << 2) | codes[off:off + n - k + 1].astype(np.int64)
        ok &= valid[off:off + n - k + 1]
    return np.where(ok, packed, -1)


class KmerIndex:
    """k-mer -> (segment uid, orientation, offset) postings over all
    segments, stored as sorted parallel numpy arrays (CSR by k-mer) so both
    construction and per-read anchor voting are vectorized."""

    def __init__(self, graph: Graph, k: int = K, sample_mod: int = 1):
        """sample_mod > 1 keeps ~1/mod of k-mers (deterministic 32-bit
        Fibonacci-hash threshold, identical in the native and numpy
        builds): at assembly scale the full posting set is large while a
        ~5 kb read still yields hundreds of sampled anchor
        votes."""
        from ..graph.stats import revcomp

        self.k = k
        self.sample_mod = max(1, int(sample_mod))
        self._sample_thresh = (0 if self.sample_mod <= 1
                               else (1 << 32) // self.sample_mod)
        # ONE _kmer_codes pass over the concatenation of every oriented
        # segment, with boundary-crossing k-mers masked off, in one vector
        # pass.  Posting order: per (sid, orient) block, ascending offset,
        # then a stable sort by k-mer.
        parts: List[np.ndarray] = []
        sid_l, or_l, len_l = [], [], []
        for sid in range(graph.n_segments):
            seq = graph.segment(sid).seq
            if not seq:
                continue
            for oc, s in ((0, seq), (1, revcomp(seq))):
                parts.append(encode_seq(s))
                sid_l.append(sid)
                or_l.append(oc)
                len_l.append(len(s))
        if parts:
            codes = np.concatenate(parts)
            lens = np.asarray(len_l, np.int64)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            from ..io import native

            built = (native.kmer_index_build(codes, starts, lens, k,
                                             self._sample_thresh)
                     if native.available() else None)
            if built is not None:
                # native rolling scan + stable radix sort, same posting
                # order as the numpy oracle below
                kms, blk, offs = built
                self.kmers = kms        # int32: k <= 15 fits 30 bits
                self.sids = np.asarray(sid_l, np.int32)[blk]
                self.orients = np.asarray(or_l, np.int8)[blk]
                self.offs = offs
            else:
                kms = _kmer_codes(codes, k)
                pos = np.arange(len(kms), dtype=np.int64)
                blk = np.searchsorted(starts, pos, "right") - 1
                ok = (kms >= 0) & (pos + k <= starts[blk] + lens[blk])
                if self._sample_thresh:
                    h = (kms.astype(np.uint64) * 2654435761) & 0xFFFFFFFF
                    ok &= h < self._sample_thresh
                kms = kms[ok]
                blk = blk[ok]
                offs = (pos[ok] - starts[blk]).astype(np.int32)
                order = np.argsort(kms, kind="stable")
                self.kmers = kms[order]                  # (T,) sorted
                self.sids = np.asarray(sid_l, np.int32)[blk][order]
                self.orients = np.asarray(or_l, np.int8)[blk][order]
                self.offs = offs[order]
        else:
            self.kmers = np.empty(0, np.int64)
            self.sids = np.empty(0, np.int32)
            self.orients = np.empty(0, np.int8)
            self.offs = np.empty(0, np.int32)
        # CSR over UNIQUE k-mers: one searchsorted on the (smaller) unique
        # array replaces the left+right pair on the full postings.
        # self.kmers is already sorted, so dedupe via adjacent-diff
        # (np.unique would sort again).
        if len(self.kmers):
            is_new = np.empty(len(self.kmers), bool)
            is_new[0] = True
            np.not_equal(self.kmers[1:], self.kmers[:-1], out=is_new[1:])
            starts = np.flatnonzero(is_new)
            self.uniq = self.kmers[starts]
        else:
            starts = np.empty(0, np.int64)
            self.uniq = self.kmers
        self.starts = np.concatenate(
            [starts, [len(self.kmers)]]).astype(np.int64)

    def _posting_ranges(self, q: np.ndarray):
        """(lo, cnt) posting ranges for query k-mer codes q (vectorized;
        absent k-mers get cnt 0)."""
        if not len(self.uniq):
            z = np.zeros(len(q), np.int64)
            return z, z
        j = np.searchsorted(self.uniq, np.asarray(q).astype(self.uniq.dtype))
        jj = np.minimum(j, len(self.uniq) - 1)
        hit = self.uniq[jj] == q
        lo = self.starts[jj]
        cnt = np.where(hit, self.starts[jj + 1] - lo, 0)
        return lo, cnt

    def anchors(self, read_codes: np.ndarray,
                max_anchors: int = MAX_ANCHORS_PER_READ) -> List[Tuple[int, str]]:
        """(segment, orientation) anchors for a read, by vote count."""
        return [key for key, *_ in self.anchors_with_diag(read_codes,
                                                          max_anchors)]

    def anchors_with_diag(self, read_codes: np.ndarray,
                          max_anchors: int = MAX_ANCHORS_PER_READ,
                          audit=None) -> List[Tuple[Tuple[int, str], int, int]]:
        """[(anchor, diag, votes)] by vote count; diag is the most-voted
        (segment offset - read position) — the expected alignment diagonal
        within the oriented segment, which the banded scorer centers on.
        votes (the anchor's total k-mer hit count) feeds the candidate
        chain-colinearity ranking (seeded.SeededAlign._chain).

        The cap extends through vote TIES at the boundary (an anchor as
        well-supported as a kept one is never silently dropped); anchors
        dropped past that are counted on `audit`.  Fully vectorized:
        binary-search the sorted posting arrays, expand hit ranges, and
        group-count with lexsort/reduceat."""
        kms = _kmer_codes(read_codes, self.k)
        valid = kms >= 0
        pos = np.nonzero(valid)[0]
        q = kms[valid]
        lo, cnt = self._posting_ranges(q)
        total = int(cnt.sum())
        if total == 0:
            return []
        grp = np.repeat(np.arange(len(q)), cnt)
        base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        idx = lo[grp] + (np.arange(total) - base[grp])
        akey = self.sids[idx].astype(np.int64) * 2 + self.orients[idx]
        diag = self.offs[idx].astype(np.int64) - pos[grp]
        # (anchor, diag) vote runs
        order = np.lexsort((diag, akey))
        akey_s, diag_s = akey[order], diag[order]
        new_pair = np.empty(total, bool)
        new_pair[0] = True
        new_pair[1:] = (akey_s[1:] != akey_s[:-1]) | (diag_s[1:] != diag_s[:-1])
        pair_start = np.nonzero(new_pair)[0]
        p_anchor = akey_s[pair_start]
        p_diag = diag_s[pair_start]
        p_cnt = np.diff(np.concatenate([pair_start, [total]]))
        # votes per anchor = sum of its pair runs
        new_anchor = np.empty(len(p_anchor), bool)
        new_anchor[0] = True
        new_anchor[1:] = p_anchor[1:] != p_anchor[:-1]
        a_start = np.nonzero(new_anchor)[0]
        a_key = p_anchor[a_start]
        a_votes = np.add.reduceat(p_cnt, a_start)
        # best diag per anchor: most votes, then smallest |diag|, then value
        ord2 = np.lexsort((p_diag, np.abs(p_diag), -p_cnt, p_anchor))
        pa2 = p_anchor[ord2]
        first2 = np.empty(len(pa2), bool)
        first2[0] = True
        first2[1:] = pa2[1:] != pa2[:-1]
        sel = ord2[first2]
        best_diag = dict(zip(p_anchor[sel].tolist(), p_diag[sel].tolist()))
        # rank anchors by (-votes, (sid, orientation)); '+'(0) < '-'(1)
        # matches the char order of the old tuple sort
        ord3 = np.lexsort((a_key, -a_votes))
        ranked_keys = a_key[ord3]
        ranked_votes = a_votes[ord3]
        cut = min(max_anchors, len(ranked_keys))
        while 0 < cut < len(ranked_keys) \
                and ranked_votes[cut] == ranked_votes[cut - 1]:
            cut += 1
        if audit is not None and cut < len(ranked_keys):
            audit.hit("anchors_per_read", len(ranked_keys) - cut)
        return [((int(kk) // 2, "+-"[int(kk) % 2]), int(best_diag[int(kk)]),
                 int(vv))
                for kk, vv in zip(ranked_keys[:cut], ranked_votes[:cut])]


def _native_votes(index: KmerIndex, reads_codes, max_anchors: int,
                  audits) -> Optional[List[List[Tuple[Tuple[int, str], int, int]]]]:
    """Native anchor voting, or None (the oracle's turn: `native.available()`
    false, or an index layout the library does not take); bit-exact with
    the numpy path."""
    from ..io import native

    if not native.available() or getattr(index.uniq, "dtype", None) != np.int32:
        return None
    got = native.anchor_votes(index.uniq, index.starts, index.sids,
                              index.orients, index.offs, reads_codes,
                              index.k, max_anchors)
    if got is None:
        return None
    sid, orient, diag, votes, roff, dropped = got
    out: List[List[Tuple[Tuple[int, str], int, int]]] = []
    for r in range(len(reads_codes)):
        a, b = int(roff[r]), int(roff[r + 1])
        out.append([((int(sid[i]), "+-"[orient[i]]), int(diag[i]),
                     int(votes[i])) for i in range(a, b)])
        if audits is not None and dropped[r]:
            audits[r].hit("anchors_per_read", int(dropped[r]))
    return out


def anchors_with_diag_batch(index: KmerIndex,
                            reads_codes: List[np.ndarray],
                            max_anchors: int = MAX_ANCHORS_PER_READ,
                            audits=None) -> List[List[Tuple[Tuple[int, str], int, int]]]:
    """anchors_with_diag for MANY reads in one vectorized pass: one
    searchsorted + lexsort over the concatenated hit stream with the read
    id as the major sort key.  Per-read results (anchor order, diagonal
    votes, tie-extension, audit tallies) are identical to calling
    anchors_with_diag per read, but the per-call
    numpy fixed costs are paid once per BATCH.  The native C++ voter
    (io/native.anchor_votes, threaded over reads) takes the batch when the
    library is loaded and the index has the native int32 layout; results
    are bit-exact either way (tests/test_torch_native.py)."""
    got = _native_votes(index, reads_codes, max_anchors, audits)
    if got is not None:
        return got
    qs, poss, rids = [], [], []
    for r, codes in enumerate(reads_codes):
        kms = _kmer_codes(codes, index.k)
        valid = kms >= 0
        pos = np.nonzero(valid)[0]
        if len(pos):
            qs.append(kms[valid])
            poss.append(pos)
            rids.append(np.full(len(pos), r, np.int32))
    out: List[List[Tuple[Tuple[int, str], int]]] = [[] for _ in reads_codes]
    if not qs:
        return out
    q = np.concatenate(qs)
    pos = np.concatenate(poss)
    rid = np.concatenate(rids)
    lo, cnt = index._posting_ranges(q)
    total = int(cnt.sum())
    if total == 0:
        return out
    grp = np.repeat(np.arange(len(q)), cnt)
    base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    idx = lo[grp] + (np.arange(total) - base[grp])
    akey = index.sids[idx].astype(np.int64) * 2 + index.orients[idx]
    diag = index.offs[idx].astype(np.int64) - pos[grp]
    hrid = rid[grp].astype(np.int64)
    # (read, anchor, diag) vote runs
    order = np.lexsort((diag, akey, hrid))
    rid_s, akey_s, diag_s = hrid[order], akey[order], diag[order]
    new_pair = np.empty(total, bool)
    new_pair[0] = True
    new_pair[1:] = ((rid_s[1:] != rid_s[:-1]) | (akey_s[1:] != akey_s[:-1])
                    | (diag_s[1:] != diag_s[:-1]))
    pair_start = np.nonzero(new_pair)[0]
    p_rid = rid_s[pair_start]
    p_anchor = akey_s[pair_start]
    p_diag = diag_s[pair_start]
    p_cnt = np.diff(np.concatenate([pair_start, [total]]))
    # votes per (read, anchor) = sum of its pair runs
    new_anchor = np.empty(len(p_anchor), bool)
    new_anchor[0] = True
    new_anchor[1:] = (p_rid[1:] != p_rid[:-1]) | (p_anchor[1:] != p_anchor[:-1])
    a_start = np.nonzero(new_anchor)[0]
    a_rid = p_rid[a_start]
    a_key = p_anchor[a_start]
    a_votes = np.add.reduceat(p_cnt, a_start)
    # best diag per (read, anchor): most votes, smallest |diag|, then value.
    # first2 picks one row per (read, anchor) group in (rid, anchor) sorted
    # order — the SAME group order as a_start, so best_diag aligns 1:1.
    ord2 = np.lexsort((p_diag, np.abs(p_diag), -p_cnt, p_anchor, p_rid))
    pr2, pa2 = p_rid[ord2], p_anchor[ord2]
    first2 = np.empty(len(pa2), bool)
    first2[0] = True
    first2[1:] = (pr2[1:] != pr2[:-1]) | (pa2[1:] != pa2[:-1])
    best_diag = p_diag[ord2[first2]]
    # rank anchors within each read by (-votes, (sid, orientation))
    ord3 = np.lexsort((a_key, -a_votes, a_rid))
    r3 = a_rid[ord3]
    seg_start = np.nonzero(np.concatenate([[True], r3[1:] != r3[:-1]]))[0]
    seg_end = np.concatenate([seg_start[1:], [len(r3)]])
    for s0, s1 in zip(seg_start, seg_end):
        r = int(r3[s0])
        g = ord3[s0:s1]                      # group indices, ranked
        votes = a_votes[g]
        n = s1 - s0
        cut = min(max_anchors, n)
        while 0 < cut < n and votes[cut] == votes[cut - 1]:
            cut += 1
        if audits is not None and cut < n:
            audits[r].hit("anchors_per_read", n - cut)
        keys = a_key[g[:cut]]
        diags = best_diag[g[:cut]]
        vts = votes[:cut]
        out[r] = [((int(kk) // 2, "+-"[int(kk) % 2]), int(dd), int(vv))
                  for kk, dd, vv in zip(keys, diags, vts)]
    return out


def paths_around_anchor(graph: Graph, anchor: Tuple[int, str],
                        target_len: int,
                        max_paths: int = MAX_PATHS_PER_ANCHOR,
                        audit=None) -> List[List[Tuple[int, str]]]:
    """Oriented simple paths through the anchor whose merged length covers
    target_len on both sides (branching-capped DFS in each direction).
    Work dropped by a binding cap is counted on `audit` (no silent
    truncation); callers can re-run with larger caps when a read fails to
    place and its audit shows truncation."""
    from ..graph.model import flip

    adj = graph.adjacency

    def extend(start: Tuple[int, str], budget: int) -> List[List[Tuple[int, str]]]:
        results: List[List[Tuple[int, str]]] = []

        def dfs(path: List[Tuple[int, str]], covered: int, visited: Set):
            if len(results) >= max_paths:
                if audit is not None:
                    audit.hit("paths_per_anchor_dfs")
                return
            sid, orientation = path[-1]
            extended = False
            if covered < budget:
                for e in adj[sid]:
                    if e.or0 != orientation:
                        continue
                    nxt = (e.nid, e.or1)
                    if nxt in visited:
                        continue
                    visited.add(nxt)
                    path.append(nxt)
                    dfs(path, covered + graph.segment(e.nid).length, visited)
                    path.pop()
                    visited.remove(nxt)
                    extended = True
            if not extended or covered >= budget:
                results.append(list(path))

        dfs([start], 0, {start})
        return results

    sid, orientation = anchor
    budget = target_len + SLACK
    rights = extend(anchor, budget)
    # left extensions = reverse-complement walks from the flipped anchor
    lefts_rc = extend((sid, flip(orientation)), budget)
    # combine left x right within the max_paths budget, visiting index pairs
    # in a balanced order (small max(l, r) first) so a short side never
    # starves the other: one left extension + 60 rights uses all 60 rights,
    # not a fixed per-side slice
    order = sorted(((li, ri) for li in range(min(len(lefts_rc), max_paths))
                    for ri in range(min(len(rights), max_paths))),
                   key=lambda p: (max(p), p[0] + p[1], p))
    lefts = [[(s, flip(o)) for s, o in reversed(lr)][:-1]  # drop anchor dup
             for lr in lefts_rc[:max_paths]]
    paths = []
    seen = set()
    truncated = max(len(lefts_rc), len(rights)) > max_paths
    for li, ri in order:
        combined = lefts[li] + rights[ri]
        key = tuple(combined)
        if key not in seen:
            seen.add(key)
            if len(paths) >= max_paths:
                truncated = True
                break
            paths.append(combined)
    if truncated and audit is not None:
        audit.hit("paths_per_anchor")
    return paths
