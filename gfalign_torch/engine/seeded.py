"""The seeded align engine (graphs above graph_align.SEED_THRESHOLD
segments): k-mer seeds nominate candidate paths per read, and SeededAlign
scores (read, candidate-path) PAIRS, not the read x path cross product.
Its stages are methods: seeding (`build_index`, `seed`, `candidates`),
path codes, scoring (`score`, its two ladders and their one rung test
`_sort_rung`) and placement (`place`, `rounds`, `walk_waves`)."""

from __future__ import annotations

import functools
import os
from collections import defaultdict
from operator import itemgetter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph.model import Graph
from ..graph.stats import revcomp
from ..io import native
from ..io.fastq import encode_seq
from ..ops import seqalign
from ..ops.nw_path import pad_pow2
from ..utils.log import lg
from ..utils.profiling import count, span
from .paths import (CapAudit, GafHit, OrientedPath, _longest_uncovered,
                    _reject_ending_inside, _SegCodes, accept,
                    build_oriented_struct, finish, overlap_table)
from . import seeding

SEED_CHUNK = 32       # reads per seeded scoring batch
SCORE_CHUNK = 4096    # max pairs per device dispatch (bounds host + device memory)
CHAIN_TOL = 128       # diagonal corridor half-width for colinear anchors
CHAIN_TOP_K = 8       # banded-DP budget per read in the first scoring wave
# (ties at the boundary extend to at most 2x; reads that fail to place —
# or keep a scoreable uncovered region — open their full candidate list)

_CO_PAD = (1 << 31) - 1   # cum_off padding: past-the-end sentinel


class DevicePools:
    """Device-resident scoring state for banded dispatches: torch tensors
    on one explicit device, updated in place.

    Path BYTES never leave the host per dispatch:

      * reads upload once into a (r_cap, lr_cap) int8 pool;
      * the ORIENTED SEGMENT ARENA (fw + rc codes of every segment, ~2x
        graph size) uploads once;
      * a path is registered as per-step int32 tables (cum_off = path
        offset where each step's contribution starts; base_ptr = arena
        index - cum_off, overlap drop folded in) and its banded strip is
        assembled on the device per dispatch (ops/seqalign);
      * each dispatch ships only int32 row indices + deltas (KBs).

    Table capacities grow by pow2 doubling (rare: the first sync sees the
    whole candidate set); earlier rows keep their place."""

    def __init__(self, work: List[np.ndarray], graph: Graph, device):
        self.device = torch.device(device)
        self.lr_cap = pad_pow2(max((len(w) for w in work), default=16),
                               floor=16)
        r_cap = pad_pow2(len(work), floor=8)
        buf = np.full((r_cap, self.lr_cap), seqalign.PAD, np.int8)
        for r, w in enumerate(work):
            buf[r, :len(w)] = w
        self.reads = torch.from_numpy(buf).to(self.device)

        self.arena_start: Dict[Tuple[int, str], int] = {}
        parts: List[np.ndarray] = []
        pos = 0
        for sid in range(graph.n_segments):
            seq = graph.segment(sid).seq
            for orient, s in (("+", seq), ("-", revcomp(seq) if seq else "")):
                self.arena_start[(sid, orient)] = pos
                if s:
                    parts.append(encode_seq(s).astype(np.int8))
                    pos += len(s)
        arena = np.concatenate(parts) if parts else np.zeros(8, np.int8)
        self.arena = torch.from_numpy(arena).to(self.device)
        self._init_tables()

    def _init_tables(self) -> None:
        self.p_cap = 0
        self.s_cap = 8                      # max steps/path, pow2 growth
        self.cum_off = None                 # (p_cap, s_cap) int32
        self.base_ptr = None                # (p_cap, s_cap) int32
        self.plen = None                    # (p_cap,) int32
        self.path_row: Dict[tuple, int] = {}
        self.irregular: set = set()         # keys the arena mapping can't
        # represent (non-monotone offsets from overlap > segment); scored
        # by the host-array fallback instead
        self._pending: List[Tuple[int, np.ndarray, np.ndarray, int]] = []

    @classmethod
    def from_numpy(cls, arena, cum_off, base_ptr, plen, reads,
                   device) -> "DevicePools":
        """Pools holding the given tables: arena (A,) int8, cum_off and
        base_ptr (p_cap, s_cap) int32, plen (p_cap,) int32, reads
        (r_cap, lr_cap) int8, as numpy arrays (for example the JAX
        package's pools, so that both packages score the same state).
        Rows already in the tables have no key here: address them by their
        row index; `arena_start` is empty, so no further path can be
        registered."""
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.reads = _put(reads, np.int8, self.device)
        self.lr_cap = self.reads.shape[1]
        self.arena = _put(arena, np.int8, self.device)
        self.arena_start = {}
        self._init_tables()
        self.cum_off = _put(cum_off, np.int32, self.device)
        self.base_ptr = _put(base_ptr, np.int32, self.device)
        self.plen = _put(plen, np.int32, self.device)
        self.p_cap, self.s_cap = self.cum_off.shape
        return self

    def update_reads(self, rows: List[int], work: List[np.ndarray]) -> None:
        """Re-upload masked read rows (placement masks accepted query
        regions between rounds); `rows` is small after round 1."""
        if not rows:
            return
        batch = np.full((len(rows), self.lr_cap), seqalign.PAD, np.int8)
        for i, r in enumerate(rows):
            batch[i, :len(work[r])] = work[r]
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        self.reads.index_copy_(0, idx, torch.from_numpy(batch).to(self.device))

    def path_idx(self, key: tuple, op: OrientedPath) -> Optional[int]:
        """Register/look up a path; returns its table row, or None when
        the path is irregular (caller falls back to host-array scoring)."""
        if key in self.irregular:
            return None
        row = self.path_row.get(key)
        if row is not None:
            return row
        n_steps = len(op.steps)
        co = np.empty(n_steps, np.int64)
        bp = np.empty(n_steps, np.int64)
        pos = 0
        for k, (sid, orient) in enumerate(op.steps):
            drop = pos - op.offsets[k]
            co[k] = pos
            bp[k] = self.arena_start[(sid, orient)] + drop - pos
            pos += op.seg_lens[k] - drop
        if pos != len(op) or np.any(np.diff(co) < 0) or n_steps == 0:
            self.irregular.add(key)
            return None
        row = len(self.path_row)
        self.path_row[key] = row
        self._pending.append((row, co.astype(np.int32),
                              bp.astype(np.int32), pos))
        return row

    def sync_paths(self) -> None:
        """Upload pending path tables; grow capacities by pow2 doubling."""
        if not self._pending:
            return
        need_rows = len(self.path_row)
        need_s = max(self.s_cap,
                     pad_pow2(max(len(co) for _, co, _, _ in self._pending),
                              floor=8))
        if (self.cum_off is None or need_rows > self.p_cap
                or need_s > self.s_cap):
            p_cap = pad_pow2(need_rows, floor=8)
            old = (self.cum_off, self.base_ptr, self.plen)
            i32 = torch.int32
            self.cum_off = torch.full((p_cap, need_s), _CO_PAD, dtype=i32,
                                      device=self.device)
            self.base_ptr = torch.zeros((p_cap, need_s), dtype=i32,
                                        device=self.device)
            self.plen = torch.zeros((p_cap,), dtype=i32, device=self.device)
            if old[0] is not None:
                rows, cols = old[0].shape
                self.cum_off[:rows, :cols] = old[0]
                self.base_ptr[:rows, :cols] = old[1]
                self.plen[:rows] = old[2]
            self.p_cap, self.s_cap = p_cap, need_s
        first = self._pending[0][0]
        n = len(self._pending)
        co_b = np.full((n, self.s_cap), _CO_PAD, np.int32)
        bp_b = np.zeros((n, self.s_cap), np.int32)
        pl_b = np.zeros((n,), np.int32)
        for i, (row, co, bp, plen) in enumerate(self._pending):
            assert row == first + i  # rows are assigned sequentially
            co_b[i, :len(co)] = co
            bp_b[i, :len(bp)] = bp
            pl_b[i] = plen
        self.cum_off[first:first + n] = torch.from_numpy(co_b).to(self.device)
        self.base_ptr[first:first + n] = torch.from_numpy(bp_b).to(self.device)
        self.plen[first:first + n] = torch.from_numpy(pl_b).to(self.device)
        self._pending = []


def _put(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(device)


class SeededAlign:
    """One seeded align call; `engine` picks the scoring ladder
    (graph_align.align_engine): "host" the native host ladder, "device"
    DevicePools and K3 on `device`."""

    def __init__(self, graph: Graph, reads, params, device, engine: str):
        self.graph, self.reads, self.params = graph, reads, params
        self.device, self.min_score = device, params.min_score
        self.host_engine = engine == "host"
        self.lut = overlap_table(graph)
        self.seg_codes = _SegCodes(graph)
        self.path_cache: Dict[tuple, OrientedPath] = {}
        self.code_cache: Dict[tuple, np.ndarray] = {}
        self.cand_deltas: Dict[Tuple[int, tuple], int] = {}  # -> diagonal
        self.cand_chain: Dict[Tuple[int, tuple], int] = {}   # -> colinear
        # anchor-vote support (the candidate ranking key for top-k scoring)
        self.read_audits = [CapAudit() for _ in reads]
        self.cand_lists: List[List[tuple]] = [[] for _ in reads]
        self.all_hits: List[List[GafHit]] = [[] for _ in reads]
        self.accepted: List[List[Tuple[int, int]]] = [[] for _ in reads]
        self.index = self.pools = None
        self.dirty_reads: set = set()   # rows masked since the last pool sync
        # sound cross-round pruning: masking accepted regions only DEGRADES
        # cell scores (match -> blocked), so a (read, candidate) pair that
        # scored below min_score once can never recover — drop it from
        # later rounds (the placement loop breaks below min_score, and
        # s2/mapq competitors also require >= min_score, so behavior is
        # identical).
        self.dead_pairs: set = set()
        # path codes accumulate into one blob keyed by candidate; the host
        # ladder passes absolute offsets into it.  Its capacity is sized
        # once from the whole candidate set at first use (path_cache holds
        # every generated candidate by then), so it is not regrown round by
        # round
        self.path_blob, self.path_used = None, 0
        self.path_off: Dict[tuple, int] = {}

    def run(self):
        """[(read name, read length, its hits best first)]."""
        self.build_index()
        self.seed(range(len(self.reads)), retry=False)
        self.load_work()
        active = [r for r in range(len(self.reads)) if self.cand_lists[r]]
        if self.host_engine:
            if not native.available():     # raises itself when it cannot build
                raise RuntimeError("the host align engine needs the native library")
        else:
            with span("align.scoring.pools"):
                self.pools = DevicePools(self.work, self.graph, self.device)
        self.rounds(active)
        # adaptive caps: a read left unplaced (or with a scoreable uncovered
        # stretch) while its candidate generation hit a cap gets one retry
        # with the caps raised 4x — a correct placement must never be lost
        # to a default bound
        retry = [r for r in range(len(self.reads))
                 if self.read_audits[r]
                 and (not self.all_hits[r]
                      or _longest_uncovered(len(self.reads[r][1]),
                                            self.accepted[r]) >= self.min_score)]
        if retry:
            self.seed(retry, retry=True)
            self.rounds([r for r in retry if self.cand_lists[r]])
        audit = CapAudit()
        for ra in self.read_audits:
            audit.merge(ra)
        audit.report("align(seeded)")
        return finish(self.reads, self.all_hits)

    # -- seeding ----------------------------------------------------------

    def build_index(self) -> None:
        # auto-subsample the seed index at assembly scale: postings ~= 2x
        # total bases; cap around ~24M so the index build stays bounded
        # (GFALIGN_TORCH_SEED_SAMPLE overrides; 1 = keep every k-mer)
        graph = self.graph
        total_bases = 2 * sum(
            (seg.length or len(seg.seq))
            for seg in (graph.segment(s) for s in range(graph.n_segments)))
        env_mod = os.environ.get("GFALIGN_TORCH_SEED_SAMPLE")
        auto_sampled = False
        if env_mod is not None:
            sample_mod = max(1, int(env_mod))
        elif self.params.seed_sample:
            sample_mod = max(1, self.params.seed_sample)
        else:
            sample_mod = max(1, -(-total_bases // 24_000_000))
            auto_sampled = sample_mod > 1
        count("align.reads", len(self.reads))
        with span("align.seeding"), span("align.seeding.index"):
            self.index = seeding.KmerIndex(graph, k=self.params.seed_k,
                                           sample_mod=sample_mod)
        if sample_mod > 1:
            msg = (f"seed index subsampled 1/{sample_mod} "
                   f"({len(self.index.kmers)} postings)")
            if auto_sampled:
                # auto-engaged sampling changes anchor sets by default —
                # always announce it (accuracy-sensitive runs disable with
                # --seed-sample 1 or GFALIGN_TORCH_SEED_SAMPLE=1)
                lg.warn(msg + "; --seed-sample 1 keeps every k-mer")
            else:
                lg.verbose(msg)

    def seed(self, rs, retry: bool) -> None:
        """Anchors and candidates of the reads rs; a retry raises the caps
        4x and tallies its reads on their audits."""
        caps = 4 if retry else 1
        with span("align.seeding"):
            with span("align.seeding.anchors"):
                anchor_lists = seeding.anchors_with_diag_batch(
                    self.index, [encode_seq(self.reads[r][1]) for r in rs],
                    caps * self.params.max_anchors,
                    audits=None if retry else self.read_audits)
            with span("align.seeding.candidates"):
                for i, r in enumerate(rs):
                    if retry:
                        self.read_audits[r].hit("reads_retried_with_raised_caps")
                    self.cand_lists[r] = self.candidates(
                        r, self.reads[r][1], anchor_lists[i],
                        caps * self.params.max_paths_per_anchor,
                        CapAudit() if retry else self.read_audits[r])
        count("align.candidates", sum(len(self.cand_lists[r]) for r in rs))

    def candidates(self, r: int, seq: str, anchors: List[tuple],
                   max_paths: int, audit: CapAudit) -> List[tuple]:
        """Read r's candidate path keys, in chain rank."""
        cands: List[tuple] = []
        seen = set()
        for anchor, seg_diag, _votes in anchors:
            # corridor dedup: a long read's own segments all rank as
            # anchors, and each would re-enumerate the same corridor of
            # paths; an anchor already inside a kept candidate adds no new
            # corridor (the DP extends across the whole path anyway)
            if any(anchor in key for key in cands):
                continue
            for steps in seeding.paths_around_anchor(
                    self.graph, anchor, len(seq), max_paths, audit=audit):
                key = tuple(steps)
                if key in seen:
                    continue
                seen.add(key)
                if key not in self.path_cache:
                    self.path_cache[key] = build_oriented_struct(
                        self.graph, steps, self.lut)
                # expected alignment diagonal: anchor segment's offset in
                # this path + the anchor's in-segment diagonal vote — the
                # banded scorer centers its band here
                anchor_idx = key.index(anchor)
                self.cand_deltas[(r, key)] = (
                    self.path_cache[key].offsets[anchor_idx] + seg_diag)
                cands.append(key)
        # Candidates are sorted by chain support (stable: generation order
        # breaks ties) so the placement loop can score just a top-k prefix.
        chain = {key: self._chain(r, key, anchors) for key in cands}
        cands.sort(key=chain.__getitem__, reverse=True)
        return cands

    def _chain(self, r: int, key: tuple, anchors: List[tuple]) -> int:
        # chain-colinearity rank: a candidate's support is the summed vote
        # count of the read's anchors that lie ON this path with a
        # projected diagonal inside the banded corridor — the minimap2-
        # style colinear-chain weight, computed from votes already in
        # hand.  Wrong-locus candidates (most pairs at assembly scale) get
        # only their seeding anchor's votes; the true placement accumulates
        # every colinear anchor.
        delta = self.cand_deltas[(r, key)]
        op = self.path_cache[key]
        step_pos = op.step_pos
        if step_pos is None:
            # first-occurrence index per step (simple paths never repeat a
            # state, so this equals tuple.index); cached on the path
            step_pos = op.step_pos = {
                st: k for k, st in reversed(list(enumerate(key)))}
        chain = 0
        for a2, d2, v2 in anchors:
            k_idx = step_pos.get(a2)
            if k_idx is not None and \
                    abs(op.offsets[k_idx] + d2 - delta) <= CHAIN_TOL:
                chain += v2
        self.cand_chain[(r, key)] = chain
        return chain

    # -- read and path codes -----------------------------------------------

    def load_work(self) -> None:
        # working read codes, views into one contiguous blob: the host
        # ladder ships (blob, offsets, lengths) without a copy, placement-
        # round masking (work[r][a:b] = PAD) writes straight into the blob,
        # and the device pools re-upload masked rows from the same views;
        # nothing may rebind work[r]
        arrays = [np.asarray(encode_seq(seq), dtype=np.int8)
                  for _, seq in self.reads]
        self.read_blob = (np.concatenate(arrays) if arrays
                          else np.zeros(1, np.int8))
        self.read_len = np.fromiter(map(len, arrays), np.int64,
                                    count=len(arrays))
        self.read_off = np.zeros(len(arrays), np.int64)
        if len(arrays) > 1:
            np.cumsum(self.read_len[:-1], out=self.read_off[1:])
        self.work = [self.read_blob[self.read_off[r]:
                                    self.read_off[r] + self.read_len[r]]
                     for r in range(len(self.reads))]

    def codes_of(self, key: tuple) -> np.ndarray:
        """Materialize (and cache) a candidate's concatenated code array —
        byte-identical to build_oriented_codes' output; deferred to
        scoring time because chain-tail candidates usually never score."""
        codes = self.code_cache.get(key)
        if codes is None:
            parts: List[np.ndarray] = []
            prev = None
            for sid, orientation in key:
                c = self.seg_codes[(sid, orientation)]
                drop = (self.lut.get(prev + (sid, orientation), 0)
                        if prev else 0)
                parts.append(c[drop:])
                prev = (sid, orientation)
            codes = (np.concatenate(parts) if parts
                     else np.empty(0, np.int8))
            self.code_cache[key] = codes
        return codes

    def blob_off_of(self, key: tuple) -> int:
        """The candidate's offset in the path blob (appended on first use)."""
        off = self.path_off.get(key)
        if off is None:
            codes = self.codes_of(key)
            need = self.path_used + len(codes)
            buf = self.path_blob
            if buf is None or need > len(buf):
                cap = max(need, sum(len(op) for op in self.path_cache.values())
                          + 1024)
                new = np.empty(cap, np.int8)
                if buf is not None:
                    new[:self.path_used] = buf[:self.path_used]
                self.path_blob = buf = new
            buf[self.path_used:need] = codes
            off = self.path_off[key] = self.path_used
            self.path_used = need
        return off

    # -- scoring ----------------------------------------------------------

    def score(self, pairs) -> Dict[int, Tuple[int, int, int, int]]:
        """{pair index: (score, end row, end column, band width, 0 for the
        full DP)}.  Banded first, around each pair's anchor diagonal; pairs
        without one take the full DP under either ladder."""
        if not pairs:
            return {}
        count("align.pairs_scored", len(pairs))
        deltas = [self.cand_deltas.get(p) for p in pairs]
        if any(d is None for d in deltas):
            return self.score_full(pairs)
        if self.host_engine:
            return self.score_host(pairs, deltas)
        return self.score_device(pairs, deltas)

    def _sort_rung(self, idx_list, out, width: int, results,
                   keep_low: bool, keep_edge: bool, redo):
        """The rung test of both ladders: a scored pair (out = best, bi, bj,
        edge by slot of idx_list) goes to redo = (band-edge retry,
        below-min_score retry), or to the results at this width.  keep_edge
        and keep_low make this the terminal rung for that class: weak pairs
        are rejected by the placement loop anyway, and edge-flagged ones
        fail the traceback parity gates into the exact walk."""
        best, bi, bj, edge = out
        redo_edge, redo_low = redo
        for slot, n in enumerate(idx_list):
            if edge[slot] and not keep_edge:
                redo_edge.append(n)
            elif best[slot] < self.min_score and not keep_low:
                redo_low.append(n)
            else:
                results[n] = (int(best[slot]), int(bi[slot]), int(bj[slot]),
                              width)
        return redo

    def score_full(self, pairs) -> Dict[int, Tuple[int, int, int, int]]:
        """Bucketed full-DP pairwise scoring -> {pair_index: (v, bi, bj, 0)}."""
        work = self.work
        with span("align.scoring.full"):
            buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
            for n, (r, key) in enumerate(pairs):
                lr_b = pad_pow2(len(work[r]), floor=16)
                lp_b = pad_pow2(len(self.path_cache[key]), floor=16)
                buckets[(lr_b, lp_b)].append(n)
            results = {}
            # chunked dispatches: a round can hold far more pairs than one
            # (N, lr_b) + (N, lp_b) batch should
            for (lr_b, lp_b), idxs in buckets.items():
                for c0 in range(0, len(idxs), SCORE_CHUNK):
                    chunk = idxs[c0:c0 + SCORE_CHUNK]
                    n_pad = pad_pow2(len(chunk), floor=8)
                    rc = np.full((n_pad, lr_b), seqalign.PAD, np.int8)
                    pc = np.full((n_pad, lp_b), seqalign.PAD, np.int8)
                    for slot, n in enumerate(chunk):
                        r, key = pairs[n]
                        rc[slot, :len(work[r])] = work[r]
                        pcodes = self.codes_of(key)
                        pc[slot, :len(pcodes)] = pcodes
                    best, bi, bj = (x.cpu().numpy() for x in
                                    seqalign.batched_pair_scores(
                                        torch.from_numpy(rc).to(self.device),
                                        torch.from_numpy(pc).to(self.device)))
                    for slot, n in enumerate(chunk):
                        # 0: scored by the full DP -> traceback must be full too
                        results[n] = (int(best[slot]), int(bi[slot]),
                                      int(bj[slot]), 0)
            return results

    def score_host(self, pairs, deltas) -> Dict[int, Tuple[int, int, int, int]]:
        """The native host banded ladder (the JAX package's default
        engine): its own rungs, every result carrying its band width so the
        banded traceback runs at that width.  Its terminal rung is a
        4 x WIDE_BAND band: a placement needing more drift than that around
        its anchor diagonal is effectively unplaceable by this candidate."""
        band, wide = self.params.band, self.params.wide_band
        results: Dict[int, Tuple[int, int, int, int]] = {}
        rung = functools.partial(self._host_rung, self._host_batch(pairs, deltas),
                                 results)
        # the first rung is sized to the read: indel drift grows about
        # linearly with read length, so a BAND/2 half-width is too narrow
        # past (BAND/2)/0.02 bases.  Short reads: BAND, then WIDE_BAND for
        # edges and lows (lows kept there); only band-edge hits go on.
        cut = (band // 2) * 50
        short_idx = [n for n in range(len(pairs))
                     if len(self.work[pairs[n][0]]) <= cut]
        long_idx = [n for n in range(len(pairs))
                    if len(self.work[pairs[n][0]]) > cut]
        edges = []
        if short_idx:
            e1, l1 = rung(short_idx, band)
            redo, _ = rung(e1 + l1, wide, keep_low=True) \
                if e1 + l1 else ([], None)
            edges += redo
        if long_idx:
            # long reads climb a triage ladder with lows terminal at every
            # rung: anchor-voted deltas centre the band on the true
            # diagonal, so wrong-locus pairs score about 0 at every width
            # and only band-EDGE hits (a real alignment continuing outside
            # the band) go wider.  Presets whose band and wide band meet
            # (CLR) collapse the ladder to their widest rung.
            mid = max(band, -(-(wide // 2) // 8) * 8)
            e1 = long_idx
            if band < mid:
                e1, _ = rung(e1, band, keep_low=True)
            if e1:
                e1, _ = rung(e1, mid, keep_low=True)
            if e1 and mid < wide:
                e1, _ = rung(e1, wide, keep_low=True)
            edges += e1
        if edges:
            rung(edges, 4 * wide, keep_low=True, keep_edge=True)
        return results

    def _host_batch(self, pairs, deltas):
        # the host ladder's arguments: read codes ship as the shared blob
        # (masking writes into it), path codes as absolute offsets into the
        # path blob
        ukeys: Dict[tuple, int] = {}
        for _, key in pairs:
            ukeys.setdefault(key, len(ukeys))
        path_off = np.fromiter(map(self.blob_off_of, ukeys), np.int64,
                               count=len(ukeys))   # appends to path_blob
        path_len = np.fromiter((len(self.path_cache[k]) for k in ukeys),
                               np.int64, count=len(ukeys))
        rid = np.fromiter(map(itemgetter(0), pairs), np.int32, count=len(pairs))
        pidn = np.fromiter((ukeys[k] for _, k in pairs), np.int32,
                           count=len(pairs))
        return (self.path_blob, path_off, path_len, rid, pidn,
                np.asarray(deltas, np.int32))

    def _host_rung(self, batch, results, idx_list, width: int,
                   keep_low: bool = False, keep_edge: bool = False):
        """One host rung: seq_banded_pairs over pairs idx_list at width."""
        path_blob, path_off, path_len, rid, pidn, dl = batch
        idx = np.asarray(idx_list, np.int32)
        count("align.host_ladder.rungs")
        count("align.host_ladder.pairs", len(idx))
        count("align.host_ladder.cells", int(self.read_len[rid[idx]].sum()) * width)
        with span("align.scoring.rung"):
            out = native.seq_banded_pairs(
                self.read_blob, self.read_off, self.read_len, path_blob,
                path_off, path_len, rid[idx], pidn[idx], dl[idx], width,
                seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP,
                seqalign.PAD, seqalign._BLOCK)
        return self._sort_rung(idx_list, out, width, results, keep_low,
                               keep_edge, ([], []))

    def score_device(self, pairs, deltas) -> Dict[int, Tuple[int, int, int, int]]:
        """The device ladder: K3 on DevicePools at BAND, then WIDE_BAND,
        then the full DP (or a 4 x WIDE_BAND rung) for band-edge pairs."""
        pools, work = self.pools, self.work
        band, wide = self.params.band, self.params.wide_band
        # flush masked reads + register every path key BEFORE the first
        # dispatch, so the path tables grow at most once per round
        with span("align.scoring.pools"):
            if self.dirty_reads:
                pools.update_reads(sorted(self.dirty_reads), work)
                self.dirty_reads.clear()
            rows = [pools.path_idx(key, self.path_cache[key])
                    for _, key in pairs]
            pools.sync_paths()
        irregular = [n for n, row in enumerate(rows) if row is None]
        results: Dict[int, Tuple[int, int, int, int]] = {}
        rung = functools.partial(self._device_rung, pairs, deltas, results)
        if irregular:
            # paths the arena mapping can't represent: exact host-array DP
            sub = self.score_full([pairs[n] for n in irregular])
            for slot, n in enumerate(irregular):
                results[n] = sub[slot]
        e1, l1 = rung([n for n, row in enumerate(rows) if row is not None],
                      band)
        redo = e1 + l1
        if redo:
            # one widening for everything: band misses are usually small
            # diagonal drift.  Sub-threshold pairs that stay weak in the
            # 4x band are genuinely weak (masked reads of later placement
            # rounds score low everywhere; rescoring them at full width
            # would build huge full-DP batches).
            redo, _ = rung(redo, wide, keep_low=True)
        if redo:
            # only band-EDGE survivors ride further: their optimum may
            # genuinely continue outside the band
            lr_b = pad_pow2(max(len(work[pairs[n][0]]) for n in redo), floor=16)
            lp_b = pad_pow2(max(len(self.path_cache[pairs[n][1]]) for n in redo),
                            floor=16)
            if lr_b * lp_b <= 4096 * 8192:
                sub = self.score_full([pairs[n] for n in redo])
                for slot, n in enumerate(redo):
                    results[n] = sub[slot]
            else:
                # the full DP is not run beyond this area (the rule decides
                # which result is emitted, so it is kept as it stands);
                # terminal rung: a 4 x WIDE_BAND anchored band, accepted
                # as-is.  A placement needing more drift than that around
                # its anchor diagonal is effectively unplaceable by this
                # candidate — the min_score filter and the traceback parity
                # gates keep anything emitted honest.
                rung(redo, 4 * wide, keep_low=True, keep_edge=True)
        return results

    def _device_rung(self, pairs, deltas, results, idx_list, width: int,
                     keep_low: bool = False, keep_edge: bool = False):
        """One device rung: K3 over pairs idx_list at width.  Dispatches
        ship only row indices; read codes and the segment arena live on the
        device (DevicePools) and path strips are assembled there."""
        pools = self.pools
        with span("align.scoring.rung"):
            redo = ([], [])
            # dispatch ALL chunks before fetching any result: device
            # execution overlaps host chunk prep (the fetch is the
            # synchronization point)
            inflight = []
            for c0 in range(0, len(idx_list), SCORE_CHUNK):  # bounded dispatch
                chunk = idx_list[c0:c0 + SCORE_CHUNK]
                ridx = np.fromiter((pairs[n][0] for n in chunk), np.int32,
                                   count=len(chunk))
                pidx = np.fromiter((pools.path_row[pairs[n][1]] for n in chunk),
                                   np.int32, count=len(chunk))
                dl = np.fromiter((deltas[n] for n in chunk), np.int32,
                                 count=len(chunk))
                inflight.append((chunk, seqalign.banded_arena_scores(
                    pools.arena, pools.cum_off, pools.base_ptr, pools.plen,
                    pools.reads, ridx, pidx, dl, width=width,
                    materialize=False)))
            for chunk, out in inflight:
                self._sort_rung(chunk, [x.cpu().numpy() for x in out], width,
                                results, keep_low, keep_edge, redo)
            return redo

    # -- placement --------------------------------------------------------

    def place(self, r: int, entries):
        """Read r's placements from its scored entries, best first: a
        generator that yields each banded walk it needs, (key, end row, end
        column, diagonal, band width, ladder score), is sent the walk's
        Placement (None: declined, so the exact walk runs) and returns
        whether it placed anything."""
        placed = False
        rcodes = self.work[r]
        for v, bi, bj, banded, key in entries:
            if v < self.min_score:
                break
            path = self.path_cache[key]
            if _reject_ending_inside(self.graph, path, v, bi, bj,
                                     self.accepted[r], self.all_hits[r]):
                continue
            pl = None
            # banded traceback (O(Lr x band)) where the scorer banded the
            # pair (banded: its band width, 0 = full DP); parity-gated —
            # None falls through to the exact full-matrix walk
            delta = self.cand_deltas.get((r, key)) if banded else None
            if delta is not None:
                pl = yield key, bi, bj, delta, banded, v
                count("align.traceback.banded_walks")
                if pl is None:
                    count("align.traceback.declined")
            if pl is None:
                # the ladder's score v bounds the walk's columns
                with span("align.traceback"), span("align.traceback.full"):
                    pl = seqalign.traceback(rcodes, self.codes_of(key), bi, bj,
                                            self.device, score=v)
                count("align.traceback.full_walks")
            placed = accept(self.graph, path, pl, self.accepted[r],
                            self.all_hits[r], self.min_score) or placed
        return placed

    def rounds(self, active: List[int]) -> None:
        # Two-wave scoring with chain-ranked top-k: each read's first wave
        # scores only its CHAIN_TOP_K best-supported candidates (ties at the
        # boundary extend, capped at 2x, so an equal-support multi-mapping
        # competitor is never dropped from the mapq evidence).  A read that
        # places nothing — or keeps a scoreable uncovered region (chimeric /
        # supplementary case whose second locus may rank below the cut) —
        # opens its full candidate list on the next iteration.  Scores are
        # cached per (read, candidate) and invalidated when the read is
        # masked, so the tail-opening iteration re-scores nothing it already
        # paid for; with pruning inactive (few candidates) the flow is
        # identical to the previous 4-round loop (mask_rounds keeps the same
        # 4-masking budget per read).
        score_cache: Dict[Tuple[int, tuple], Tuple[int, int, int, int]] = {}
        mask_rounds: Dict[int, int] = {r: 0 for r in active}
        open_k = {r: self._top_k(r) for r in active}
        for _iter in range(8):
            if not active:
                break
            pairs_all = [(r, key) for r in active
                         for key in self.cand_lists[r][:open_k[r]]
                         if (r, key) not in self.dead_pairs]
            to_score = [p for p in pairs_all if p not in score_cache]
            with span("align.scoring"):
                scored = self.score(to_score)
            for n, p in enumerate(to_score):
                score_cache[p] = scored[n]
            by_read: Dict[int, List[tuple]] = defaultdict(list)
            for r, key in pairs_all:
                v, bi, bj, banded = score_cache[(r, key)]
                if v < self.min_score:
                    self.dead_pairs.add((r, key))
                by_read[r].append((v, bi, bj, banded, key))
            placed_reads = self.walk_waves(active, by_read)
            next_active = []
            for r in active:
                placed = placed_reads[r]
                if placed:
                    for a, b in self.accepted[r]:
                        self.work[r][a:b] = seqalign.PAD
                    self.dirty_reads.add(r)
                    mask_rounds[r] += 1
                    for key in self.cand_lists[r]:
                        score_cache.pop((r, key), None)  # masked read changed
                still = (_longest_uncovered(len(self.work[r]), self.accepted[r])
                         >= self.min_score)
                n_cands = len(self.cand_lists[r])
                if (not placed or still) and open_k[r] < n_cands:
                    open_k[r] = n_cands   # open the chain tail
                    next_active.append(r)
                elif placed and still and mask_rounds[r] < 4:
                    next_active.append(r)
            active = next_active

    def _top_k(self, r: int) -> int:
        keys = self.cand_lists[r]
        k = min(CHAIN_TOP_K, len(keys))
        if k < len(keys):
            edge = self.cand_chain.get((r, keys[k - 1]), 0)
            while (k < len(keys) and k < 2 * CHAIN_TOP_K
                   and self.cand_chain.get((r, keys[k]), 0) == edge):
                k += 1
        return k

    def walk_waves(self, active: List[int], by_read) -> Dict[int, bool]:
        """{read: whether it placed anything} after its walks."""
        # Walks in waves: a read's entries run in order, since what its
        # earlier walks accepted decides its next (_reject_ending_inside,
        # the shadowing test), so each read is a generator (place) that
        # stops at every banded walk it needs; a wave gathers the next walk
        # of every read and walks them in one call (on CUDA one kernel
        # launch).  Walk inputs do not depend on the order across reads
        # (work[r] is masked only after r's own entries), so every read
        # makes the walks and decisions of a read-by-read loop.
        walkers = {r: self.place(r, sorted(by_read[r], key=itemgetter(0),
                                           reverse=True))
                   for r in active}
        placed_reads: Dict[int, bool] = {}
        replies = {r: None for r in active}
        while replies:
            wave = {}
            for r, pl in replies.items():
                try:
                    wave[r] = walkers[r].send(pl)
                except StopIteration as done:
                    placed_reads[r] = done.value
            if not wave:
                break
            with span("align.traceback"), span("align.traceback.banded"):
                got = seqalign.banded_tracebacks(
                    [(self.work[r], self.codes_of(key), *rest)
                     for r, (key, *rest) in wave.items()], self.device)
            replies = dict(zip(wave, got))
        return placed_reads
