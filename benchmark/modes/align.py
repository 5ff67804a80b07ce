"""align cells: `gfalign align -p <preset> -f graph.gfa -r <pool file> -o
<out.gaf>` through `gfalign_torch.cli.main.main` on the card, calls back
to back (one curator's closed loop) over a pool of FASTQ files of
`reads_per_call` reads each, in turn, wrapping when the pool runs out.
The graph and the configuration's reads come from `workload.DATA_SEED`;
the run's seed only deals the reads out in another order, so every run
does the same work.

Correctness, judged once the window has closed on a sample of the reads
of its calls drawn from the seed (with the longest among them):
  * record_faults: GAF records whose fields disagree with the read, the
    graph or their own CIGAR, or score under the preset's minimum;
  * unplaced: sampled reads with no record;
  * below_optimum: reads whose first (best) record scores less than the
    best local alignment of the read on that record's own path, in a band
    of diagonals around the record (the ladder's K3 and K4 scores and the
    traceback both have to reach it);
  * truth_gap: the widest shortfall of a first record's score under the
    best local alignment of the read on the walk it was sampled from, as a
    share of the latter (a read placed elsewhere, cut short or split reads
    near 1; a read clipped by a few bases at an end, a few thousandths);
and on a sample drawn from the seed of the pairs that the ladder's banded
scorer (K3) scored in the window, `ladder_pairs` of them:
  * ladder_score_faults: pairs whose score, end cell or band-edge flag
    disagrees with the reference's banded DP of the read against the path
    in the same band (the score decides each read's ranking and rung; a
    wrong one that the traceback's parity gate catches only slows a run).
    Pairs of a read that an earlier placement round has masked are left
    out of the sample: the masked read is the program's own state.
"""

from __future__ import annotations

import contextlib
import heapq
import io
import os
import random
import sys
import time
from typing import Dict, List

import numpy as np

from .. import roofline, workload
from ..reference import align as ref


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class LadderSample:
    """A uniform sample, drawn from the seed, of the pairs that
    `seqalign.banded_arena_scores` scores while it is installed: each pair
    gets a random key and the `size` smallest keys are kept (the outputs
    are kept as the device tensors the program got, read once the window
    has closed).  The read, path and band of each pair come from the
    program's calls: `_align_seeded` names the call's reads, the device
    pools' `path_idx` names each path row's steps and `update_reads` marks
    the rows that placement masked."""

    def __init__(self, seed: int, size: int, read_index: Dict[str, int]):
        self.rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x1ADDE2])
        self.size, self.read_index = size, read_index
        self.heap: List[tuple] = []        # (-key, n, entry)
        self.n = 0
        self.calls = {}                     # read pool data_ptr -> state
        self.names: List[str] = []         # the reads of the running call

    def install(self):
        from gfalign_torch.engine import graph_align
        from gfalign_torch.ops import seqalign

        pools_cls = graph_align.DevicePools
        real = (graph_align._align_seeded, pools_cls.__init__,
                pools_cls.path_idx, pools_cls.update_reads,
                seqalign.banded_arena_scores)
        sample = self

        def align_seeded(graph, reads, *a, **kw):
            sample.names = [name for name, _ in reads]
            return real[0](graph, reads, *a, **kw)

        def init(self_, work, graph, device):
            real[1](self_, work, graph, device)
            sample.calls[self_.reads.data_ptr()] = {
                "reads": [sample.read_index.get(n) for n in sample.names],
                "graph": graph, "paths": {}, "masked": set()}

        def path_idx(self_, key, op):
            row = real[2](self_, key, op)
            state = sample.calls.get(self_.reads.data_ptr())
            if row is not None and state is not None:
                state["paths"][row] = key
            return row

        def update_reads(self_, rows, work):
            state = sample.calls.get(self_.reads.data_ptr())
            if state is not None:
                state["masked"].update(rows)
            return real[3](self_, rows, work)

        def banded(arena, cum_off, base_ptr, plen, read_pool, read_idx,
                   path_idx_, deltas, width=128, materialize=True):
            out = real[4](arena, cum_off, base_ptr, plen, read_pool,
                          read_idx, path_idx_, deltas, width=width,
                          materialize=materialize)
            state = sample.calls.get(read_pool.data_ptr())
            if state is not None:
                sample.offer(state, out, _host(read_idx), _host(path_idx_),
                             _host(deltas), width)
            return out

        graph_align._align_seeded = align_seeded
        pools_cls.__init__, pools_cls.path_idx = init, path_idx
        pools_cls.update_reads = update_reads
        seqalign.banded_arena_scores = banded

        def uninstall():
            (graph_align._align_seeded, pools_cls.__init__, pools_cls.path_idx,
             pools_cls.update_reads, seqalign.banded_arena_scores) = real
        return uninstall

    def offer(self, state, out, ridx, pidx, deltas, width: int) -> None:
        keys = self.rng.random(len(ridx))
        full = len(self.heap) >= self.size
        cut = -self.heap[0][0] if full else 1.0
        for slot in np.flatnonzero(keys < cut)[np.argsort(keys[keys < cut])]:
            r, p = int(ridx[slot]), int(pidx[slot])
            key = state["paths"].get(p)
            if (r in state["masked"] or key is None or r >= len(state["reads"])
                    or state["reads"][r] is None):
                continue
            steps = tuple((state["graph"].segment(sid).name, o) for sid, o in key)
            entry = (state["reads"][r], steps, int(deltas[slot]), width, out,
                     int(slot))
            self.n += 1
            item = (-float(keys[slot]), self.n, entry)
            if len(self.heap) < self.size:
                heapq.heappush(self.heap, item)
            elif item > self.heap[0]:
                heapq.heapreplace(self.heap, item)
            else:
                break                       # the rest have larger keys

    def entries(self) -> List[tuple]:
        """(read index, steps, delta, width, (best, end_i, end_j, edge)) of
        each kept pair, the scorer's answers read off its outputs."""
        got = []
        for _, _, (r, steps, delta, width, out, slot) in sorted(self.heap):
            vals = tuple(int(_host(x)[slot]) for x in out)
            got.append((r, steps, delta, width, vals))
        return got


class Cell:
    unit = "reads"

    def __init__(self, config: dict, traffic: dict, seed: int, work_dir: str,
                 device: str = "cuda"):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.dir, self.device = work_dir, device
        self.outputs: List[tuple] = []        # (pool index, GAF path)
        self.calls_wall = 0.0
        self.phase0 = None

    # -- set-up -----------------------------------------------------------
    def prepare(self) -> None:
        self.wl = workload.from_config(self.cfg, workload.DATA_SEED)
        self.gfa = os.path.join(self.dir, "graph.gfa")
        workload.write_gfa(self.wl, self.gfa)
        per = self.tr["reads_per_call"]
        order = list(range(len(self.wl.reads)))
        random.Random(self.seed).shuffle(order)
        self.pool = []
        for k in range(0, len(order), per):
            path = os.path.join(self.dir, f"pool{len(self.pool):03d}.fq")
            idx = order[k:k + per]
            workload.write_fastq([self.wl.reads[r] for r in idx], path)
            self.pool.append((idx, path))
        self.warm_fq = os.path.join(self.dir, "warm.fq")
        workload.write_fastq([self.wl.reads[r] for r in order[:self.tr["warm_reads"]]],
                             self.warm_fq)

    def argv(self, reads: str, out: str) -> List[str]:
        return ["align", "-f", self.gfa, "-r", reads, "-o", out,
                *self.tr["argv"]]

    def _main(self, argv) -> int:
        from gfalign_torch.cli.main import main

        with contextlib.redirect_stdout(io.StringIO()):
            return main(argv, device=self.device)

    def warm(self) -> None:
        if self._main(self.argv(self.warm_fq, os.path.join(self.dir, "warm.gaf"))):
            raise RuntimeError("the warm-up call failed")

    # -- the window -------------------------------------------------------
    def start_window(self) -> None:
        from gfalign_torch.engine import graph_align

        self.phase0 = dict(graph_align.PHASE_SECONDS)
        self.ladder = LadderSample(
            self.seed, self.tr["ladder_pairs"],
            {name: r for r, (name, _) in enumerate(self.wl.reads)})
        self._uninstall = self.ladder.install()

    def end_window(self) -> None:
        self._uninstall()

    def call(self, k: int):
        """One call on pool file k (mod the pool); (reads, ok)."""
        idx, fq = self.pool[k % len(self.pool)]
        out = os.path.join(self.dir, f"out{k:04d}.gaf")
        t = time.perf_counter()
        try:
            ok = self._main(self.argv(fq, out)) == 0
        except Exception as exc:            # a failed call fails its reads
            print(f"call {k} raised {exc!r}", file=sys.stderr, flush=True)
            ok = False
        self.calls_wall += time.perf_counter() - t
        if ok:
            self.outputs.append((k % len(self.pool), out))
        return len(idx), ok

    def end_to_end(self, elapsed: float, done: int) -> Dict[str, float]:
        return {"align_reads_per_s": done / elapsed}

    # -- the traced run ---------------------------------------------------
    @contextlib.contextmanager
    def traced(self):
        yield

    def profiled_call(self, k: int, sl) -> None:
        """One whole call under the profiler, with K3's work counted from
        the arguments of each call into the kernel layer."""
        from gfalign_torch.engine import graph_align
        from gfalign_torch.ops import seqalign

        work = {"cells": 0.0, "ops": 0.0, "bytes": 0.0}
        pools = {}
        real_banded, real_init = seqalign.banded_arena_scores, graph_align.DevicePools.__init__

        def init(self_, w, *a, **kw):
            real_init(self_, w, *a, **kw)
            pools[self_.reads.data_ptr()] = w

        def banded(arena, cum_off, base_ptr, plen, read_pool, read_idx,
                   path_idx, deltas, width=128, materialize=True):
            host = pools.get(read_pool.data_ptr())
            if host is not None:
                got = roofline.banded_work(roofline.live_rows(host, read_idx), width)
                for key in work:
                    work[key] += got[key]
            return real_banded(arena, cum_off, base_ptr, plen, read_pool,
                               read_idx, path_idx, deltas, width=width,
                               materialize=materialize)

        fq = self.pool[k % len(self.pool)][1]
        phases = dict(graph_align.PHASE_SECONDS)     # the window's, kept apart
        seqalign.banded_arena_scores = banded
        graph_align.DevicePools.__init__ = init
        try:
            sl.start()
            self._main(self.argv(fq, os.path.join(self.dir, "traced.gaf")))
            sl.stop()
        finally:
            seqalign.banded_arena_scores = real_banded
            graph_align.DevicePools.__init__ = real_init
            graph_align.PHASE_SECONDS.update(phases)
        self.traced_work = {"k3": work}

    def observations(self, done: int) -> dict:
        from gfalign_torch.engine import graph_align

        phase = {k: graph_align.PHASE_SECONDS[k] - self.phase0.get(k, 0.0)
                 for k in graph_align.PHASE_SECONDS}
        return {"mode": "align", "reads": done, "calls_wall_s": self.calls_wall,
                "phase_s": phase, "work": getattr(self, "traced_work", {})}

    # -- correctness --------------------------------------------------------
    def judge(self, control: bool = False) -> Dict[str, dict]:
        """The compared numbers, each with its limit (traffic `limits`).
        With `control`, the reference aligner in int8 stands in for the
        program's records."""
        names = {}
        for pidx, out in self.outputs:
            for r in self.pool[pidx][0]:
                names[r] = out
        reads = sorted(names)
        rng = random.Random(self.seed ^ 0x5EED)
        n_check = min(len(reads), self.tr["check_reads"])
        longest = max(reads, key=lambda r: len(self.wl.reads[r][1])) if reads else None
        sample = rng.sample(reads, n_check)
        if control:     # the reference aligner makes records for the DP sample
            sample = sample[:self.tr["dp_reads"]]
        if longest is not None and longest not in sample:
            sample[-1] = longest
        by_file: Dict[str, List[str]] = {}
        lines_of: Dict[int, List[str]] = {}
        for r in sample:
            out = names[r]
            if out not in by_file:
                with open(out) as fh:
                    by_file[out] = ref.first_records(fh.read().splitlines())
        links = ref.link_set(self.wl.links)
        min_score = self.cfg["min_score"]
        margin = self.tr["corridor_margin"]
        for r in sample:
            name = self.wl.reads[r][0]
            lines_of[r] = (self.control_lines(r, margin) if control
                           else by_file[names[r]].get(name, []))
        faults = unplaced = 0
        firsts = []
        for r in sample:
            recs = lines_of[r]
            if not recs:
                unplaced += 1
                continue
            scored = []
            for ln in recs:
                bad, score, rec = ref.check_record(ln, self.wl.reads[r],
                                                   self.wl.seqs, links, min_score)
                if bad:
                    faults += 1
                    if faults <= 5:
                        print(f"record fault {bad} in {ln[:160]}",
                              file=sys.stderr)
                scored.append((score, ln, rec, bad))
            if r in sample[:self.tr["dp_reads"]] or r == longest:
                top = recs[0]
                score, _, rec, bad = scored[0]
                if not bad:
                    firsts.append((r, score, rec, ref.ops_of(top.rsplit("cg:Z:", 1)[1])))
        below_opt, truth_gap = self._optimality(firsts, margin)
        ladder_faults = self._ladder_faults(control)
        lim = self.tr["limits"]
        return {"record_faults": {"value": faults, "limit": lim["record_faults"]},
                "unplaced": {"value": unplaced, "limit": lim["unplaced"]},
                "below_optimum": {"value": below_opt, "limit": lim["below_optimum"]},
                "truth_gap": {"value": truth_gap, "limit": lim["truth_gap"]},
                "ladder_score_faults": {"value": ladder_faults,
                                        "limit": lim["ladder_score_faults"]}}

    def _ladder_faults(self, control: bool) -> int:
        """Sampled banded pairs whose answers the reference's banded DP
        does not give (with `control`, the reference in int8 answers)."""
        sample = getattr(self, "ladder", None)
        entries = sample.entries() if sample is not None else []
        print(f"ladder: {len(entries)} sampled pairs of the banded scorer",
              file=sys.stderr)
        faults = 0
        for width in sorted({e[3] for e in entries}):
            group = [e for e in entries if e[3] == width]
            reads = [ref.codes(self.wl.reads[r][1]) for r, *_ in group]
            paths = [ref.codes(ref.path_seq(steps, self.wl.seqs))
                     for _, steps, *_ in group]
            got = [np.array([e[4][q] for e in group]) for q in range(4)]
            bad = ref.banded_check(reads, paths, [e[2] for e in group], width,
                                   got, block=self.tr.get("dp_block", 16),
                                   int8=control)
            for k in np.flatnonzero(bad)[:3].tolist():
                r, steps, delta, _, vals = group[k]
                print(f"ladder fault{' (control)' if control else ''}: "
                      f"read {self.wl.reads[r][0]} width {width} "
                      f"delta {delta} got (best, i, j, edge) {vals}",
                      file=sys.stderr)
            faults += int(bad.sum())
        return faults

    def _optimality(self, firsts, margin: int):
        """Each first record's score against the corridor optimum on its own
        path and on the read's truth walk, in one batched pass."""
        if not firsts:
            return 0, 0.0
        reads, paths, lo, hi = [], [], [], []
        for r, score, rec, ops in firsts:
            rc = ref.codes(self.wl.reads[r][1])
            d_lo, d_hi = ref.record_corridor(ops, rec["qs"], rec["ps"], margin)
            reads.append(rc)
            paths.append(ref.codes(rec["seq"]))
            lo.append(d_lo)
            hi.append(d_hi)
        for r, score, rec, ops in firsts:
            t = self.wl.truth[r]
            steps = ref.truth_steps(t.walk, t.strand)
            seq = ref.path_seq(steps, self.wl.seqs)
            d_lo, d_hi = ref.truth_corridor(len(self.wl.reads[r][1]), len(seq),
                                            t.start_off, t.raw_len, t.strand, margin)
            reads.append(ref.codes(self.wl.reads[r][1]))
            paths.append(ref.codes(seq))
            lo.append(d_lo)
            hi.append(d_hi)
        best = np.zeros(len(reads), np.int64)
        block = max(1, self.tr.get("dp_block", 16))
        for b0 in range(0, len(reads), block):
            best[b0:b0 + block] = ref.corridor_best(
                reads[b0:b0 + block], paths[b0:b0 + block],
                lo[b0:b0 + block], hi[b0:b0 + block])[0]
        n = len(firsts)
        scores = np.array([s for _, s, _, _ in firsts])
        own, truth = best[:n], best[n:]
        for k in np.flatnonzero((scores < own) | (scores < truth))[:5].tolist():
            print(f"read {self.wl.reads[firsts[k][0]][0]}: record {scores[k]}, "
                  f"own path {own[k]}, truth walk {truth[k]}",
                  file=sys.stderr)
        gap = np.maximum(truth - scores, 0) / np.maximum(truth, 1)
        return int((scores < own).sum()), float(gap.max())

    def control_lines(self, r: int, margin: int) -> List[str]:
        """The control's record of read r: the reference aligner on the
        read's truth walk, in saturating int8."""
        t = self.wl.truth[r]
        name, seq = self.wl.reads[r]
        steps = ref.truth_steps(t.walk, t.strand)
        pseq = ref.path_seq(steps, self.wl.seqs)
        d_lo, d_hi = ref.truth_corridor(len(seq), len(pseq), t.start_off,
                                        t.raw_len, t.strand, margin)
        score, qs, qe, ps, pe, runs = ref.corridor_align(
            ref.codes(seq), ref.codes(pseq), d_lo, d_hi, int8=True)
        if score <= 0 or not runs:
            return []
        return [ref.record_line(name, len(seq), steps, self.wl.seqs,
                                qs, qe, ps, pe, runs)]
