"""align cells of ultra-long reads: the align mode's calls and judgement
(modes/align.py) on a configuration whose reads are a fixed set of
quantile lengths (ul_reads.py; configs/ont_r10.json), all of them in one
call, in the run seed's order.  It reports "mode": "align", so the align
readers apply, and adds:

  * the reads from ul_reads.make, and a warm-up call of the traffic's
    `warm_reads` shortest reads;
  * the program's spans and counters over the window
    (utils/profiling.snapshot and since, where the program has them), in
    the observations as `spans` (seconds) and `counts`;
  * in the traced call, the exact full-matrix walk's work, counted from
    each on-card call into ops.seqalign.traceback: `walk_work`, whatever
    the walk computes.
"""

from __future__ import annotations

import os
import random
from typing import Dict

from .. import roofline, ul_reads, workload
from . import align


def walk_work(end_i: int, end_j: int) -> Dict[str, float]:
    """The exact full-matrix walk's work for an end cell (end_i, end_j): the
    problem's size, end_i x end_j cells at roofline.OPS_PER_CELL int32
    operations; the read's and the path's chars read once and an op a row
    and a column written."""
    cells = float(end_i) * float(end_j)
    return {"cells": cells, "ops": cells * roofline.OPS_PER_CELL,
            "bytes": 2.0 * (end_i + end_j)}


def _profiling():
    try:
        from gfalign_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "since") else None


class Cell(align.Cell):

    def prepare(self) -> None:
        self.wl = ul_reads.make(self.cfg, workload.DATA_SEED)
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
        shortest = sorted(order, key=lambda r: len(self.wl.reads[r][1]))
        self.warm_fq = os.path.join(self.dir, "warm.fq")
        workload.write_fastq([self.wl.reads[r] for r in shortest[:self.tr["warm_reads"]]],
                             self.warm_fq)

    def start_window(self) -> None:
        prof = _profiling()
        self.registry0 = prof.snapshot() if prof else None
        super().start_window()

    def end_window(self) -> None:
        super().end_window()
        prof = _profiling()
        self.registry = (prof.since(self.registry0)
                         if prof and self.registry0 is not None else None)

    def profiled_call(self, k: int, sl) -> None:
        """align.Cell's traced call, with the walk's work counted from the
        arguments of each on-card call into seqalign.traceback."""
        from gfalign_torch.ops import seqalign

        work = {"cells": 0.0, "ops": 0.0, "bytes": 0.0}
        real = seqalign.traceback

        def traceback(read, path, end_i, end_j, *args, **kw):
            device = args[0] if args else kw.get("device", "cpu")
            if str(device).startswith("cuda"):
                for key, v in walk_work(end_i, end_j).items():
                    work[key] += v
            return real(read, path, end_i, end_j, *args, **kw)

        seqalign.traceback = traceback
        try:
            super().profiled_call(k, sl)
        finally:
            seqalign.traceback = real
        self.traced_work["walk"] = work

    def observations(self, done: int) -> dict:
        obs = super().observations(done)
        reg = getattr(self, "registry", None)
        if reg is not None:
            obs["spans"] = reg["seconds"]
            obs["counts"] = reg["counts"]
        return obs
