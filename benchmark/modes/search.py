"""search cells: `gfalign search -f graph.gfa -g <records.gaf> -n
<tangle nodes> -s <first tangle node> -d <last> --return-all-paths`
through `gfalign_torch.cli.main.main` on the card, back to back on the
same inputs.  `records` picks the alignments: "all" the truth records of
every read, "window" those whose every node lies in the tangle and the
filter margin around it (the upstream workflow: filter, then search).
The graph and records come from `workload.DATA_SEED`; the run's seed
only orders the records, so every run does the same work.

Correctness: every search of the window prints the reference's lines
(reference/search.py on the same graph, node list and records);
rows_differ counts the lines that differ, over all searches.
"""

from __future__ import annotations

import contextlib
import io
import os
import random
import sys
import time
from typing import Dict, List

import numpy as np

from .. import roofline, workload
from ..reference import search as ref


class Cell:
    unit = "searches"

    def __init__(self, config: dict, traffic: dict, seed: int, work_dir: str,
                 device: str = "cuda"):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.dir, self.device = work_dir, device
        self.outputs: List[str] = []
        self.search_wall = 0.0
        self.eval_s = 0.0
        self.eval_calls = 0
        self.counting = None               # K1 work, during the traced slice

    def prepare(self) -> None:
        self.wl = workload.from_config(self.cfg, workload.DATA_SEED,
                                       sequences=False)
        d = self.dir
        self.gfa = os.path.join(d, "graph.gfa")
        workload.write_gfa(self.wl, self.gfa)
        window = self.wl.filter_nodelist if self.tr["records"] == "window" else None
        self.gaf = os.path.join(d, "records.gaf")
        order = list(range(len(self.wl.reads)))
        random.Random(self.seed).shuffle(order)
        workload.write_truth_gaf(self.wl, self.gaf, window, order)
        self.walks = [w for _, w, _ in workload.truth_records(self.wl)
                      if window is None or workload.in_window(w, window)]
        self.nodes = os.path.join(d, "nodes.tsv")
        with open(self.nodes, "w") as fh:
            fh.write("".join(row + "\n" for row in self.wl.search_nodelist))
        # the warm-up searches the same tangle with every budget at 1
        self.warm_nodes = os.path.join(d, "warm_nodes.tsv")
        with open(self.warm_nodes, "w") as fh:
            fh.write("".join(row.split("\t")[0] + "\t1\n"
                             for row in self.wl.search_nodelist))

    def argv(self, nodes: str) -> List[str]:
        return ["search", "-f", self.gfa, "-g", self.gaf, "-n", nodes,
                "-s", self.wl.source, "-d", self.wl.destination,
                *self.tr["argv"]]

    def _main(self, argv):
        from gfalign_torch.cli.main import main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv, device=self.device)
        return rc, buf.getvalue()

    def warm(self) -> None:
        if self._main(self.argv(self.warm_nodes))[0]:
            raise RuntimeError("the warm-up search failed")

    def start_window(self) -> None:
        pass

    def end_window(self) -> None:
        pass

    def call(self, k: int):
        t = time.perf_counter()
        try:
            rc, out = self._main(self.argv(self.nodes))
            ok = rc == 0
        except Exception as exc:
            print(f"search {k} raised {exc!r}", file=sys.stderr, flush=True)
            ok, out = False, ""
        self.search_wall += time.perf_counter() - t
        if ok:
            self.outputs.append(out)
        return 1, ok

    def end_to_end(self, elapsed: float, done: int) -> Dict[str, float]:
        return {"search_s": elapsed / done}

    @contextlib.contextmanager
    def traced(self):
        """The wall inside `evaluate_candidates`, wrapped where the search
        driver looks it up, and K1's work while a slice counts it."""
        from gfalign_torch.engine import search as search_mod

        real = search_mod.evaluate_candidates

        def timed(candidates, read_paths, *a, **kw):
            if self.counting is not None:
                got = roofline.path_work([len(c) for c in candidates],
                                         np.asarray(read_paths.lengths))
                for key in self.counting:
                    self.counting[key] += got[key]
            t = time.perf_counter()
            try:
                return real(candidates, read_paths, *a, **kw)
            finally:
                self.eval_s += time.perf_counter() - t
                self.eval_calls += 1
                if self.on_call is not None:
                    self.on_call()

        self.on_call = None
        search_mod.evaluate_candidates = timed
        try:
            yield
        finally:
            search_mod.evaluate_candidates = real

    def profiled_call(self, k: int, sl) -> None:
        """The first `profile_calls` frontier calls of one search under the
        profiler, K1's work counted over them; the search then runs to its
        end untraced.  The window's layer times are kept apart from it."""
        saved = (self.eval_s, self.eval_calls, self.search_wall)
        self.counting = {"cells": 0.0, "ops": 0.0, "bytes": 0.0}
        limit = self.eval_calls + self.tr["profile_calls"]

        def on_call():
            if self.eval_calls >= limit and self.counting is not None:
                sl.stop()
                self.traced_work = {"k1": dict(self.counting)}
                self.counting = None

        self.on_call = on_call
        sl.start()
        try:
            self._main(self.argv(self.nodes))
        finally:
            if self.counting is not None:
                sl.stop()
                self.traced_work = {"k1": dict(self.counting)}
                self.counting = None
            self.on_call = None
            self.eval_s, self.eval_calls, self.search_wall = saved

    def observations(self, done: int) -> dict:
        return {"mode": "search", "searches": done,
                "search_wall_s": self.search_wall, "evaluate_s": self.eval_s,
                "frontier_calls": self.eval_calls,
                "work": getattr(self, "traced_work", {})}

    def reference_rows(self, control: bool = False) -> List[str]:
        paths = [[(n, "+") for n in walk] for walk in self.walks]
        return ref.search_rows(self.wl.names, self.wl.links,
                               self.wl.search_nodelist, self.wl.source,
                               self.wl.destination, paths,
                               return_all="--return-all-paths" in self.tr["argv"],
                               both_strands=not control)

    def judge(self, control: bool = False) -> Dict[str, dict]:
        want = self.reference_rows()
        outs = ["\n".join(self.reference_rows(control=True)) + "\n"] if control \
            else self.outputs
        differ = 0
        for out in outs:
            got = out.splitlines()
            differ += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        for out in outs[:1]:
            for a, b in list(zip(out.splitlines(), want))[:2000]:
                if a != b:
                    print(f"program: {a[:160]}\nreference: {b[:160]}",
                          file=sys.stderr)
                    break
        return {"rows_differ": {"value": differ,
                                "limit": self.tr["limits"]["rows_differ"]}}
