"""Times the full-scale `search` of the port on the card, a few runs in one
process:

    python -m gfalign_torch.bench_search [runs]

The workload is synth.make_workload(seed=0) (1,142 segments, 10,000 reads,
one 6-node tangle), searched from 498 to 503 through cli.main.main on CUDA,
as chip_smoke.py's phase 5 does.  Per run it prints the wall, the wall
inside evaluate_candidates (encode, upload, device step, tallies back) and
the frontier calls; the kernels are built before the first run.  To compare
two checkouts, run it from each in turn on one card (it uses only what both
have: the CLI, engine.search.evaluate_candidates and ops.cuda_build).  Needs
a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

from . import synth
from .cli.main import main as cli_main
from .engine import search as search_mod
from .io.writers import write_gfa1
from .ops import cuda_build


def main(runs: int = 3) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_search: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cuda_build.build("nw_path")
    wl = synth.make_workload(seed=0)
    evaluate = search_mod.evaluate_candidates
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        with open(work / "graph.gfa", "w") as fh:
            write_gfa1(wl.graph, fh.write)
        synth.write_truth_gaf(wl, str(work / "truth.gaf"))
        (work / "nodes.tsv").write_text("".join(r + "\n" for r in wl.search_nodelist))
        argv = ["search", "-f", str(work / "graph.gfa"), "-g", str(work / "truth.gaf"),
                "-n", str(work / "nodes.tsv"), "-s", "498", "-d", "503"]
        for run in range(runs):
            calls, inside = [0], [0.0]

            def timed(*args, **kw):
                t = time.perf_counter()
                try:
                    return evaluate(*args, **kw)
                finally:
                    inside[0] += time.perf_counter() - t
                    calls[0] += 1

            search_mod.evaluate_candidates = timed
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    rc = cli_main(argv)
            finally:
                search_mod.evaluate_candidates = evaluate
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"search exited {rc}")
            print(f"run {run}: search wall {wall:.3f} s, inside evaluate_candidates "
                  f"{inside[0]:.3f} s, {calls[0]} frontier calls, "
                  f"{len(out.getvalue().splitlines())} output lines", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
