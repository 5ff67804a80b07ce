"""Times the full-scale `search` of the port on the card, a few runs in one
process:

    python -m gfalign_torch.bench_search [runs]
    python -m gfalign_torch.bench_search --drivers
    python -m gfalign_torch.bench_search --dist

`--drivers` times the two search drivers against each other in turns
(Python driver + K1, C++ driver, C++ driver, Python driver) over read sets
of 249 (the truth GAF through `filter` with the tangle's node list) and
the first 500, 1,000, 2,000, 4,000 and all 10,000 records of the truth
GAF, checks that both print the same bytes, and prints the walls and the
largest read count at which the C++ driver's median is the lower; details
go to chiprun_out/bench_search_drivers.json.

`--dist` times two rank processes on the one card against one process,
all with the Python driver + K1 (`distributed`): the two distributed
evaluators per read set, and the two allreduce transports; details go to
chiprun_out/bench_search_dist.json.

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


DRIVER_SUBSETS = (500, 1000, 2000, 4000, 10000)


def read_sets(work: pathlib.Path, seed: int = 0, subsets=DRIVER_SUBSETS, **workload):
    """Write synth.make_workload(seed)'s graph (graph.gfa), the tangle's
    search node list (nodes.tsv) and its read sets into `work`: the truth
    GAF through `filter` with the tangle's node list (249 reads at the
    default workload) and the truth GAF's first n records for each n of
    `subsets`.  Returns {record count: GAF path}."""
    wl = synth.make_workload(seed=seed, **workload)
    with open(work / "graph.gfa", "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, str(work / "truth.gaf"))
    (work / "nodes.tsv").write_text("".join(r + "\n" for r in wl.search_nodelist))
    (work / "filter.ls").write_text("".join(n + "\n" for n in wl.filter_nodelist))
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(["filter", "-g", str(work / "truth.gaf"), "-n",
                  str(work / "filter.ls"), "-o", str(work / "filtered.gaf")],
                 device="cpu")
    lines = (work / "truth.gaf").read_text().splitlines(keepends=True)
    sets = {sum(1 for line in open(work / "filtered.gaf") if line.strip()):
            work / "filtered.gaf"}
    for n in subsets:
        sets[min(n, len(lines))] = work / f"r{n}.gaf"
        sets[min(n, len(lines))].write_text("".join(lines[:n]))
    return sets


def drivers() -> int:
    """The two drivers in turns over read sets from 249 to 10,000 reads."""
    import json
    import statistics

    from .engine.alignments import AlignmentSet
    from .engine.search import search
    from .io import native
    from .io.gfa import read_gfa

    if not torch.cuda.is_available():
        raise SystemExit("bench_search: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cuda_build.build("nw_path")
    native.build()
    rows = []
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        sets = read_sets(work)
        graph = read_gfa(str(work / "graph.gfa"))
        for n, gaf in sets.items():
            aln = AlignmentSet()
            aln.load(str(gaf))
            walls = {"python": [], "native": []}
            outs = set()
            for use_native in (False, True, True, False):
                buf = io.StringIO()
                t0 = time.perf_counter()
                search(graph, aln, str(work / "nodes.tsv"), "498", "503", out=buf,
                       device="cuda", use_native=use_native)
                torch.cuda.synchronize()
                walls["native" if use_native else "python"].append(time.perf_counter() - t0)
                outs.add(buf.getvalue())
            if len(outs) != 1:
                raise SystemExit(f"bench_search: the drivers differ at R = {aln.count}")
            row = dict(reads=aln.count, python_s=walls["python"], native_s=walls["native"],
                       python_median=statistics.median(walls["python"]),
                       native_median=statistics.median(walls["native"]))
            rows.append(row)
            print(f"R = {aln.count}: Python driver + K1 " + ", ".join(
                f"{w:.4f}" for w in walls["python"]) + " s; C++ driver " + ", ".join(
                f"{w:.4f}" for w in walls["native"]) + " s; same output", flush=True)
    wins = [r["reads"] for r in rows if r["native_median"] < r["python_median"]]
    crossover = max(wins) if wins else 0
    print(f"the C++ driver's median is the lower up to R = {crossover} "
          f"(read counts where it is: {wins})", flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "bench_search_drivers.json").write_text(
        json.dumps(dict(card=card, rows=rows, crossover=crossover), indent=1) + "\n")
    return 0


DIST_SUBSETS = (1000, 2000, 4000, 10000)
DIST_SECONDS = 1500     # deadline of the ranks' spawn


def _timed_search(graph, aln, nodes, device, evaluate_fn=None):
    """One Python-driver search from 498 to 503 with the launch counters
    zeroed, the processes of a distributed run started together: (output,
    wall seconds, K1 launches)."""
    from .engine.search import search
    from .ops import nw_cuda
    from .parallel import dist

    dist.barrier()
    for k in nw_cuda.LAUNCHES:
        nw_cuda.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    search(graph, aln, str(nodes), "498", "503", out=buf, device=device,
           evaluate_fn=evaluate_fn, use_native=False)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0, nw_cuda.LAUNCHES["packed"]


def distributed(nproc: int = 2, device="cuda", subsets=DIST_SUBSETS, **workload) -> int:
    """--dist: one process, then `nproc` rank processes on the one card,
    all with the Python driver + K1, over the post-filter read set and the
    truth GAF's first 1,000 to 10,000 records.  The ranks run each set
    frontier-sharded and read-sharded in turns (frontier, read, read,
    frontier), then the read-sharded search of the largest set and the
    frontier-sharded search of the post-filter set with the allreduce over
    /dev/shm and over gloo in turns (shm, gloo, gloo, shm).  Every output
    must equal the one process's.  A run's wall is its slowest rank's.
    `device`, `subsets` and `workload` (make_workload's arguments) size a
    dry run on the CPU."""
    import json

    from .engine.alignments import AlignmentSet
    from .io.gfa import read_gfa
    from .parallel import dist

    card = "cpu"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_search: no CUDA device")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        cuda_build.build("nw_path")
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        sets = read_sets(work, subsets=subsets, **workload)
        graph = read_gfa(str(work / "graph.gfa"))
        one = {}
        for n, gaf in sets.items():
            aln = AlignmentSet()
            aln.load(str(gaf))
            walls = []
            for _ in range(2):
                out, wall, _ = _timed_search(graph, aln, work / "nodes.tsv", device)
                walls.append(wall)
            (work / f"one{n}.out").write_text(out)
            one[n] = walls
            print(f"R = {n}: one process {walls[0]:.4f}, {walls[1]:.4f} s", flush=True)
        spec = work / "spec.json"
        spec.write_text(json.dumps(dict(
            gfa=str(work / "graph.gfa"), nodes=str(work / "nodes.tsv"), device=str(device),
            sets=[[n, str(g), str(work / f"one{n}.out")] for n, g in sets.items()])))
        got = dist.launch_local(["-m", "gfalign_torch.bench_search", "--dist-rank", spec],
                                nproc, DIST_SECONDS, work)
    bad = [(rank, rc, err[-1500:]) for rank, (rc, _, err) in enumerate(got) if rc]
    if bad:
        raise SystemExit(f"bench_search --dist: ranks failed {bad}")
    ranks = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in got]

    def slowest(key, i, kind):
        return [max(r[key][i][kind][t] for r in ranks)
                for t in range(len(ranks[0][key][i][kind]))]

    rows = []
    for i, (n, walls) in enumerate(one.items()):
        row = dict(reads=n, one_process=walls, frontier=slowest("sets", i, "frontier"),
                   read=slowest("sets", i, "read"),
                   k1_launches=[r["sets"][i]["k1"] for r in ranks])
        rows.append(row)
        print(f"R = {n}, {nproc} ranks (slowest rank): frontier-sharded "
              + ", ".join(f"{w:.4f}" for w in row["frontier"]) + " s; read-sharded "
              + ", ".join(f"{w:.4f}" for w in row["read"]) + " s; one process "
              + ", ".join(f"{w:.4f}" for w in walls) + f" s; K1 launches by rank "
              f"{row['k1_launches']}; same output", flush=True)
    transports = []
    for i, t in enumerate(ranks[0]["transports"]):
        row = dict(reads=t["reads"], sharding=t["sharding"],
                   shm=slowest("transports", i, "shm"), gloo=slowest("transports", i, "gloo"))
        transports.append(row)
        print(f"R = {row['reads']}, {row['sharding']}-sharded: allreduce over /dev/shm "
              + ", ".join(f"{w:.4f}" for w in row["shm"]) + " s; over gloo "
              + ", ".join(f"{w:.4f}" for w in row["gloo"]) + " s; same output", flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "bench_search_dist.json").write_text(json.dumps(
        dict(card=card, nproc=nproc, rows=rows, transports=transports, ranks=ranks),
        indent=1) + "\n")
    return 0


def dist_rank(spec_path: str) -> int:
    """One rank of --dist (spawned by `distributed`): prints its walls as
    one JSON line."""
    import json

    from .engine.alignments import AlignmentSet
    from .engine.evaluate import distributed_evaluator, frontier_sharded_evaluator
    from .io.gfa import read_gfa
    from .parallel import dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    dist.init_if_requested()
    pid, count = dist.process_info()
    device = dist.rank_device(spec["device"])
    graph = read_gfa(spec["gfa"])
    loaded = {}
    for n, gaf, _ in spec["sets"]:
        full, shard = AlignmentSet(), AlignmentSet()
        full.load(gaf)
        shard.load(gaf, shard=(pid, count), shard_by="qname")
        loaded[n] = (full, shard)

    def run(n, kind):
        full, shard = loaded[n]
        want = pathlib.Path(next(o for m, _, o in spec["sets"] if m == n)).read_text()
        aln, fn = ((full, frontier_sharded_evaluator()) if kind == "frontier"
                   else (shard, distributed_evaluator()))
        out, wall, k1 = _timed_search(graph, aln, spec["nodes"], device, fn)
        if out != want:
            raise SystemExit(f"rank {pid}: {kind}-sharded search of {n} reads differs")
        return wall, k1

    res = dict(rank=pid, device=str(device), sets=[], transports=[])
    for n, _, _ in spec["sets"]:
        walls = {"frontier": [], "read": []}
        for kind in ("frontier", "read", "read", "frontier"):
            wall, k1 = run(n, kind)
            walls[kind].append(wall)
        res["sets"].append(dict(reads=n, k1=k1, **walls))
    shm = dist._shm_exchange()
    if shm:
        sizes = [n for n, _, _ in spec["sets"]]
        for n, kind in ((max(sizes), "read"), (min(sizes), "frontier")):
            walls = {"shm": [], "gloo": []}
            for transport in ("shm", "gloo", "gloo", "shm"):
                dist._SHM[0] = shm if transport == "shm" else False
                walls[transport].append(run(n, kind)[0])
            dist._SHM[0] = shm
            res["transports"].append(dict(reads=n, sharding=kind, **walls))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--drivers"]:
        raise SystemExit(drivers())
    if sys.argv[1:] == ["--dist"]:
        raise SystemExit(distributed())
    if sys.argv[1:2] == ["--dist-rank"]:
        raise SystemExit(dist_rank(sys.argv[2]))
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
