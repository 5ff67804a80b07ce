"""Driver entry points of the port (the counterpart of the repository's
__graft_entry__.py for the JAX package).

entry()              -> (nw_best_scores, example batch): the single-device
                        forward step of the flagship kernel (batched NW
                        path scoring, K1 on CUDA: the compute core of
                        evalGFA, search and evalPath) and the seeded batch
                        it is called with.
dryrun_multichip(n)  -> launches n local ranks (torchrun's environment,
                        gloo, a free port) and checks on each: (a) the
                        two-axis scoring step (parallel/score_step.
                        sharded_scoring_step on the default (data, cand)
                        grid) on the example batch and, at full scale, at
                        the shape of the full-scale search's largest
                        frontier, equal to one process's local_step; (b)
                        one full search with the frontier-sharded
                        evaluator, byte-equal to one process; then (c) one
                        full `align` through the CLI on min(n, 4) ranks,
                        byte-equal to one process.

The JAX dry run drives (b) and (c) on the reference's random2/random3
fixtures, which this repository does not hold, and skips them without
them; the port runs them on synth workloads instead: at full scale the
search of chip_smoke.py phase 5 (make_workload(seed=0), 10,000 reads)
and the align of all its reads, and with full_scale=False a 120-segment
workload of 200 reads and the 10-read align workload of the tests.

    python -m gfalign_torch.dryrun [n] [--cpu] [--small]

Every rank scores on CUDA (card LOCAL_RANK modulo the card count) unless
the caller asks for the CPU.  Each spawn waits DRYRUN_SECONDS at most and
then kills every rank; a rank that exits non-zero or differs fails the dry
run.  The last line printed is `dryrun_multichip(n) OK`.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

DRYRUN_SECONDS = {True: 900, False: 180}   # one spawn's deadline by full_scale
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example_batch(C=4, n=16, R=32, m=16, seed=0):
    rng = np.random.default_rng(seed)
    a_keys = (rng.integers(0, 8, size=(C, n)) * 4
              + rng.integers(0, 2, size=(C, n))).astype(np.int32)
    a_len = np.full((C,), n, dtype=np.int32)
    b_keys = (rng.integers(0, 8, size=(R, m)) * 4
              + rng.integers(0, 2, size=(R, m))).astype(np.int32)
    b_len = np.full((R,), m, dtype=np.int32)
    return a_keys, a_len, b_keys, b_len


def entry(device=None):
    """(nw_best_scores, (a_keys, a_len, b_keys, b_len)): the scorer and the
    example batch as int32 tensors on `device` (default CUDA)."""
    import torch

    from .cli.main import resolve_device
    from .ops.nw_path import nw_best_scores

    dev = resolve_device(device)
    return nw_best_scores, tuple(torch.from_numpy(x).to(dev) for x in _example_batch())


def _write_workloads(work: pathlib.Path, full_scale: bool) -> dict:
    """The search and align inputs of (b) and (c), written into `work`."""
    from . import synth
    from .io.writers import write_gfa1

    if full_scale:
        wl = synth.make_workload(seed=0)
        align_wl, reads = wl, wl.reads
    else:
        wl = synth.make_workload(seed=0, n_segments=120, n_reads=200, tangle_k=4)
        align_wl = synth.make_workload(seed=41, n_segments=120, n_reads=10,
                                       seg_len=(120, 400), read_len=(300, 900),
                                       sub_rate=0.01, ins_rate=0.002, del_rate=0.002)
        reads = align_wl.reads
    spec = {"gfa": str(work / "graph.gfa"), "gaf": str(work / "truth.gaf"),
            "nodes": str(work / "search_nodelist.tsv"), "source": wl.source,
            "destination": wl.destination, "align_gfa": str(work / "align.gfa"),
            "align_reads": str(work / "align.fa"), "align_n_reads": len(reads)}
    with open(spec["gfa"], "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, spec["gaf"])
    pathlib.Path(spec["nodes"]).write_text("".join(r + "\n" for r in wl.search_nodelist))
    with open(spec["align_gfa"], "w") as fh:
        write_gfa1(align_wl.graph, fh.write)
    with open(spec["align_reads"], "w") as fh:
        fh.write("".join(f">{name}\n{seq}\n" for name, seq in reads))
    return spec


def _load_search(spec):
    from .engine.alignments import AlignmentSet
    from .io.gfa import read_gfa

    aln = AlignmentSet()
    aln.load(spec["gaf"])
    return read_gfa(spec["gfa"]), aln


def _one_process(spec, work: pathlib.Path, device, full_scale: bool) -> dict:
    """The one-process search and align that the ranks are held against;
    at full scale the search's largest frontier and its reads are kept
    for (a)."""
    from .cli.main import main as cli_main
    from .engine import evaluate
    from .engine.search import search

    graph, aln = _load_search(spec)
    largest = []

    def recording(candidates, read_batch, filter_alignments=True):
        if not largest or len(candidates) > len(largest[0]):
            largest[:] = [list(candidates), read_batch]
        return evaluate.evaluate_candidates(candidates, read_batch, filter_alignments)

    buf = io.StringIO()
    t0 = time.perf_counter()
    search(graph, aln, spec["nodes"], spec["source"], spec["destination"], out=buf,
           device=device, evaluate_fn=recording if full_scale else None)
    search_s = time.perf_counter() - t0
    (work / "search.out").write_text(buf.getvalue())
    if full_scale:
        a_keys, a_len = evaluate.encode_frontier(largest[0])
        batch = largest[1]
        np.savez(work / "frontier.npz", a_keys=a_keys, a_len=a_len,
                 b_keys=batch.b_keys, b_len=batch.lengths)
    out = work / "align.one.gaf"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["align", "-f", spec["align_gfa"], "-r", spec["align_reads"],
                       "-o", str(out), "-p", "hifi"], device=device)
    if rc != 0:
        raise RuntimeError(f"one-process align exited {rc}")
    return dict(search_s=search_s, search_lines=buf.getvalue().count("\n"),
                align_s=time.perf_counter() - t0,
                align_records=out.read_bytes().count(b"\n"))


def _zero(counters):
    for k in counters:
        counters[k] = 0


def _rank_step(spec, device) -> dict:
    """(a): the two-axis step against one process's local_step."""
    import torch

    from .parallel.score_step import local_step, sharded_scoring_step

    batches = {"example": _example_batch()}
    if spec["full_scale"]:
        z = np.load(pathlib.Path(spec["work"]) / "frontier.npz")
        batches["largest frontier"] = tuple(z[k] for k in ("a_keys", "a_len",
                                                           "b_keys", "b_len"))
    out = {}
    for name, batch in batches.items():
        got = sharded_scoring_step(*batch, device=device)
        want = local_step(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                            for x in batch), filter_alignments=True)
        if not torch.equal(got, want):
            raise RuntimeError(f"two-axis step on the {name} differs from local_step")
        out[name] = dict(C=int(batch[0].shape[0]), n=int(batch[0].shape[1]),
                         R=int(batch[2].shape[0]), m=int(batch[2].shape[1]))
    return out


def _rank_worker(spec_path: str, task: str) -> int:
    """One rank of a dry-run spawn (`python -m gfalign_torch.dryrun --rank
    spec.json search|align`): task "search" runs (a) and (b), "align" runs
    (c) through the CLI; the rank's numbers go to <work>/rank<r>.<task>.json."""
    import torch

    from .cli.main import main as cli_main
    from .engine import graph_align
    from .engine.evaluate import frontier_sharded_evaluator
    from .engine.search import search
    from .ops import nw_cuda, seqalign_cuda
    from .parallel import dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    work = pathlib.Path(spec["work"])
    dist.init_if_requested()
    rank, count = dist.process_info()
    if count != spec["ranks"][task]:
        raise RuntimeError(f"dry run {task}: {count} processes, want {spec['ranks'][task]}")
    device = dist.rank_device(spec["device"])
    res = dict(rank=rank, device=str(device))
    if task == "search":
        _zero(nw_cuda.LAUNCHES)
        res["step"] = _rank_step(spec, device)
        res["step_k1"] = nw_cuda.LAUNCHES["packed"]
        graph, aln = _load_search(spec)
        _zero(nw_cuda.LAUNCHES)
        buf = io.StringIO()
        t0 = time.perf_counter()
        search(graph, aln, spec["nodes"], spec["source"], spec["destination"], out=buf,
               device=device, evaluate_fn=frontier_sharded_evaluator())
        if device.type == "cuda":
            torch.cuda.synchronize()
        res["search_s"] = time.perf_counter() - t0
        res["search_k1"] = nw_cuda.LAUNCHES["packed"]
        if buf.getvalue() != (work / "search.out").read_text():
            raise RuntimeError(f"rank {rank}: frontier-sharded search differs from "
                               f"one process")
    else:
        _zero(seqalign_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["align", "-f", spec["align_gfa"], "-r", spec["align_reads"],
                           "-o", str(work / "align.dist.gaf"), "-p", "hifi"],
                          device=spec["device"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"rank {rank}: align exited {rc}")
        res["align_s"] = time.perf_counter() - t0
        res["align_launches"] = dict(seqalign_cuda.LAUNCHES)
        res["engine"] = graph_align.align_engine(device)
    if device.type == "cuda":       # K1 for (a) and (b), K3 for (c)
        launched = ([res["step_k1"], res["search_k1"]] if task == "search"
                    else [res["align_launches"]["banded"]])
        if not all(launched):
            raise RuntimeError(f"rank {rank}: {task} did not launch its kernel ({res})")
    (work / f"rank{rank}.{task}.json").write_text(json.dumps(res))
    return 0


def _spawn(work: pathlib.Path, task: str, nproc: int, seconds: float) -> list:
    from .parallel import dist

    logs = work / f"logs_{task}"
    logs.mkdir(exist_ok=True)
    got = dist.launch_local(["-m", "gfalign_torch.dryrun", "--rank",
                             str(work / "spec.json"), task], nproc, seconds, logs,
                            cwd=ROOT, env={"PYTHONPATH": str(ROOT)})
    bad = [(rank, rc) for rank, (rc, _, _) in enumerate(got) if rc != 0]
    if bad:
        raise RuntimeError(f"dry run {task} on {nproc} ranks: ranks exited {bad}; "
                           f"stderr tails {[err[-1500:] for _, _, err in got]}")
    return [json.loads((work / f"rank{r}.{task}.json").read_text()) for r in range(nproc)]


def dryrun_multichip(n_devices: int, device=None, full_scale: bool = True) -> dict:
    """Run (a)-(c) on n_devices local ranks (see the module docstring);
    returns what each rank measured.  Raises on the first difference."""
    from .cli.main import resolve_device
    from .parallel.mesh import default_mesh_shape

    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError("dryrun_multichip needs at least one rank")
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gfalign_torch_dryrun_") as tmp:
        work = pathlib.Path(tmp)
        spec = _write_workloads(work, full_scale)
        one = _one_process(spec, work, dev, full_scale)
        print(f"one process on {dev}: search {one['search_lines']} lines in "
              f"{one['search_s']:.2f} s, align {spec['align_n_reads']} reads "
              f"{one['align_records']} records in {one['align_s']:.2f} s", flush=True)
        ranks = {"search": n_devices, "align": min(n_devices, 4)}
        spec.update(work=str(work), device=str(dev), full_scale=full_scale, ranks=ranks)
        (work / "spec.json").write_text(json.dumps(spec))
        seconds = DRYRUN_SECONDS[full_scale]
        t0 = time.perf_counter()
        searched = _spawn(work, "search", ranks["search"], seconds)
        search_wall = time.perf_counter() - t0
        grid = default_mesh_shape(n_devices)
        shapes = "; ".join(f"{k} C={v['C']} n={v['n']} R={v['R']} m={v['m']}"
                           for k, v in searched[0]["step"].items())
        print(f"two-axis step on {n_devices} ranks, grid (data, cand) = {grid}: equal "
              f"to local_step on every rank ({shapes})", flush=True)
        print(f"frontier-sharded search on {n_devices} ranks: byte-equal to one process "
              f"on every rank; walls {[round(r['search_s'], 2) for r in searched]} s, K1 "
              f"launches {[r['search_k1'] for r in searched]}; {search_wall:.1f} s with "
              f"start-up", flush=True)
        t0 = time.perf_counter()
        aligned = _spawn(work, "align", ranks["align"], seconds)
        align_wall = time.perf_counter() - t0
        got = (work / "align.dist.gaf").read_bytes()
        if got != (work / "align.one.gaf").read_bytes():
            raise RuntimeError(f"align on {ranks['align']} ranks differs from one process")
        print(f"align on {ranks['align']} ranks ({aligned[0]['engine']} engine): GAF "
              f"byte-equal to one process ({got.count(chr(10).encode())} records); walls "
              f"{[round(r['align_s'], 2) for r in aligned]} s, K3 launches "
              f"{[r['align_launches']['banded'] for r in aligned]}; {align_wall:.1f} s with "
              f"start-up", flush=True)
    total = time.perf_counter() - t_start
    print(f"dryrun_multichip({n_devices}) OK", flush=True)
    return dict(n=n_devices, grid=grid, device=str(dev), full_scale=full_scale,
                one_process=one, search_ranks=searched, search_wall_s=search_wall,
                align_ranks=aligned, align_wall_s=align_wall, seconds=total)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 3 and argv[0] == "--rank":
        return _rank_worker(argv[1], argv[2])
    flags = {a for a in argv if a.startswith("--")}
    rest = [a for a in argv if not a.startswith("--")]
    if flags - {"--cpu", "--small"} or len(rest) > 1:
        print("usage: python -m gfalign_torch.dryrun [n] [--cpu] [--small]", file=sys.stderr)
        return 2
    dryrun_multichip(int(rest[0]) if rest else 4, device="cpu" if "--cpu" in flags else None,
                     full_scale="--small" not in flags)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
