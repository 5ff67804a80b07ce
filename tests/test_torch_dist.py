"""Multi-process distribution of the port (gfalign_torch/parallel/dist.py
and what it reaches) on the CPU: real rank processes on a gloo process
group over 127.0.0.1, as torchrun would launch them, each against the
port's one-process run and, where the JAX package is importable, against
gfalign_tpu's one-process run on the same files.

Nothing here imports jax at module level: the file runs on a machine
without it (`pytest --noconftest`), and the comparisons with gfalign_tpu
import it inside the test after `pytest.importorskip("jax")`.  Every spawn
waits with a deadline and kills all of its ranks when it passes.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import random
import socket
import subprocess
import sys
import time

import pytest

from gfalign_torch import synth
from gfalign_torch.cli.main import main as torch_main
from gfalign_torch.engine.alignments import AlignmentSet
from gfalign_torch.engine import search as search_mod
from gfalign_torch.engine.search import search
from gfalign_torch.io.gfa import read_gfa
from gfalign_torch.parallel import dist
from gfalign_torch.utils.fmt import cout
from tests.test_torch_goldens import port_search_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPAWN_SECONDS = 90          # one spawn's deadline, all ranks together
SHORT_WAIT = 3              # GFALIGN_TORCH_DIST_TIMEOUT where a wait must expire


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(tmp_path, nproc, body, args=(), port=None, env=None,
          module=False, timeout=SPAWN_SECONDS):
    """Run `body` (a Python script, or with module=True the arguments of
    `python -m gfalign_torch`) as `nproc` ranks of one gloo group on
    127.0.0.1; returns [(returncode, stdout, stderr)] by rank.  Every rank
    is killed when the deadline passes, and the test fails.  A free port
    taken by another process before rank 0 binds it is retried on a new
    one."""
    for _ in range(3):
        results = _spawn_once(tmp_path, nproc, body, args, port or free_port(), env,
                              module, timeout)
        if port or not any("EADDRINUSE" in err or "Address already in use" in err
                           for _, _, err in results):
            break
    return results


def _spawn_once(tmp_path, nproc, body, args, port, env, module, timeout):
    script = tmp_path / f"rank_{port}.py"
    if module:
        cmd = ["-m", "gfalign_torch", *body]
    else:
        script.write_text(f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n" + body)
        cmd = [str(script), *map(str, args)]
    procs, files = [], []
    for rank in range(nproc):
        out = open(tmp_path / f"rank{rank}_{port}.out", "w+")
        err = open(tmp_path / f"rank{rank}_{port}.err", "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, *cmd], stdout=out, stderr=err, cwd=tmp_path,
            env={**os.environ, "PYTHONPATH": str(ROOT), "GFALIGN_TORCH_DEVICE": "cpu",
                 "GFALIGN_TORCH_DISTRIBUTED": "1", "RANK": str(rank),
                 "LOCAL_RANK": str(rank), "WORLD_SIZE": str(nproc),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "GLOO_SOCKET_IFNAME": "lo", "GFALIGN_TORCH_DIST_TIMEOUT": "60",
                 **(env or {})}))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{nproc} ranks still running after {timeout} s: "
                             + repr([_read(f[1])[-600:] for f in files]))
    results = []
    for p, (out, err) in zip(procs, files):
        results.append((p.returncode, _read(out), _read(err)))
    return results


def _read(fh) -> str:
    fh.seek(0)
    text = fh.read()
    fh.close()
    return text


def ok(results):
    """Every rank exited 0; returns the stdouts."""
    bad = [(rank, rc, err[-800:]) for rank, (rc, _, err) in enumerate(results) if rc != 0]
    assert not bad, bad
    return [out for _, out, _ in results]


def frames(text: str):
    """Sections of a rank's stdout written as '@@ name\\n<body>'."""
    out = {}
    for part in text.split("@@ ")[1:]:
        name, _, body = part.partition("\n")
        out[name] = body
    return out


# ------------------------------------------------------------------ inputs

def tangle_inputs(d, n_tangle_reads=60, tangle_k=4, seed=5):
    """The small synth workload of the port's goldens (port_search_inputs:
    make_workload(seed=0, n_segments=120, n_reads=200, tangle_k=4)), its
    truth GAF, and a GAF of reads that walk inside the tangle only, so the
    search's tallies are not all zero.  Returns (workload, paths)."""
    wl = synth.make_workload(seed=0, n_segments=120, n_reads=200, tangle_k=tangle_k)
    paths = port_search_inputs(wl, d)
    lo, hi = int(wl.source), int(wl.destination)
    rng = random.Random(seed)
    lines = []
    for i in range(n_tangle_reads):
        steps = "".join(rng.choice("><") + str(rng.randrange(lo, hi + 1))
                        for _ in range(rng.randrange(1, 6)))
        lines.append(f"t{i:05d}\t50\t0\t50\t+\t{steps}\t50\t0\t50\t50\t50\t60")
    paths["tangle_gaf"] = str(pathlib.Path(d) / "tangle.gaf")
    pathlib.Path(paths["tangle_gaf"]).write_text("\n".join(lines) + "\n")
    return wl, paths


def port_search(paths, gaf, source, dest, **kw):
    buf = io.StringIO()
    aln = AlignmentSet()
    aln.load(gaf)
    search(read_gfa(paths["gfa"]), aln, paths["search_nodelist"], source, dest,
           out=buf, device="cpu", **kw)
    return buf.getvalue()


def jax_search(paths, gaf, source, dest, **kw):
    pytest.importorskip("jax")
    from gfalign_tpu.engine.alignments import AlignmentSet as JaxSet
    from gfalign_tpu.engine.search import search as jax_search_fn
    from gfalign_tpu.io.gfa import read_gfa as jax_read_gfa

    buf = io.StringIO()
    aln = JaxSet()
    aln.load(gaf)
    jax_search_fn(jax_read_gfa(paths["gfa"]), aln, paths["search_nodelist"],
                  source, dest, out=buf, **kw)
    return buf.getvalue()


# ------------------------------------------------------- one process, units

def test_shard_records_partition():
    recs = list(range(23))
    shards = [list(dist.shard_records(recs, p, 4)) for p in range(4)]
    assert sorted(sum(shards, [])) == recs
    assert all(s == recs[p::4] for p, s in enumerate(shards))
    assert list(dist.shard_records(recs)) == recs       # one process: all


def test_one_process_collectives_are_the_identity(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GFALIGN_TORCH_DISTRIBUTED", "1")
    dist.init_if_requested()                 # no torchrun environment: nothing
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    dist.init_if_requested()                 # one process: nothing either
    import torch.distributed as td

    assert not td.is_initialized()
    assert dist.process_info() == (0, 1)
    assert dist.allreduce_stats([3, 2 ** 45, -1]) == [3, 2 ** 45, -1]
    assert dist.allgather_bytes(b"abc") == [b"abc"]
    assert dist.local_process_count() == 1
    assert dist.rank_device("cpu").type == "cpu"


def test_rank_device_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.rank_device("cuda")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_search_default_driver_keeps_cuda_scoring_on_the_card(tmp_path, monkeypatch, device):
    """`search(use_native=None)` takes the C++ driver, which scores on the
    host, only on the CPU; asked for CUDA it runs the Python driver, whose
    frontiers go to evaluate_candidates (K1), whatever the read count.
    Both scorers are stubs here, so no card is needed."""
    wl, paths = tangle_inputs(tmp_path)
    native_calls, frontier_calls = [], []
    monkeypatch.setattr(search_mod, "_native_search",
                        lambda *a, **k: native_calls.append(1) or True)

    def frontier(candidates, read_batch, filter_alignments=True):
        frontier_calls.append(read_batch.device.type)
        return [search_mod.evaluate.PathScore() for _ in candidates]

    monkeypatch.setattr(search_mod, "evaluate_candidates", frontier)
    aln = AlignmentSet()
    aln.load(paths["tangle_gaf"])
    search(read_gfa(paths["gfa"]), aln, paths["search_nodelist"], wl.source,
           wl.destination, out=io.StringIO(), device=device, max_steps=5)
    if device == "cpu":
        assert native_calls == [1] and not frontier_calls
    else:
        assert not native_calls and frontier_calls and set(frontier_calls) == {"cuda"}


# ------------------------------------------------------------- collectives

COLLECTIVES = """
import time
from gfalign_torch.parallel import dist
mode = sys.argv[1]
dist.init_if_requested()
pid, n = dist.process_info()
if mode == "gloo" and pid == n - 1:
    def refuse(*a, **k):
        raise OSError("no /dev/shm here")
    dist._ShmExchange = refuse
big = 2 ** 40 + 7
got = dist.allreduce_stats([pid + 1, big * (pid + 1), -pid])
assert got == [n * (n + 1) // 2, big * n * (n + 1) // 2, -n * (n - 1) // 2], got
wide = dist.allreduce_stats(list(range(pid, pid + 9000)))
assert wide == [n * i + n * (n - 1) // 2 for i in range(9000)], wide[:4]
assert dist.allreduce_stats([]) == []
payload = b"" if pid == 0 else bytes([pid]) * (1000 * pid + 3)
parts = dist.allgather_bytes(payload)
assert parts == [b""] + [bytes([p]) * (1000 * p + 3) for p in range(1, n)], [len(p) for p in parts]
assert dist.allgather_bytes(b"") == [b""] * n
assert dist.local_process_count() == n
print("transport", "shm" if dist._SHM[0] else "gloo")
"""


@pytest.mark.parametrize("nproc,transport", [(2, "shm"), (2, "gloo"), (4, "shm"), (4, "gloo")])
def test_collectives_are_exact_over_each_transport(tmp_path, nproc, transport):
    """Sums exact past 2**40, vectors longer than one shm round, empty and
    unequal gathers; when one rank cannot map /dev/shm every rank agrees
    on gloo, and rank 0 logs the choice."""
    results = spawn(tmp_path, nproc, COLLECTIVES, [transport])
    outs = ok(results)
    assert all(o.split() == ["transport", transport] for o in outs), outs
    shm = "/dev/shm" if transport == "shm" else "gloo"
    assert f"{nproc} processes: allreduce over {shm}" in results[0][2]


def test_shm_exchange_ignores_a_stale_file(tmp_path):
    """A /dev/shm file left by a crashed run on the same address holds
    poisoned sequence cells: rank 0 recreates it with O_TRUNC, so they
    never satisfy a wait."""
    port = free_port()
    stale = pathlib.Path(f"/dev/shm/gfalign_torch_ar_127_0_0_1_{port}")
    stale.write_bytes(b"\x7f" * (8 * (1 + 2 * 2 * (2 + dist._ShmExchange.WIDTH))))
    try:
        outs = ok(spawn(tmp_path, 2, """
from gfalign_torch.parallel import dist
dist.init_if_requested()
pid, _ = dist.process_info()
for rep in range(3):
    got = dist.allreduce_stats([10 + pid, 100 * (pid + 1)])
    assert got == [21, 300], got
print("OK", bool(dist._SHM[0]))
""", port=port))
        assert outs == ["OK True\n", "OK True\n"]
    finally:
        stale.unlink(missing_ok=True)


MISSING_PEER = """
import time
from gfalign_torch.parallel import dist
from gfalign_torch.engine.evaluate import frontier_sharded_evaluator
from gfalign_torch.engine.search import search
from gfalign_torch.engine.alignments import AlignmentSet
from gfalign_torch.io.gfa import read_gfa
case, gfa, gaf, nodes, src, dst = sys.argv[1:7]
dist.init_if_requested()
pid, _ = dist.process_info()
t0 = time.monotonic()
if pid == 1:
    if case == "shm":
        dist._shm_exchange()
    if case == "ring":
        ring = dist._shm_ring()
        ring.reset_local()
        dist.barrier()
    time.sleep(1)
    sys.exit(0)
try:
    if case == "shm":
        dist._shm_exchange()
        dist.allreduce_stats([1])
    elif case == "store":
        dist._shm_exchange()
    elif case == "gather":
        dist.allgather_bytes(b"done")
    else:
        aln = AlignmentSet()
        aln.load(gaf)
        search(read_gfa(gfa), aln, nodes, src, dst, device="cpu", use_native=True,
               evaluate_fn=frontier_sharded_evaluator())
except RuntimeError as exc:
    print("RAISED", round(time.monotonic() - t0, 1), exc)
else:
    print("NO ERROR")
"""


@pytest.mark.parametrize("case", ["shm", "store", "ring", "gather"])
def test_a_wait_for_a_missing_rank_raises_within_its_deadline(tmp_path, case):
    """Rank 1 leaves: the /dev/shm allreduce, the store handshake, the
    native driver's ring and the gather that ends a run (once rank 1's
    heartbeat stops) each raise on rank 0 after the deadline, naming rank
    1, instead of waiting forever."""
    _, paths = tangle_inputs(tmp_path)
    t0 = time.monotonic()
    outs = ok(spawn(tmp_path, 2, MISSING_PEER,
                    [case, paths["gfa"], paths["tangle_gaf"], paths["search_nodelist"],
                     "59", "62"], env={"GFALIGN_TORCH_DIST_TIMEOUT": str(SHORT_WAIT)}))
    assert outs[0].startswith("RAISED"), outs
    assert "rank 1" in outs[0], outs
    assert float(outs[0].split()[1]) < SHORT_WAIT + 10
    assert time.monotonic() - t0 < 60


SLOW_PEER = """
import time
from gfalign_torch.parallel import dist
dist.init_if_requested()
pid, n = dist.process_info()
time.sleep(float(sys.argv[1]) * pid)         # the last rank's shard takes longest
t0 = time.monotonic()
parts = dist.allgather_bytes(bytes([65 + pid]) * (pid + 1))
assert parts == [bytes([65 + p]) * (p + 1) for p in range(n)], parts
parts = dist.allgather_bytes(b"")
assert parts == [b""] * n, parts
print("waited", round(time.monotonic() - t0, 1))
"""


@pytest.mark.parametrize("nproc", [2, 3])
def test_the_gather_that_ends_a_run_waits_for_a_slow_live_rank(tmp_path, nproc):
    """The last rank reaches the gather 3x the deadline after rank 0
    (each later rank is slower): the end-of-run gather waits for it while
    it beats, and every rank gets every blob."""
    outs = ok(spawn(tmp_path, nproc, SLOW_PEER, [SHORT_WAIT * 3 / (nproc - 1)],
                    env={"GFALIGN_TORCH_DIST_TIMEOUT": str(SHORT_WAIT)}))
    assert float(outs[0].split()[1]) >= SHORT_WAIT * 3 - 1, outs


# ------------------------------------------------------------------ search

SEARCH = """
import io
from gfalign_torch.parallel import dist
from gfalign_torch.engine.alignments import AlignmentSet
from gfalign_torch.engine.evaluate import distributed_evaluator, frontier_sharded_evaluator
from gfalign_torch.engine.search import search
from gfalign_torch.io.gfa import read_gfa
sharding, gfa, nodes, src, dst = sys.argv[1:6]
gafs = sys.argv[6:]
extra = dict(max_steps=50) if sharding == "star" else {}
dist.init_if_requested()
pid, n = dist.process_info()
graph = read_gfa(gfa)
aln = AlignmentSet()
if len(gafs) > 1:                       # one file a rank: shards of any balance
    aln.load(gafs[pid])
elif sharding == "frontier":
    aln.load(gafs[0])
else:
    aln.load(gafs[0], shard=(pid, n), shard_by="qname")
for driver in ("python", "native"):
    evaluate_fn = (frontier_sharded_evaluator() if sharding == "frontier"
                   else distributed_evaluator())
    buf = io.StringIO()
    search(graph, aln, nodes, src, dst, out=buf, device="cpu",
           use_native=driver == "native", evaluate_fn=evaluate_fn, **extra)
    print("@@ " + driver)
    print(buf.getvalue(), end="")
"""


@pytest.mark.parametrize("nproc,sharding", [(2, "frontier"), (2, "read"),
                                            (4, "frontier"), (4, "read")])
def test_distributed_search_matches_one_process(tmp_path, nproc, sharding):
    """Frontier-sharded (reads replicated) and read-sharded (qname shards)
    search, each by the Python driver and by the C++ driver over the
    /dev/shm ring (frontier mode, sum mode): every rank prints the bytes
    of the port's one-process run and of gfalign_tpu's."""
    wl, paths = tangle_inputs(tmp_path)
    want = port_search(paths, paths["tangle_gaf"], wl.source, wl.destination)
    assert want.count("\n") >= 3 and any(line.split("\t")[2] != "0"
                                         for line in want.splitlines())
    outs = ok(spawn(tmp_path, nproc, SEARCH,
                    [sharding, paths["gfa"], paths["search_nodelist"], wl.source,
                     wl.destination, paths["tangle_gaf"]]))
    for out in outs:
        assert frames(out) == {"python": want, "native": want}
    assert jax_search(paths, paths["tangle_gaf"], wl.source, wl.destination) == want


def test_read_shards_straddling_512_speculate_alike(tmp_path):
    """Two ranks with 600 and 100 reads: speculation width and driver are
    chosen from the summed read count (700), not the shard's, so both
    ranks make the same frontier calls and finish, byte-equal to one
    process holding all 700 reads.  (On the 5-node tangle the widths for
    600 and 100 reads, 64 and 256, give frontiers of other sizes from the
    seventh call on.)"""
    wl, paths = tangle_inputs(tmp_path, n_tangle_reads=700, tangle_k=5)
    lines = pathlib.Path(paths["tangle_gaf"]).read_text().splitlines(keepends=True)
    parts = [tmp_path / "part0.gaf", tmp_path / "part1.gaf"]
    parts[0].write_text("".join(lines[:600]))
    parts[1].write_text("".join(lines[600:]))
    want = port_search(paths, paths["tangle_gaf"], wl.source, wl.destination)
    outs = ok(spawn(tmp_path, 2, SEARCH,
                    ["read", paths["gfa"], paths["search_nodelist"], wl.source,
                     wl.destination, *parts]))
    for out in outs:
        assert frames(out) == {"python": want, "native": want}


def test_ring_sum_mode_chunks_an_out_degree_above_one_slot(tmp_path):
    """A pop with 6,000 expansions exceeds one ring slot (16,384 / 3
    tallies): the read-sharded C++ driver chunks it over ring batches and
    stays byte-equal to one process (and to gfalign_tpu)."""
    n_mid = 6000
    gfa = tmp_path / "star.gfa"
    with open(gfa, "w") as fh:
        fh.write("S\ts\tACGTACGT\nS\td\tACGTACGT\n")
        fh.writelines(f"S\tm{i}\tACGT\n" for i in range(n_mid))
        for i in range(n_mid):
            fh.write(f"L\ts\t+\tm{i}\t+\t0M\nL\tm{i}\t+\td\t+\t0M\n")
    nodes = tmp_path / "nodes.tsv"
    nodes.write_text("s\t1\nd\t1\n" + "".join(f"m{i}\t1\n" for i in range(n_mid)))
    gaf = tmp_path / "reads.gaf"
    gaf.write_text("".join(f"q{k}\t16\t0\t16\t+\t>s>m{k * 7}>d\t16\t0\t16\t16\t16\t60\n"
                           for k in range(6)))
    paths = {"gfa": str(gfa), "search_nodelist": str(nodes)}
    want = port_search(paths, str(gaf), "s", "d", max_steps=50)
    assert want.strip()
    outs = ok(spawn(tmp_path, 2, SEARCH, ["star", str(gfa), str(nodes), "s", "d", str(gaf)]))
    for out in outs:
        assert frames(out) == {"python": want, "native": want}
    assert jax_search(paths, str(gaf), "s", "d", max_steps=50) == want


# ------------------------------------------------- duplicate marking, CLI

def random_gaf_lines(rng, n_names=60, dup_frac=0.5):
    """GAF lines whose qnames repeat (duplicate runs, singletons between
    them) and whose path ends sit at, or near, the path's ends."""
    lines = []
    for i in range(n_names):
        name = f"r{rng.randrange(10 ** 6):06d}"
        for _ in range(rng.randrange(2, 4) if rng.random() < dup_frac else 1):
            plen = rng.choice([300, 1000, 5000])
            pstart = rng.choice([0, 3, rng.randrange(plen)])
            pend = rng.choice([plen - 1, min(plen, pstart + rng.randrange(1, 900))])
            qs = rng.randrange(0, 400)
            lines.append(f"{name}\t900\t{qs}\t{qs + 400}\t{rng.choice('+-')}\t>n{i % 7}"
                         f"\t{plen}\t{pstart}\t{max(pend, pstart)}\t300\t400\t60")
    rng.shuffle(lines)
    return lines


DUPS = """
import io
from gfalign_torch.parallel import dist
from gfalign_torch.engine.alignments import AlignmentSet
dist.init_if_requested()
pid, n = dist.process_info()
a = AlignmentSet()
a.load(sys.argv[1], terminal_flag=True, shard=(pid, n), shard_by="qname")
a.sort_by_name()
buf = io.StringIO()
a.mark_duplicates_distributed(buf)
a.merge_distributed(dup_counts=False)
a.print_stats(buf)
print(buf.getvalue(), end="")
"""


@pytest.mark.parametrize("nproc", [2, 4])
def test_distributed_duplicate_marking_is_exact(tmp_path, nproc):
    """qname shards: duplicate marking over the gathered metadata (the
    reference's cross-group scratch leak included), terminal pairs printed
    from their owners, and the summed totals print the one-process stats."""
    rng = random.Random(77 + nproc)
    lines = random_gaf_lines(rng)
    for k in range(4):     # terminal pairs: one mate at the path's end, one at its head
        lines.append(f"t{k:02d}\t900\t0\t400\t+\t>n1\t1000\t700\t999\t10\t12\t60")
        lines.append(f"t{k:02d}\t900\t450\t900\t+\t>n2\t1000\t3\t450\t10\t12\t60")
    gaf = tmp_path / "dup.gaf"
    gaf.write_text("\n".join(lines) + "\n")
    cout.reset()     # each rank starts with std::cout's default float mode; so does this run
    one = AlignmentSet()
    one.load(str(gaf), terminal_flag=True)
    one.sort_by_name()
    want = io.StringIO()
    one.mark_duplicates(want)
    one.print_stats(want)
    assert one.terminal_supplementary >= 3 and one.supplementary > 0
    outs = ok(spawn(tmp_path, nproc, DUPS, [gaf]))
    assert outs == [want.getvalue()] * nproc


def run_cli(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue()


@pytest.mark.parametrize("case", ["evalGFA", "evalGFA-terminal", "search", "filter"])
def test_cli_runs_distributed(tmp_path, case):
    """`python -m gfalign_torch` as two ranks: rank 0 prints (and writes)
    the bytes of the port's one-process CLI run and of gfalign_tpu's, rank
    1 prints nothing.  `filter` writes the whole record set, so it runs on
    rank 0 alone."""
    wl, paths = tangle_inputs(tmp_path)
    written = tmp_path / "filtered.gaf"
    if case == "search":
        argv = ["search", "-f", paths["gfa"], "-g", paths["tangle_gaf"], "-n",
                paths["search_nodelist"], "-s", wl.source, "-d", wl.destination]
    elif case == "filter":
        argv = ["filter", "-g", paths["gaf"], "-n", paths["filter_nodelist"],
                "-o", str(written)]
    else:
        gaf = tmp_path / "dup.gaf"
        gaf.write_text("\n".join(random_gaf_lines(random.Random(3))) + "\n")
        argv = ["evalGFA", "-g", str(gaf)]
        if case == "evalGFA-terminal":
            argv.append("--output-terminal-alignments")
    def run(fn):
        text = fn()
        data = written.read_bytes() if written.exists() else None
        written.unlink(missing_ok=True)
        return text, data

    want = run(lambda: run_cli(torch_main, argv, device="cpu"))
    assert want[0] and (want[1] is not None) == (case == "filter")
    got = run(lambda: ok(spawn(tmp_path, 2, argv, module=True)))
    assert got == ([want[0], ""], want[1])
    pytest.importorskip("jax")
    from gfalign_tpu.cli.main import main as jax_main

    assert run(lambda: run_cli(jax_main, argv)) == want


# ------------------------------------------------------------------- align

ALIGN = """
from gfalign_torch.cli.main import main
from gfalign_torch.io import native
assert main(["align", "-f", sys.argv[1], "-r", sys.argv[2], "-o", sys.argv[3]],
            device="cpu") == 0
print("threads", native.user_threads())
"""

SEEDED = dict(n_segments=120, seg_len=(120, 400), read_len=(300, 900),
              sub_rate=0.01, ins_rate=0.002, del_rate=0.002)


@pytest.mark.parametrize("nproc,n_reads", [(2, 10), (3, 10), (3, 2)])
def test_distributed_align_matches_one_process(tmp_path, nproc, n_reads, monkeypatch):
    """Reads sharded by index (3 ranks: uneven shards; 2 reads: a rank
    with none): rank 0 writes the one-process GAF, equal to gfalign_tpu's
    default engine (the host ladder, the port's ladder on the CPU), and
    every rank's native thread cap is back at its default afterwards."""
    wl = synth.make_workload(seed=41, n_reads=n_reads, **SEEDED)
    paths = synth.write_workload(wl, str(tmp_path / "wl"))
    single = tmp_path / "single.gaf"
    run_cli(torch_main, ["align", "-f", paths["gfa"], "-r", paths["reads"],
                         "-o", str(single)], device="cpu")
    assert single.read_bytes().count(b"\n") >= n_reads
    got = tmp_path / "dist.gaf"
    outs = ok(spawn(tmp_path, nproc, ALIGN, [paths["gfa"], paths["reads"], got]))
    assert all(o.splitlines()[-1] == "threads 0" for o in outs), outs
    assert got.read_bytes() == single.read_bytes()
    pytest.importorskip("jax")
    from gfalign_tpu.cli.main import main as jax_main

    monkeypatch.delenv("GFALIGN_TPU_ALIGN_DEVICE", raising=False)
    jax_gaf = tmp_path / "jax.gaf"
    run_cli(jax_main, ["align", "-f", paths["gfa"], "-r", paths["reads"], "-o", str(jax_gaf)])
    assert jax_gaf.read_bytes() == single.read_bytes()
