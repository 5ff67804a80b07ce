"""The port's CLI (`python -m gfalign_torch`, device cpu) against the JAX
package's (`gfalign_tpu.cli.main.main`): stdout and every output file
byte-equal for search, evalPath, filter, subgraph and evalGFA, on a
synthetic assembly workload and on randomized tangles (align has its own
file, tests/test_torch_align.py).  Search and evalPath run on both CPU
scoring routes (`scoring_route`): the plain torch scorer with the Python
search driver, and the default native host scorer with the C++ driver."""

import contextlib
import io
import os
import pathlib
import random
import subprocess
import sys

import pytest

from gfalign_tpu import synth as jax_synth
from gfalign_tpu.cli.main import main as jax_main
from gfalign_tpu.io.writers import write_gfa1 as jax_write_gfa1
from gfalign_torch import synth
from gfalign_torch.cli.main import main as torch_main
from gfalign_torch.io.writers import write_gfa1
from tests.test_search_differential import random_gaf_file, random_tangle
from tests.test_torch_evaluate import scoring_route  # noqa: F401  (fixture)
from tests.test_torch_goldens import port_search_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the default 6-node tangle makes ~7,000 frontier calls, minutes for the
# plain scorer on the CPU; a 4-node tangle keeps the full search to a few
WORKLOAD = dict(seed=0, n_segments=120, n_reads=200, tangle_k=4)


def run_cli(main, argv, cwd, **kw):
    """(exit code, stdout, {file name: bytes} written into cwd)."""
    old_cwd = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            code = main(argv, **kw)
    finally:
        os.chdir(old_cwd)
    files = {p.name: p.read_bytes() for p in pathlib.Path(cwd).iterdir()}
    return code, buf.getvalue(), files


def assert_same_run(tmp_path, argv):
    want = run_cli(jax_main, argv, tmp_path / "jax")
    got = run_cli(torch_main, argv, tmp_path / "torch", device="cpu")
    assert got == want
    return want


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    wl = synth.make_workload(**WORKLOAD)
    paths = port_search_inputs(wl, d)
    paths["filter_nodelist"] = str(d / "filter_nodelist.ls")
    pathlib.Path(paths["filter_nodelist"]).write_text(
        "".join(n + "\n" for n in wl.filter_nodelist))
    return wl, paths


CASES = {
    "search": ["search", "-f", "{gfa}", "-g", "{gaf}", "-n", "{nodes}",
               "-s", "{src}", "-d", "{dst}"],
    "search_all_paths": ["search", "-f", "{gfa}", "-g", "{gaf}", "-n",
                         "{nodes}", "-s", "{src}", "-d", "{dst}",
                         "--return-all-paths"],
    "evalPath": ["evalPath", "-f", "{gfa}", "-g", "{gaf}", "-p", "{path}"],
    "evalPath_stats": ["evalPath", "-f", "{gfa}", "-g", "{gaf}", "-p",
                       "{path}", "--graph-statistics"],
    "filter": ["filter", "-g", "{gaf}", "-n", "{filt}", "-o", "out.gaf"],
    "filter_literal_gaf": ["filter", "-g", "{gaf}", "-n", "{filt}", "-o", "gaf"],
    "subgraph": ["subgraph", "-f", "{gfa}", "-n", "{filt}", "-o", "sub.gfa"],
    "evalGFA": ["evalGFA", "-f", "{gfa}", "-g", "{gaf}", "-o", "decorated.gfa"],
    "evalGFA_stats": ["evalGFA", "-f", "{gfa}", "-g", "{gaf}",
                      "--graph-statistics"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(case, workload, tmp_path, scoring_route):
    wl, paths = workload
    fill = dict(gfa=paths["gfa"], gaf=paths["gaf"],
                nodes=paths["search_nodelist"], filt=paths["filter_nodelist"],
                src=wl.source, dst=wl.destination, path=wl.true_path)
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
    code, out, files = assert_same_run(tmp_path, [a.format(**fill) for a in CASES[case]])
    assert code == 0 and (out or files)
    if case.startswith("search"):
        assert "\t" + wl.true_path + "\n" in out


def _differential(seed, tmp_path):
    rng = random.Random(seed)
    n_nodes = rng.randrange(4, 8)
    graph = random_tangle(rng, n_nodes)
    nodes = tmp_path / "nodes.tsv"
    nodes.write_text("".join(f"{i}\t{rng.randrange(1, 3)}\n"
                             for i in range(2, n_nodes) if rng.random() < 0.8))
    gaf = random_gaf_file(tmp_path, rng, n_nodes, rng.randrange(2, 10), seed)
    gfa = tmp_path / "tangle.gfa"
    with open(gfa, "w") as fh:
        jax_write_gfa1(graph, fh.write)
    argv = ["search", "-f", str(gfa), "-g", gaf, "-n", str(nodes), "-s", "1",
            "-d", str(n_nodes), "-m", "500"]
    if rng.getrandbits(1):
        argv.append("--return-all-paths")
    for sub in ("jax", "torch"):
        (tmp_path / sub).mkdir()
    return assert_same_run(tmp_path, argv)[1]


@pytest.mark.parametrize("seed", range(8))
def test_search_randomized_tangles_match_jax(seed, tmp_path, scoring_route):
    assert _differential(seed, tmp_path)


def test_python_m_entry_point_matches_jax(workload, tmp_path):
    wl, paths = workload
    argv = ["evalPath", "-f", paths["gfa"], "-g", paths["gaf"], "-p", wl.true_path]
    env = dict(os.environ, GFALIGN_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gfalign_torch"] + argv,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (tmp_path / "jax").mkdir()
    assert proc.stdout == run_cli(jax_main, argv, tmp_path / "jax")[1]


@pytest.mark.parametrize("kw", [dict(seed=0, n_segments=120, n_reads=200),
                                dict(seed=5, n_segments=60, n_reads=50,
                                     tangle_k=4, tangle_read_frac=0.5)])
def test_synth_matches_jax(kw, tmp_path):
    """The port's copy of synth.py generates the JAX package's workload."""
    mine, ref = synth.make_workload(**kw), jax_synth.make_workload(**kw)
    assert mine.reads == ref.reads
    for field in ("tangle_nodes", "source", "destination", "search_nodelist",
                  "filter_nodelist", "true_path", "backbone"):
        assert getattr(mine, field) == getattr(ref, field), field
    gfa_mine, gfa_ref = io.StringIO(), io.StringIO()
    write_gfa1(mine.graph, gfa_mine.write)
    jax_write_gfa1(ref.graph, gfa_ref.write)
    assert gfa_mine.getvalue() == gfa_ref.getvalue()
    synth.write_truth_gaf(mine, str(tmp_path / "mine.gaf"))
    jax_synth.write_truth_gaf(ref, str(tmp_path / "ref.gaf"))
    assert (tmp_path / "mine.gaf").read_bytes() == (tmp_path / "ref.gaf").read_bytes()


def test_align_mode_is_not_ported(workload, capsys, monkeypatch):
    """The name is from the slices before align was wholly ported, kept so
    the test's history stays in one place; it now checks that nothing of
    align mode is left unported.  Without reads it falls through into
    evalGFA, as in the JAX package, and exits 0; a distributed align
    (tests/test_torch_dist.py) refuses a shard that is not this process's
    place in the process group."""
    _, paths = workload
    assert torch_main(["align", "-f", paths["gfa"]], device="cpu") == 0
    assert "not yet ported" not in capsys.readouterr().err
    from gfalign_torch.engine.graph_align import run_graph_aligner
    from gfalign_torch.io.gfa import read_gfa

    reads = pathlib.Path(paths["gfa"]).with_name("one.fa")
    reads.write_text(">r\nACGTACGTACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="process group"):
        run_graph_aligner(read_gfa(paths["gfa"]), [str(reads)], "", shard=(0, 2),
                          device="cpu")


def test_distributed_mode_is_a_later_slice(workload, tmp_path, monkeypatch):
    """The name is from the slices before distribution was ported, kept so
    the test's history stays in one place; it now checks that the
    distributed mode no longer raises (tests/test_torch_dist.py runs it
    with several processes): with GFALIGN_TORCH_DISTRIBUTED set but no
    torchrun environment, a run is one process and prints what it prints
    without the variable."""
    wl, paths = workload
    argv = ["evalPath", "-f", paths["gfa"], "-g", paths["gaf"], "-p", wl.true_path]
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    (tmp_path / "one").mkdir()
    (tmp_path / "dist").mkdir()
    want = run_cli(torch_main, argv, tmp_path / "one", device="cpu")
    monkeypatch.setenv("GFALIGN_TORCH_DISTRIBUTED", "1")
    got = run_cli(torch_main, argv, tmp_path / "dist", device="cpu")
    assert got == want and want[0] == 0 and want[1]


def test_threads_flag_sizes_the_native_runtime(workload, tmp_path, monkeypatch):
    from gfalign_torch.io import native

    wl, paths = workload
    calls = []
    set_threads = native.set_threads
    monkeypatch.setattr(native, "set_threads", lambda n: calls.append(n) or set_threads(n))
    try:
        (tmp_path / "torch").mkdir()
        code, out, _ = run_cli(torch_main, ["evalPath", "-f", paths["gfa"], "-g", paths["gaf"],
                                            "-p", wl.true_path, "-j", "3"],
                               tmp_path / "torch", device="cpu")
        assert code == 0 and out
        assert calls == [3] and native.user_threads() == 3
    finally:
        set_threads(0)
