"""The ultra-long align cell (ont_r10.align) at a small size on the CPU: the
quantile reads of ul_reads.py, the align_ul mode end to end through the
program and judged by the reference, and its three readers."""

import ast
import copy
import pathlib

import pytest

from benchmark import common, run, ul_reads, workload
from benchmark.tests.small import GRAPH

HERE = pathlib.Path(__file__).resolve().parents[1]
# reads of 3-8 kb at the configuration's error mix, on small.py's graph
READS = dict(median_len=5000, sigma=0.33, quantiles=6)


def small_ont():
    spec = common.benchmark_spec()
    _, cfg, tr = common.cell_files(spec, "ont_r10.align")
    cfg = copy.deepcopy(cfg)
    cfg["graph"].update(GRAPH)
    cfg["reads"].update(READS, n_reads=READS["quantiles"])
    tr = dict(tr, reads_per_call=READS["quantiles"], check_reads=READS["quantiles"],
              dp_reads=READS["quantiles"], ladder_pairs=8)
    return spec, cfg, tr


def test_quantile_reads_have_their_lengths_and_truth():
    _, cfg, _ = small_ont()
    wl = ul_reads.make(cfg, workload.DATA_SEED)
    want = ul_reads.quantile_lengths(5000, 0.33, 6)
    assert [t.raw_len for t in wl.truth] == want
    assert 3000 <= min(want) and max(want) <= 8000
    assert [len(s) for _, s in wl.reads] == wl.read_lens
    again = ul_reads.make(cfg, workload.DATA_SEED)
    assert again.reads == wl.reads and again.names == wl.names
    full = ul_reads.quantile_lengths(60000, 0.7, 12)
    assert full[0] == 17853 and full[-1] == 201645 and sum(full) == 892751


def test_sampler_and_mode_load_nothing_of_the_program():
    for path in (HERE / "ul_reads.py", HERE / "modes" / "align_ul.py"):
        tree = ast.parse(path.read_text())
        tops = {(n.module or "").split(".", 1)[0] for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level == 0}
        tops |= {a.name.split(".", 1)[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        allowed = {"__future__", "math", "random", "statistics", "typing", "os",
                   "gfalign_torch"} if path.name == "align_ul.py" else {
                   "__future__", "math", "random", "statistics", "typing"}
        assert tops <= allowed, (path, tops)
    # the mode imports the program only inside its functions
    tree = ast.parse((HERE / "modes" / "align_ul.py").read_text())
    assert all(not (isinstance(n, ast.ImportFrom) and n.module
                    and n.module.startswith("gfalign_torch")) for n in tree.body)


@pytest.fixture(scope="module")
def small_run():
    spec, cfg, tr = small_ont()
    args = run.parse(["--workload", "ont_r10.align", "--seed", str(2 ** 33 + 7),
                      "--seconds", "0.5", "--trace", "1"])
    seen = {}
    real = run.mode_module

    def mode_module(name):
        mod = real(name)
        cls = mod.Cell

        class Kept(cls):
            def observations(self, done):
                seen["obs"] = super().observations(done)
                return seen["obs"]
        return type(mod.__name__, (), {"Cell": Kept})

    run.mode_module = mode_module
    try:
        result, checks = run.execute(args, spec, cfg, tr, "cpu")
    finally:
        run.mode_module = real
    return result, checks, seen["obs"]


def test_small_cell_is_correct_on_the_cpu(small_run):
    result, checks, obs = small_run
    assert result["correct"], checks
    assert result["attempted"] >= READS["quantiles"] and result["failed"] == 0
    assert obs["mode"] == "align" and obs["counts"]["align.reads"] >= READS["quantiles"]
    assert "align.traceback" in obs["spans"]


@pytest.mark.parametrize("name", ["align.fallback_ms_per_read",
                                  "align.walk_roofline",
                                  "align.walk_bytes_per_cell"])
def test_new_readers(name, small_run):
    """Numbers from the observations of an align call with walks (the
    small run's, with one on-card walk's counters and trace put in), None
    from empty ones and from a program without the counters."""
    _, _, obs = small_run
    obs = dict(obs, counts=dict(obs["counts"]), spans=dict(obs["spans"]))
    obs["spans"]["align.traceback.full"] = 0.5
    obs["counts"].update({"align.traceback.full_cells": 10 ** 9,
                          "kernels.seqalign.walk_bytes": 5 * 10 ** 6})
    obs["work"] = dict(obs.get("work", {}), walk={"cells": 1e9, "ops": 8e9, "bytes": 1e5})
    obs["slice"] = {"busy_s": 0.1, "window_s": 1.0,
                    "kernels": {"walk_fwd_kernel": 0.04, "walk_trace_kernel": 0.01}}
    reader = common.load_reader(name)
    got = reader.read(obs)
    want = {"align.fallback_ms_per_read": 500.0 / obs["counts"]["align.reads"],
            "align.walk_roofline": 100 * 8e9 / 16.72704e12 / 0.05,
            "align.walk_bytes_per_cell": 0.005}[name]
    assert got == pytest.approx(want, rel=1e-3)
    assert reader.read({}) is None
    assert reader.read({"mode": "align", "reads": 0, "slice": None}) is None
    bare = dict(obs, counts={"align.reads": 6}, spans={}, work={}, slice=None)
    if name == "align.fallback_ms_per_read":
        assert reader.read(bare) == 0.0     # no walk in the window
    else:
        assert reader.read(bare) is None    # nothing to read
