"""The span and counter registry (gfalign_torch/utils/profiling.py) and the
spans and counters the port records on the CPU: totals, nesting and
snapshot deltas; the modules' old counter dicts as views of the registry;
no profiler range opened while no profiler records; the spans in
torch.profiler's events as CPU ranges, nested by layer, around the work
they name; the seeding spans against the seeding phase, the candidate and
traceback counters of a seeded align, and the search driver's frontier
counters, with stdout unchanged."""

import contextlib
import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gfalign_torch import synth
from gfalign_torch.cli.main import main
from gfalign_torch.engine import evaluate, graph_align, seeding
from gfalign_torch.engine import search as search_mod
from gfalign_torch.io.fastq import load_reads
from gfalign_torch.io import gfa
from gfalign_torch.io.gfa import read_gfa
from gfalign_torch.ops import nw_cuda, seqalign, seqalign_cuda
from gfalign_torch.utils import profiling
from gfalign_torch.utils.log import lg
from tests.test_torch_goldens import port_search_inputs

SEEDED = dict(n_segments=120, n_reads=10, seg_len=(120, 400),
              read_len=(300, 900), sub_rate=0.01, ins_rate=0.002,
              del_rate=0.002)


@pytest.fixture(scope="module")
def align_argv(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    paths = synth.write_workload(synth.make_workload(seed=41, **SEEDED), str(d))
    return ["align", "-f", paths["gfa"], "-r", paths["reads"], "-o",
            str(d / "out.gaf")]


@pytest.fixture(scope="module")
def search_argv(tmp_path_factory):
    d = tmp_path_factory.mktemp("search")
    wl = synth.make_workload(seed=0, n_segments=40, n_reads=60, tangle_k=4)
    paths = port_search_inputs(wl, d)
    return ["search", "-f", paths["gfa"], "-g", paths["gaf"], "-n",
            paths["search_nodelist"], "-s", wl.source, "-d", wl.destination,
            "--return-all-paths"]


@pytest.fixture
def python_driver(monkeypatch):
    """The search's Python driver with the device step (its plain version
    here), as on a card: the CPU would take the C++ driver and the native
    frontier scorer."""
    real = search_mod.search

    def search(*a, **kw):
        kw["use_native"] = False
        return real(*a, **kw)

    monkeypatch.setattr(search_mod, "search", search)
    monkeypatch.setattr(evaluate, "native_scoring_ok", lambda device: False)


def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, device="cpu") == 0
    return buf.getvalue()


def profiled(fn):
    """fn() under a CPU torch.profiler; (its result, the profiler's events
    as (name, start ns, end ns, user annotation))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return got, events


def inside(events, child, parent):
    """Whether every `child` event lies inside some `parent` event."""
    outer = [(s, e) for n, s, e, _ in events if n == parent]
    kids = [(s, e) for n, s, e, _ in events if n == child]
    return bool(kids) and all(any(ps <= s and e <= pe for ps, pe in outer)
                              for s, e in kids)


def test_registry_totals_nesting_and_snapshot_deltas():
    before = profiling.snapshot()
    with profiling.span("test.outer"):
        for _ in range(3):
            with profiling.span("test.inner"):
                sum(range(1000))
        with profiling.span("test.paused") as paused:
            with paused.paused():
                sum(range(1000))
    profiling.count("test.items", 5)
    profiling.count("test.items")
    got = profiling.since(before)
    assert got["calls"] == {"test.outer": 1, "test.inner": 3, "test.paused": 2}
    assert 0 < got["seconds"]["test.inner"] <= got["seconds"]["test.outer"]
    assert got["counts"] == {"test.items": 6}
    snap = profiling.snapshot()
    profiling.count("test.items")
    assert snap["counts"]["test.items"] + 1 == profiling.COUNTS["test.items"]
    assert profiling.since(profiling.snapshot()) == {
        "seconds": {}, "calls": {}, "counts": {}}
    lines = profiling.report(got)
    assert lines[0].startswith("span test.inner ") and lines[0].endswith(" 3 calls")
    assert lines[-1] == "count test.items 6"


@pytest.mark.parametrize("view,table,prefix", [
    (graph_align.PHASE_SECONDS, profiling.SECONDS, "align."),
    (graph_align.HOST_LADDER, profiling.COUNTS, "align.host_ladder."),
    (seqalign.TRACEBACK_CALLS, profiling.COUNTS, "align.traceback."),
    (nw_cuda.LAUNCHES, profiling.COUNTS, "kernels.nw."),
    (seqalign_cuda.LAUNCHES, profiling.COUNTS, "kernels.seqalign."),
])
def test_old_counter_dicts_are_views_of_the_registry(view, table, prefix,
                                                     monkeypatch):
    key = next(iter(view))
    monkeypatch.setitem(view, key, 7)
    assert table[prefix + key] == 7
    monkeypatch.setitem(table, prefix + key, 9)
    assert view[key] == 9 and dict(view)[key] == 9 and view == dict(view)
    assert set(view) == {k[len(prefix):] for k in table
                         if k.startswith(prefix) and k[len(prefix):] in view}
    with pytest.raises(KeyError):
        view["no such key"]


def test_no_profiler_range_without_a_profiler(align_argv, search_argv,
                                              python_driver, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = profiling.snapshot()
    run(align_argv)
    run(search_argv)
    calls = profiling.since(before)["calls"]
    assert calls["cli.align"] == calls["cli.search"] == 1
    assert calls["search.evaluate.fetch"] > 0


def test_spans_nest_in_the_profilers_events(align_argv, search_argv,
                                            python_driver, monkeypatch):
    monkeypatch.setattr(graph_align, "align_engine", lambda device: "device")
    _, align_events = profiled(lambda: run(align_argv))
    _, search_events = profiled(lambda: run(search_argv))
    for child, parent in [
            ("io.read_gfa", "cli.align"), ("align.read_fastq", "cli.align"),
            ("align.seeding", "cli.align"), ("align.seeding.index", "align.seeding"),
            ("align.seeding.anchors", "align.seeding"),
            ("align.seeding.candidates", "align.seeding"),
            ("align.scoring", "cli.align"), ("align.scoring.pools", "cli.align"),
            ("align.scoring.rung", "align.scoring"),
            ("align.traceback.banded", "align.traceback"),
            ("align.traceback", "cli.align"), ("align.emit", "cli.align"),
            ("io.read_gfa", "cli.search"), ("io.read_gaf", "cli.search"),
            ("search.load", "cli.search"), ("search.driver", "cli.search"),
            ("search.frontier", "cli.search"),
            ("search.evaluate.encode", "search.frontier"),
            ("search.evaluate.dispatch", "search.frontier"),
            ("search.evaluate.fetch", "search.frontier"),
            ("search.evaluate.unpack", "search.frontier")]:
        events = search_events if parent.startswith(("cli.search", "search."))\
            else align_events
        assert inside(events, child, parent), (child, parent)
    # the driver's span pauses for each frontier call
    driver = [(s, e) for n, s, e, _ in search_events if n == "search.driver"]
    frontier = [(s, e) for n, s, e, _ in search_events if n == "search.frontier"]
    assert len(driver) == len(frontier) + 1
    assert not any(ds < fe and fs < de for ds, de in driver for fs, fe in frontier)
    # function-scope ranges: a user annotation would gain a device-side
    # copy on a card, which the benchmark's trace would count as busy
    assert not any(user for n, _, _, user in align_events + search_events
                   if n.startswith(("cli.", "io.", "align.", "search.")))


def test_a_span_holds_its_work_in_the_profilers_events(align_argv,
                                                       monkeypatch):
    """Torch operations at the start and the end of the GFA parse lie inside
    the one io.read_gfa range, a CPU range and no user annotation."""
    real = gfa._read_gfa_native

    def parse(path):
        torch.arange(3)
        graph = real(path)
        torch.arange(3)
        return graph

    monkeypatch.setattr(gfa, "_read_gfa_native", parse)
    graph, events = profiled(lambda: read_gfa(align_argv[2]))
    assert graph.segments
    (_, start, end, user), = [e for e in events if e[0] == "io.read_gfa"]
    work = [(s, e) for n, s, e, _ in events if n == "aten::arange"]
    assert len(work) >= 2 and not user
    assert all(start <= s and e <= end for s, e in work)


def test_seeded_align_seeding_spans_and_candidate_count(align_argv, monkeypatch):
    anchor_lists = []
    real_anchors = seeding.anchors_with_diag_batch

    def anchors(*a, **kw):
        anchor_lists.append(real_anchors(*a, **kw))
        return anchor_lists[-1]

    monkeypatch.setattr(seeding, "anchors_with_diag_batch", anchors)
    before = profiling.snapshot()
    run(align_argv)
    got = profiling.since(before)
    sec, calls, counts = got["seconds"], got["calls"], got["counts"]
    assert calls["align.seeding.candidates"] == 1        # no retry pass
    parts = sum(sec[f"align.seeding.{p}"] for p in ("index", "anchors", "candidates"))
    assert parts == pytest.approx(sec["align.seeding"], rel=0.02)
    walks = sec["align.traceback.banded"] + sec.get("align.traceback.full", 0.0)
    assert 0 < walks <= sec["align.traceback"]
    # the candidates of each read again, by gen_candidates' own rule
    graph = read_gfa(align_argv[2])
    reads = load_reads([align_argv[4]])
    params = graph_align.PRESETS["hifi"]
    want = 0
    for (_, seq), anchors_r in zip(reads, anchor_lists[0]):
        cands, seen = [], set()
        for anchor, _, _ in anchors_r:
            if any(anchor in key for key in cands):
                continue
            for steps in seeding.paths_around_anchor(
                    graph, anchor, len(seq), params.max_paths_per_anchor,
                    audit=graph_align.CapAudit()):
                if tuple(steps) not in seen:
                    seen.add(tuple(steps))
                    cands.append(tuple(steps))
        want += len(cands)
    assert counts["align.reads"] == len(reads) == 10
    assert counts["align.candidates"] == want > 0
    assert counts["align.traceback.banded_walks"] > 0
    assert counts.get("align.traceback.declined", 0) == 0


def test_a_declined_banded_walk_counts_one_full_walk(align_argv, monkeypatch):
    plain = run(align_argv)
    real = seqalign.banded_traceback

    def off_by_one(read, path, end_i, end_j, delta, width, expected):
        # the end-value parity gate fails: the walk declines
        return real(read, path, end_i, end_j, delta, width, expected + 1)

    monkeypatch.setattr(seqalign, "banded_traceback", off_by_one)
    before = profiling.snapshot()
    assert run(align_argv) == plain
    got = profiling.since(before)
    counts = got["counts"]
    assert counts["align.traceback.banded_walks"] > 0
    assert (counts["align.traceback.declined"] == counts["align.traceback.full_walks"]
            == counts["align.traceback.banded_walks"])
    assert got["calls"]["align.traceback.full"] == counts["align.traceback.full_walks"]
    # on the CPU every walk is native, the full ones too, and counts its cells
    assert counts["align.traceback.native"] == (counts["align.traceback.banded_walks"]
                                                + counts["align.traceback.full_walks"])
    assert "align.traceback.cuda" not in counts
    assert "kernels.seqalign.walk" not in counts
    assert counts["align.traceback.full_cells"] > 0


def test_search_speculation_counters_and_stdout_under_a_profiler(
        search_argv, python_driver):
    before = profiling.snapshot()
    plain = run(search_argv)
    got = profiling.since(before)
    counts = got["counts"]
    assert plain.count("\n") >= 2
    assert got["calls"]["search.frontier"] == counts["search.frontier_calls"] > 1
    # each call scores at least one candidate, and speculation adds more
    assert counts["search.candidates_scored"] > counts["search.frontier_calls"]
    before = profiling.snapshot()
    run(search_argv + ["--max-steps", "3"])
    cut = profiling.since(before)["counts"]
    assert 0 < cut["search.frontier_calls"] < counts["search.frontier_calls"]
    assert 0 < cut["search.candidates_scored"] < counts["search.candidates_scored"]
    traced, _ = profiled(lambda: run(search_argv))
    assert traced == plain


def test_verbose_prints_the_calls_spans_and_counters(search_argv, python_driver,
                                                     monkeypatch):
    monkeypatch.setattr(lg, "verbose_flag", False)      # restored after
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = run(search_argv + ["--verbose"])
    assert out == run(search_argv)
    lines = [ln.split("] ", 1)[-1] for ln in err.getvalue().splitlines()]
    assert "span cli.search" in {" ".join(ln.split()[:2]) for ln in lines}
    assert any(ln.startswith("count search.frontier_calls ") for ln in lines)
    assert [ln for ln in lines if ln.startswith("span cli.search ")][0].endswith(
        " 1 calls")
