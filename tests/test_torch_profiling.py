"""GFALIGN_TORCH_TRACE (gfalign_torch/utils/profiling.py, wired around the
mode in cli/main.run) on the CPU: a trace is written per process and
parses as a Chrome trace, stdout is the same bytes with and without it,
no profiler is built when the variable is unset, and a trace directory
that cannot be written fails the run."""

import ast
import contextlib
import io
import json
import os
import pathlib

import pytest

from gfalign_torch import synth
from gfalign_torch.cli.main import main
from gfalign_torch.parallel import dist
from gfalign_torch.utils import profiling
from tests.test_torch_goldens import port_search_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def search_argv(tmp_path_factory):
    d = tmp_path_factory.mktemp("wl")
    wl = synth.make_workload(seed=0, n_segments=40, n_reads=60, tangle_k=4)
    paths = port_search_inputs(wl, d)
    return ["search", "-f", paths["gfa"], "-g", paths["gaf"], "-n",
            paths["search_nodelist"], "-s", wl.source, "-d", wl.destination]


def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, device="cpu") == 0
    return buf.getvalue()


def test_trace_is_written_parses_and_leaves_stdout_alone(search_argv, tmp_path,
                                                         monkeypatch):
    plain = run(search_argv)
    assert plain.count("\n") >= 2
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("GFALIGN_TORCH_TRACE", str(trace_dir))
    assert run(search_argv) == plain
    path = trace_dir / f"gfalign_torch.{os.getpid()}.json"
    assert list(trace_dir.iterdir()) == [path]
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_unset_variable_builds_no_profiler(search_argv, monkeypatch):
    """torch imports torch.profiler itself, so what is checked is that
    the hook imports nothing at module level and builds no profiler."""
    tree = ast.parse(pathlib.Path(profiling.__file__).read_text())
    top = {alias.name.split(".")[0] for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           for alias in getattr(node, "names", [])}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module}
    assert "torch" not in top
    monkeypatch.delenv("GFALIGN_TORCH_TRACE", raising=False)

    def no_profiler(*a, **k):
        raise AssertionError("a profiler was built")

    monkeypatch.setattr("torch.profiler.profile", no_profiler)
    assert run(search_argv).count("\n") >= 2
    monkeypatch.setenv("GFALIGN_TORCH_TRACE", "")
    assert run(search_argv).count("\n") >= 2


def test_unwritable_trace_directory_fails_the_run(search_argv, tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("GFALIGN_TORCH_TRACE", str(blocker / "traces"))
    buf = io.StringIO()
    with pytest.raises(RuntimeError, match="cannot write the trace"), \
            contextlib.redirect_stdout(buf):
        main(search_argv, device="cpu")
    assert buf.getvalue() == ""


def test_failed_export_fails_the_run(search_argv, tmp_path, monkeypatch):
    monkeypatch.setenv("GFALIGN_TORCH_TRACE", str(tmp_path))

    def broken(self, path):
        raise OSError("disk full")

    monkeypatch.setattr("torch.profiler.profile.export_chrome_trace", broken)
    with pytest.raises(OSError, match="disk full"), \
            contextlib.redirect_stdout(io.StringIO()):
        main(search_argv, device="cpu")


def test_each_rank_writes_its_own_trace(search_argv, tmp_path):
    trace_dir = tmp_path / "traces"
    got = dist.launch_local(["-m", "gfalign_torch", *search_argv], 2, 120, tmp_path,
                            cwd=ROOT, env={"PYTHONPATH": str(ROOT),
                                           "GFALIGN_TORCH_DEVICE": "cpu",
                                           "GFALIGN_TORCH_TRACE": str(trace_dir)})
    assert [rc for rc, _, _ in got] == [0, 0], [err[-800:] for _, _, err in got]
    assert got[0][1] == run(search_argv) and got[1][1] == ""
    files = sorted(trace_dir.glob("gfalign_torch.*.json"))
    assert len(files) == 2
    for f in files:
        assert json.loads(f.read_text())["traceEvents"]


def test_a_rank_the_mode_leaves_idle_writes_no_trace(search_argv, tmp_path):
    """A decorated evalGFA runs on rank 0 alone: rank 1 returns before the
    trace opens, so one file is written, by the rank that did the work."""
    trace_dir = tmp_path / "traces"
    argv = ["evalGFA", "-f", search_argv[2], "-g", search_argv[4], "-o",
            str(tmp_path / "out.gfa")]
    got = dist.launch_local(["-m", "gfalign_torch", *argv], 2, 120, tmp_path,
                            cwd=ROOT, env={"PYTHONPATH": str(ROOT),
                                           "GFALIGN_TORCH_DEVICE": "cpu",
                                           "GFALIGN_TORCH_TRACE": str(trace_dir)})
    assert [rc for rc, _, _ in got] == [0, 0], [err[-800:] for _, _, err in got]
    assert (tmp_path / "out.gfa").stat().st_size > 0
    files = list(trace_dir.glob("gfalign_torch.*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"cli.evalGFA", "io.read_gfa", "io.read_gaf"} <= names
