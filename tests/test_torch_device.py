"""The port runs on CUDA unless the caller asks for the CPU: without a
card, an entry point that was not told `cpu` raises instead of quietly
scoring on the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfalign_torch import synth
from gfalign_torch.cli.main import main, resolve_device
from gfalign_torch.engine import graph_align
from gfalign_torch.ops import cuda_build, seqalign, seqalign_cuda
from tests.test_torch_goldens import port_search_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def inputs(tmp_path):
    wl = synth.make_workload(seed=1, n_segments=40, n_reads=20, tangle_k=4)
    paths = port_search_inputs(wl, tmp_path)
    return ["search", "-f", paths["gfa"], "-g", paths["gaf"], "-n",
            paths["search_nodelist"], "-s", wl.source, "-d", wl.destination]


def test_main_without_device_raises_without_cuda(inputs, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(inputs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(inputs, device="cuda")
    assert capsys.readouterr().out == ""
    assert main(inputs, device="cpu") == 0
    assert capsys.readouterr().out


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_python_m_without_device_env_fails_without_cuda(inputs):
    env = {k: v for k, v in os.environ.items() if k != "GFALIGN_TORCH_DEVICE"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "gfalign_torch"] + inputs,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.fixture
def align_inputs(tmp_path):
    wl = synth.make_workload(seed=3, n_segments=12, n_reads=4, seg_len=(60, 120),
                             read_len=(80, 200), bubble_every=4, tangle_k=2)
    paths = synth.write_workload(wl, str(tmp_path))
    return ["align", "-f", paths["gfa"], "-r", paths["reads"], "-o",
            str(tmp_path / "out.gaf")]


def test_align_without_device_raises_without_cuda(align_inputs, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(align_inputs)
    assert not pathlib.Path(align_inputs[-1]).exists()
    assert main(align_inputs, device="cpu") == 0
    assert pathlib.Path(align_inputs[-1]).read_text().count("\n") >= 3


def code_batch():
    rng = np.random.default_rng(0)
    reads = torch.from_numpy(rng.integers(0, 4, (3, 20)).astype(np.int8))
    paths = torch.from_numpy(rng.integers(0, 4, (3, 30)).astype(np.int8))
    return reads, paths, torch.zeros(3, dtype=torch.int32)


SEQALIGN_ENTRY_POINTS = {
    "batched_local_scores": lambda r, p, d: seqalign.batched_local_scores(r, p),
    "batched_pair_scores": lambda r, p, d: seqalign.batched_pair_scores(r, p),
    "banded_pair_scores": lambda r, p, d: seqalign.banded_pair_scores(r, p, d, width=8),
}


@pytest.mark.parametrize("name", sorted(SEQALIGN_ENTRY_POINTS))
def test_seqalign_entry_points_run_plain_on_cpu_tensors(name, monkeypatch):
    """A CPU tensor takes the plain version: the CUDA wrappers are not
    touched, and nothing is built."""
    def boom(*a, **kw):
        raise AssertionError("the CUDA wrapper was called for a CPU tensor")
    for fn in ("local_forward_cuda", "banded_arena_scores_cuda"):
        monkeypatch.setattr(seqalign_cuda, fn, boom)
    before = dict(seqalign_cuda.LAUNCHES)
    out = SEQALIGN_ENTRY_POINTS[name](*code_batch())
    assert all(x.device.type == "cpu" for x in out)
    assert out[0].dtype == torch.int32 and int(out[0].max()) > 0
    assert seqalign_cuda.LAUNCHES == before


def test_banded_arena_scores_runs_plain_on_cpu_pools(monkeypatch):
    monkeypatch.setattr(seqalign_cuda, "banded_arena_scores_cuda", None)
    reads, paths, deltas = code_batch()
    rows = torch.arange(3, dtype=torch.int32)
    out = seqalign.banded_arena_scores(
        paths.reshape(-1), torch.zeros((3, 1), dtype=torch.int32),
        (rows * 30)[:, None].contiguous(), torch.full((3,), 30, dtype=torch.int32),
        reads, rows.numpy(), rows.numpy(), deltas.numpy(), width=8)
    want = seqalign.banded_pair_scores(reads, paths, deltas, width=8)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("name", ["local_forward_cuda", "banded_arena_scores_cuda"])
def test_seqalign_cuda_wrappers_refuse_cpu_tensors(name):
    """The wrappers never fall back: a tensor that is not on a CUDA device
    raises before anything is built or launched."""
    reads, paths, deltas = code_batch()
    before = dict(seqalign_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        if name == "local_forward_cuda":
            seqalign_cuda.local_forward_cuda(reads, paths, pairwise=True)
        else:
            rows = torch.arange(3, dtype=torch.int32)
            seqalign_cuda.banded_arena_scores_cuda(
                paths.reshape(-1), torch.zeros((3, 1), dtype=torch.int32),
                rows[:, None].contiguous(), torch.full((3,), 30, dtype=torch.int32),
                reads, rows, rows, deltas, 8)
    assert seqalign_cuda.LAUNCHES == before


def test_entry_points_raise_on_a_cuda_request_without_a_card(align_inputs, tmp_path):
    """Asked for CUDA on a machine without a card, the aligner and the
    pools raise (torch refuses the device); they do not score on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from gfalign_torch.io.gfa import read_gfa

    graph = read_gfa(align_inputs[2])
    reads = [("r", "ACGT" * 30)]
    with pytest.raises((RuntimeError, AssertionError)):
        graph_align.align_reads(graph, reads, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        graph_align.DevicePools([np.zeros(8, np.int8)], graph, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        seqalign.batched_pair_scores(*(x.to("cuda") for x in code_batch()[:2]))


def test_cuda_build_names_one_library_per_source(tmp_path, monkeypatch):
    """Both .cu files go through one build helper: a library per source in
    build/gfalign_torch/, replaced atomically, and nvcc is required."""
    assert cuda_build.source_path("nw_path").is_file()
    assert cuda_build.source_path("seqalign").is_file()
    assert cuda_build.lib_path("seqalign").parent == cuda_build.BUILD_DIR
    assert cuda_build.lib_path("seqalign") != cuda_build.lib_path("nw_path")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("seqalign")
    # a stand-in compiler: the library appears only under its final name
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\necho 'ptxas info: 0 spill' >&2\n")
    fake.chmod(0o755)
    report = cuda_build.build("seqalign")
    assert "spill" in report
    assert [p.name for p in (tmp_path / "b").iterdir()] == ["libseqalign.so"]
    assert cuda_build.build("seqalign") == ""       # up to date: not rebuilt
