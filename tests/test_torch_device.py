"""The port runs on CUDA unless the caller asks for the CPU: without a
card, an entry point that was not told `cpu` raises instead of quietly
scoring on the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from gfalign_torch import synth
from gfalign_torch.cli.main import main, resolve_device
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
