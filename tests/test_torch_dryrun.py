"""The port's driver entry points (gfalign_torch/dryrun.py) on the CPU:
entry() against the JAX package's __graft_entry__.entry() on its batch,
and the multi-rank dry run on two gloo ranks at its small size."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from gfalign_torch import dryrun

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def test_entry_matches_the_jax_entry():
    jax_fn, jax_batch = jax_entry()
    fn, batch = dryrun.entry(device="cpu")
    assert len(batch) == len(jax_batch) == 4
    for got, want in zip(batch, jax_batch):
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(fn(*batch).numpy(), np.asarray(jax_fn(*jax_batch)))


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2, full_scale=False)


def test_dryrun_on_two_cpu_ranks(capsys):
    res = dryrun.dryrun_multichip(2, device="cpu", full_scale=False)
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == "dryrun_multichip(2) OK"
    assert res["grid"] == (1, 2)
    assert len(res["search_ranks"]) == 2 and len(res["align_ranks"]) == 2
    assert res["one_process"]["search_lines"] >= 2
    assert res["one_process"]["align_records"] >= 10
    assert all(r["device"] == "cpu" for r in res["search_ranks"] + res["align_ranks"])


def test_dryrun_cli_usage():
    assert dryrun.main(["--bogus"]) == 2
    assert dryrun.main(["2", "3"]) == 2
