"""The port's host align engine (the native host scoring ladder, the
seeded engine's ladder on the CPU) against the JAX package's default
engine, which is that ladder: the CLI's bytes on the band-edge workload
(where the two ladders disagree) and on random workloads, the ladder's
native calls rung for rung, the ladder each device picks, and a
distributed run."""

import pathlib

import numpy as np
import pytest
import torch

from gfalign_tpu.cli.main import main as jax_main
from gfalign_tpu.io import native as jax_native
from gfalign_torch import synth
from gfalign_torch.cli.main import main as torch_main
from gfalign_torch.engine import graph_align
from gfalign_torch.io import native
from gfalign_torch.io.writers import write_gfa1
from gfalign_torch.parallel import dist
from tests.test_torch_align import SEEDED, run, strip_clock, write_inputs
from tests.test_torch_goldens import (ALIGN_HOST_MD5_GOLDEN, band_edge_reads, digest,
                                      read_md5_golden)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def jax_default_engine(monkeypatch):
    """The JAX package's default engine is its host ladder (no
    GFALIGN_TPU_ALIGN_DEVICE); the port's ladder on the CPU is the same."""
    monkeypatch.delenv("GFALIGN_TPU_ALIGN_DEVICE", raising=False)
    assert jax_native.available()


def band_edge_inputs(d):
    """chip_smoke.py's band_edge run: the seed-41 120-segment graph, its
    10 reads and the 12 hand-made band-edge reads."""
    wl = synth.make_workload(seed=41, **SEEDED)
    gfa, fa = d / "band_edge.gfa", d / "band_edge.fa"
    with open(gfa, "w") as fh:
        write_gfa1(wl.graph, fh.write)
    fa.write_text("".join(f">{name}\n{seq}\n"
                          for name, seq in wl.reads + band_edge_reads(wl)))
    return str(gfa), str(fa)


def align_both(tmp_path, gfa, reads, engine="host", extra=()):
    """(code, stdout, stderr lines, GAF bytes) of the JAX default engine
    and of the port on the CPU; engine "device" pins the port to the
    ladder it runs on CUDA (through the kernels' plain versions)."""
    outs = {}
    for name, main, kw in (("jax", jax_main, {}),
                           ("torch", torch_main, {"device": "cpu"})):
        gaf = tmp_path / f"{name}.gaf"
        mp = pytest.MonkeyPatch()
        if name == "torch" and engine == "device":
            mp.setattr(graph_align, "align_engine", lambda device: "device")
        try:
            code, out, err = run(main, ["align", "-f", gfa, "-r", reads, "-o",
                                        str(gaf)] + list(extra), **kw)
        finally:
            mp.undo()
        outs[name] = (code, out, strip_clock(err), gaf.read_bytes())
    return outs["jax"], outs["torch"]


def test_host_engine_matches_jax_default_engine_on_band_edge(tmp_path):
    gfa, reads = band_edge_inputs(tmp_path)
    golden = read_md5_golden(ALIGN_HOST_MD5_GOLDEN)
    assert digest(pathlib.Path(reads).read_bytes()) == golden["band_edge.fa"]
    for k in graph_align.HOST_LADDER:
        graph_align.HOST_LADDER[k] = 0
    want, got = align_both(tmp_path, gfa, reads)
    assert got == want
    assert got[0] == 0 and got[3].count(b"\n") == 26
    assert digest(got[3]) == golden["band_edge.gaf"]
    assert graph_align.HOST_LADDER["rungs"] > 0


@pytest.mark.parametrize("seed", [41, 46])
def test_host_engine_matches_jax_and_the_device_engine(seed, tmp_path):
    gfa, reads = write_inputs(synth.make_workload(seed=seed, **SEEDED), tmp_path)
    want, got = align_both(tmp_path, gfa, reads)
    assert got == want and got[3].count(b"\n") >= 10
    _, device = align_both(tmp_path, gfa, reads, "device")
    assert device[3] == got[3]


@pytest.mark.parametrize("seed,extra", [
    (41, ["--band", "16", "--wide-band", "64"]),      # cut 400: both ladders
    (46, ["--band", "16", "--wide-band", "32"]),
    (41, ["-p", "CLR"])])
def test_ladder_rungs_match_jax_rung_for_rung(seed, extra, tmp_path, monkeypatch):
    """Every native call of the host ladder -- width, pairs (read, path
    length, diagonal) and results -- in the same order in both packages,
    on workloads whose reads straddle the ladder's read-length cut and
    hit band edges (the band-edge reads at a narrow band)."""
    wl = synth.make_workload(seed=seed, **SEEDED)
    gfa, _ = write_inputs(wl, tmp_path)
    reads = tmp_path / "mixed.fa"
    reads.write_text("".join(f">{n}\n{s}\n" for n, s in wl.reads + band_edge_reads(
        wl, n_reads=4, piece=300, band=16, wide_band=32)))
    calls = {"jax": [], "torch": []}

    def recording(mod, name):
        real = mod.seq_banded_pairs

        def rec(rb, ro, rl, pb, po, pl, rid, pid, dl, width, *consts):
            got = real(rb, ro, rl, pb, po, pl, rid, pid, dl, width, *consts)
            calls[name].append((width, consts, rid.tolist(), pl[pid].tolist(),
                                dl.tolist(), *(np.asarray(x).tolist() for x in got)))
            return got
        monkeypatch.setattr(mod, "seq_banded_pairs", rec)

    recording(jax_native, "jax")
    recording(native, "torch")
    want, got = align_both(tmp_path, gfa, str(reads), extra=extra)
    assert got == want
    assert calls["torch"] == calls["jax"]
    widths = {c[0] for c in calls["torch"]}
    assert len(widths) >= 2, widths


def test_ladder_follows_the_device(tmp_path, monkeypatch):
    """CUDA scores on the device ladder, the CPU on the host ladder, and
    the CLI's align hands the CPU's ladder to the seeded engine."""
    for device in ("cuda", "cuda:1", torch.device("cuda", 0)):
        assert graph_align.align_engine(device) == "device"
    for device in ("cpu", torch.device("cpu")):
        assert graph_align.align_engine(device) == "host"
    calls = []
    monkeypatch.setattr(graph_align, "_align_seeded",
                        lambda *a: calls.append(a[-1]) or [])
    gfa, reads = write_inputs(synth.make_workload(seed=41, **SEEDED), tmp_path)
    assert torch_main(["align", "-f", gfa, "-r", reads, "-o", str(tmp_path / "x.gaf")],
                      device="cpu") == 0
    assert calls == ["host"]


def test_host_engine_raises_without_the_native_library(tmp_path, monkeypatch):
    """No quiet fall back to the device ladder."""
    monkeypatch.setattr(native, "available", lambda: False)
    gfa, reads = write_inputs(synth.make_workload(seed=41, **SEEDED), tmp_path)
    with pytest.raises(RuntimeError, match="native library"):
        torch_main(["align", "-f", gfa, "-r", reads, "-o", str(tmp_path / "x.gaf")],
                   device="cpu")


def test_distributed_align_honours_the_engine_on_each_rank(tmp_path):
    """Two ranks of `python -m gfalign_torch align` on the CPU each score
    on the host ladder: they write the JAX default engine's bytes on the
    band-edge workload (where the device ladder writes other bytes)."""
    gfa, reads = band_edge_inputs(tmp_path)
    out = tmp_path / "dist.gaf"
    got = dist.launch_local(["-m", "gfalign_torch", "align", "-f", gfa, "-r", reads,
                             "-o", str(out)], 2, 120, tmp_path, cwd=ROOT,
                            env={"PYTHONPATH": str(ROOT), "GFALIGN_TORCH_DEVICE": "cpu"})
    assert [rc for rc, _, _ in got] == [0, 0], [err[-800:] for _, _, err in got]
    golden = read_md5_golden(ALIGN_HOST_MD5_GOLDEN)
    assert digest(out.read_bytes()) == golden["band_edge.gaf"]
