"""Goldens of the port's full-scale slice run (chip_smoke.py phase 5).

`tests/data/torch_slice_search_seed0.out` is the stdout of `search -s 498
-d 503` on `synth.make_workload(seed=0)` (1,000 segments, 10,000 reads)
with its truth GAF, and `tests/data/torch_slice_evalpath_seed0.md5` holds
the md5 and line count of the inputs and of the `evalPath` stdout.  Both
were produced by the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_goldens.py --regenerate

The tier-1 test below checks that the port's own workload generator still
writes the recorded inputs, so that the chip run's comparison against the
goldens stays meaningful.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys

DATA = pathlib.Path(__file__).resolve().parent / "data"
SEARCH_GOLDEN = DATA / "torch_slice_search_seed0.out"
MD5_GOLDEN = DATA / "torch_slice_evalpath_seed0.md5"
SEARCH_ARGS = ["-s", "498", "-d", "503"]
EVALPATH_PATH = "498+,499+,500+,501+,502+,503+"


def digest(data: bytes):
    """(md5 hex, line count) of a byte string."""
    return hashlib.md5(data).hexdigest(), data.count(b"\n")


def read_md5_golden(path=MD5_GOLDEN):
    """{name: (md5, lines)} from the `<md5>  <lines>  <name>` golden."""
    out = {}
    for line in pathlib.Path(path).read_text().splitlines():
        md5, lines, name = line.split()
        out[name] = (md5, int(lines))
    return out


def write_search_inputs(synth, write_gfa1, wl, out_dir):
    """Write what `search` and `evalPath` read -- graph.gfa, the truth GAF
    truth.gaf and search_nodelist.tsv -- with one package's writers (not
    the reads, ~100 MB of FASTQ at full scale); returns the path of each."""
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    paths = {"gfa": str(d / "graph.gfa"), "gaf": str(d / "truth.gaf"),
             "search_nodelist": str(d / "search_nodelist.tsv")}
    with open(paths["gfa"], "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, paths["gaf"])
    pathlib.Path(paths["search_nodelist"]).write_text(
        "".join(row + "\n" for row in wl.search_nodelist))
    return paths


def port_search_inputs(wl, out_dir):
    """write_search_inputs with the port's writers."""
    from gfalign_torch import synth
    from gfalign_torch.io.writers import write_gfa1

    return write_search_inputs(synth, write_gfa1, wl, out_dir)


def test_port_synth_writes_recorded_inputs(tmp_path):
    from gfalign_torch import synth

    wl = synth.make_workload(seed=0)
    paths = port_search_inputs(wl, tmp_path)
    want = read_md5_golden()
    for key in ("gfa", "gaf"):
        name = pathlib.Path(paths[key]).name
        assert digest(pathlib.Path(paths[key]).read_bytes()) == want[name], name


def _regenerate() -> None:
    import contextlib
    import io
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gfalign_tpu import synth
    from gfalign_tpu.cli.main import main
    from gfalign_tpu.io.writers import write_gfa1

    wl = synth.make_workload(seed=0)
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        paths = write_search_inputs(synth, write_gfa1, wl, d)
        outs = {}
        for mode, extra in (("search", ["-n", paths["search_nodelist"]]
                             + SEARCH_ARGS),
                            ("evalPath", ["-p", EVALPATH_PATH])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([mode, "-f", paths["gfa"], "-g", paths["gaf"]] + extra)
            assert rc == 0, mode
            outs[mode] = buf.getvalue().encode()
        SEARCH_GOLDEN.write_bytes(outs["search"])
        rows = [(*digest((d / n).read_bytes()), n)
                for n in ("graph.gfa", "truth.gaf")]
        rows.append((*digest(outs["evalPath"]), "evalpath.out"))
        MD5_GOLDEN.write_text("".join(f"{m}  {n}  {name}\n"
                                      for m, n, name in rows))


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        raise SystemExit("usage: python tests/test_torch_goldens.py --regenerate")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    _regenerate()
