"""Goldens of the port's full-scale slice run (chip_smoke.py phase 5).

`tests/data/torch_slice_search_seed0.out` is the stdout of `search -s 498
-d 503` on `synth.make_workload(seed=0)` (1,000 segments, 10,000 reads)
with its truth GAF, and `tests/data/torch_slice_evalpath_seed0.md5` holds
the md5 and line count of the inputs, of the `evalPath` stdout, and of a
curator's post-filter search (chip_smoke.py phase 5b): the truth GAF
through `filter -n filter_nodelist.ls` (filtered.gaf), then the same
search on that GAF (search_filtered.out).  All were produced by the JAX
package on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_goldens.py --regenerate

(`--regenerate-align` redoes only the align goldens below.)

`tests/data/torch_slice_align_seed0.md5` holds the md5 and record count of
the inputs and GAFs of the three `align` runs of chip_smoke.py (see
`align_workloads`), made by the JAX package on the CPU with its device
scoring ladder (GFALIGN_TPU_ALIGN_DEVICE=1); the same command writes it.
`tests/data/torch_slice_align_host_seed0.md5` holds the same for the
seeded and band_edge runs through the JAX package's default engine, its
native host scoring ladder (the port's ladder on the CPU, chip_smoke.py
phase 12):

    JAX_PLATFORMS=cpu python tests/test_torch_goldens.py --regenerate-align-host

The tier-1 tests below check that the port's own workload generator still
writes the recorded inputs, so that the chip run's comparison against the
goldens stays meaningful.
"""

from __future__ import annotations

import hashlib
import pathlib
import random
import sys

DATA = pathlib.Path(__file__).resolve().parent / "data"
SEARCH_GOLDEN = DATA / "torch_slice_search_seed0.out"
MD5_GOLDEN = DATA / "torch_slice_evalpath_seed0.md5"
ALIGN_MD5_GOLDEN = DATA / "torch_slice_align_seed0.md5"
ALIGN_HOST_MD5_GOLDEN = DATA / "torch_slice_align_host_seed0.md5"
ALIGN_HOST_RUNS = ("seeded", "band_edge")
ALIGN_SEEDED_READS = 10000  # all of make_workload(seed=0)'s reads
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
    """Write what `search`, `evalPath` and `filter` read -- graph.gfa, the
    truth GAF truth.gaf, search_nodelist.tsv and filter_nodelist.ls -- with
    one package's writers (not the reads, ~100 MB of FASTQ at full scale);
    returns the path of each."""
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    paths = {"gfa": str(d / "graph.gfa"), "gaf": str(d / "truth.gaf"),
             "search_nodelist": str(d / "search_nodelist.tsv"),
             "filter_nodelist": str(d / "filter_nodelist.ls")}
    with open(paths["gfa"], "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, paths["gaf"])
    pathlib.Path(paths["search_nodelist"]).write_text(
        "".join(row + "\n" for row in wl.search_nodelist))
    pathlib.Path(paths["filter_nodelist"]).write_text(
        "".join(n + "\n" for n in wl.filter_nodelist))
    return paths


def port_search_inputs(wl, out_dir):
    """write_search_inputs with the port's writers."""
    from gfalign_torch import synth
    from gfalign_torch.io.writers import write_gfa1

    return write_search_inputs(synth, write_gfa1, wl, out_dir)


def _write_reads(path, reads):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")


def band_edge_reads(wl, n_reads=12, seed=7, piece=1000, band=128,
                    wide_band=512):
    """Hand-made error-free reads along the backbone of `wl` whose optimum
    ends on the band's edge lane at width `band` AND at width `wide_band`,
    so that the seeded aligner's ladder hands them to the full DP: three
    pieces of `piece` bases of one path, the second and third shifted
    against the first piece's diagonal by band/2 - 1 and wide_band/2 - 1
    bases (deletions: the last lane; even reads) or by -band/2 and
    -wide_band/2 (insertions of random bases: lane 0; odd reads)."""
    rng = random.Random(seed)
    segs = {seg.name: seg.seq for seg in wl.graph.segments}
    d1, d2 = band // 2 - 1, wide_band // 2 - 1
    reads = []
    for t in range(n_reads):
        i = 3 + 8 * t
        parts = []
        while sum(map(len, parts)) < 3 * piece + wide_band:
            parts.append(segs[wl.backbone[i]])
            i += 1
        bb = "".join(parts)[37:]
        if t % 2 == 0:
            seq = (bb[:piece] + bb[piece + d1:2 * piece + d1]
                   + bb[2 * piece + d2:3 * piece + d2])
        else:
            junk = "".join(rng.choice("ACGT") for _ in range(wide_band // 2))
            seq = (bb[:piece] + junk[:band // 2] + bb[piece:2 * piece]
                   + junk[band // 2:] + bb[2 * piece:3 * piece])
        reads.append((f"edge{t}", seq))
    return reads


def align_workloads(synth, write_gfa1, full_scale_wl, out_dir):
    """Write the inputs of chip_smoke.py's three `align` runs with one
    package's generator and writers; returns {name: (gfa, reads, preset)}.

    seeded      the graph of make_workload(seed=0) (1,142 segments) and the
                first ALIGN_SEEDED_READS of its reads (2-8 kb), hifi;
    band_edge   a 120-segment graph (seeded engine), its 10 reads of
                300-900 bases and `band_edge_reads`, hifi: the run that
                reaches the full pairwise DP;
    exhaustive  a 30-segment graph with bubbles (34 segments, under
                SEED_THRESHOLD = 48) and 200 reads of 150-400 bases, hifi:
                the exhaustive engine."""
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    edge_wl = synth.make_workload(seed=41, n_segments=120, n_reads=10,
                                  seg_len=(120, 400), read_len=(300, 900),
                                  sub_rate=0.01, ins_rate=0.002, del_rate=0.002)
    small_wl = synth.make_workload(seed=5, n_segments=30, n_reads=200,
                                   seg_len=(60, 150), read_len=(150, 400),
                                   tangle_k=2)
    out = {}
    for name, wl, reads in (
            ("seeded", full_scale_wl, full_scale_wl.reads[:ALIGN_SEEDED_READS]),
            ("band_edge", edge_wl, edge_wl.reads + band_edge_reads(edge_wl)),
            ("exhaustive", small_wl, small_wl.reads)):
        gfa, fa = str(d / f"{name}.gfa"), str(d / f"{name}.fa")
        with open(gfa, "w") as fh:
            write_gfa1(wl.graph, fh.write)
        _write_reads(fa, reads)
        out[name] = (gfa, fa, "hifi")
    return out


def port_align_workloads(full_scale_wl, out_dir):
    """align_workloads with the port's generator and writers."""
    from gfalign_torch import synth
    from gfalign_torch.io.writers import write_gfa1

    return align_workloads(synth, write_gfa1, full_scale_wl, out_dir)


def test_port_synth_writes_recorded_align_inputs(tmp_path):
    from gfalign_torch import synth

    want = read_md5_golden(ALIGN_MD5_GOLDEN)
    runs = port_align_workloads(synth.make_workload(seed=0), tmp_path)
    for name, (gfa, fa, _) in runs.items():
        for path in (gfa, fa):
            key = pathlib.Path(path).name
            assert digest(pathlib.Path(path).read_bytes()) == want[key], key


def test_port_synth_writes_recorded_inputs(tmp_path):
    from gfalign_torch import synth

    wl = synth.make_workload(seed=0)
    paths = port_search_inputs(wl, tmp_path)
    want = read_md5_golden()
    for key in ("gfa", "gaf"):
        name = pathlib.Path(paths[key]).name
        assert digest(pathlib.Path(paths[key]).read_bytes()) == want[name], name


def test_port_post_filter_search_matches_golden(tmp_path):
    """chip_smoke.py phase 5b's inputs and output on the CPU: the port's
    filter writes the recorded filtered.gaf, and the port's default CPU
    search (the C++ driver) prints the recorded TSV."""
    import contextlib
    import io

    from gfalign_torch import synth
    from gfalign_torch.cli.main import main

    paths = port_search_inputs(synth.make_workload(seed=0), tmp_path)
    want = read_md5_golden()
    filtered = str(tmp_path / "filtered.gaf")
    outs = []
    for argv in (["filter", "-g", paths["gaf"], "-n", paths["filter_nodelist"],
                  "-o", filtered],
                 ["search", "-f", paths["gfa"], "-g", filtered, "-n",
                  paths["search_nodelist"]] + SEARCH_ARGS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv, device="cpu") == 0
        outs.append(buf.getvalue().encode())
    assert digest(pathlib.Path(filtered).read_bytes()) == want["filtered.gaf"]
    assert digest(outs[1]) == want["search_filtered.out"]


def _regenerate(align_only: bool = False) -> None:
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
        _regenerate_align(synth, write_gfa1, main, wl, d / "align")
        if align_only:
            return
        paths = write_search_inputs(synth, write_gfa1, wl, d)
        filtered = str(d / "filtered.gaf")
        outs = {}
        for name, argv in (
                ("search", ["search", "-f", paths["gfa"], "-g", paths["gaf"],
                            "-n", paths["search_nodelist"]] + SEARCH_ARGS),
                ("evalPath", ["evalPath", "-f", paths["gfa"], "-g", paths["gaf"],
                              "-p", EVALPATH_PATH]),
                ("filter", ["filter", "-g", paths["gaf"], "-n",
                            paths["filter_nodelist"], "-o", filtered]),
                ("search_filtered", ["search", "-f", paths["gfa"], "-g", filtered,
                                     "-n", paths["search_nodelist"]] + SEARCH_ARGS)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            assert rc == 0, name
            outs[name] = buf.getvalue().encode()
        SEARCH_GOLDEN.write_bytes(outs["search"])
        rows = [(*digest((d / n).read_bytes()), n)
                for n in ("graph.gfa", "truth.gaf", "filtered.gaf")]
        rows.append((*digest(outs["evalPath"]), "evalpath.out"))
        rows.append((*digest(outs["search_filtered"]), "search_filtered.out"))
        MD5_GOLDEN.write_text("".join(f"{m}  {n}  {name}\n"
                                      for m, n, name in rows))


def _regenerate_align(synth, write_gfa1, main, full_scale_wl, d, host=False) -> None:
    """The three align GAFs by the JAX package's device scoring ladder on
    the CPU, or with `host` the seeded and band_edge GAFs by its default
    engine (the native host ladder) into ALIGN_HOST_MD5_GOLDEN.
    ALIGN_ONLY in the environment names one run to redo (the others keep
    their rows); ALIGN_KEEP_DIR names a directory that gets a copy of each
    GAF."""
    import os
    import time

    golden = ALIGN_HOST_MD5_GOLDEN if host else ALIGN_MD5_GOLDEN
    if host:
        os.environ.pop("GFALIGN_TPU_ALIGN_DEVICE", None)
        from gfalign_tpu.io import native
        if not native.available():
            raise SystemExit("the JAX package's native library did not build")
    else:
        os.environ["GFALIGN_TPU_ALIGN_DEVICE"] = "1"
    runs = align_workloads(synth, write_gfa1, full_scale_wl, d)
    if host:
        runs = {name: runs[name] for name in ALIGN_HOST_RUNS}
    only = os.environ.get("ALIGN_ONLY")
    keep = os.environ.get("ALIGN_KEEP_DIR")
    rows = read_md5_golden(golden) if golden.exists() else {}
    for name, (gfa, fa, preset) in runs.items():
        for path in (gfa, fa):
            rows[pathlib.Path(path).name] = digest(pathlib.Path(path).read_bytes())
        if only and name != only:
            continue
        out = pathlib.Path(d) / f"{name}.gaf"
        t0 = time.time()
        rc = main(["align", "-f", gfa, "-r", fa, "-o", str(out), "-p", preset])
        assert rc == 0, name
        rows[out.name] = digest(out.read_bytes())
        print(f"{name}: {rows[out.name]} in {time.time() - t0:.0f} s", flush=True)
        if keep:
            pathlib.Path(keep, out.name).write_bytes(out.read_bytes())
        golden.write_text("".join(
            f"{m}  {n}  {key}\n" for key, (m, n) in sorted(rows.items())))


def _regenerate_align_host() -> None:
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gfalign_tpu import synth
    from gfalign_tpu.cli.main import main
    from gfalign_tpu.io.writers import write_gfa1

    with tempfile.TemporaryDirectory() as d:
        _regenerate_align(synth, write_gfa1, main, synth.make_workload(seed=0),
                          pathlib.Path(d) / "align", host=True)


if __name__ == "__main__":
    usage = ("usage: python tests/test_torch_goldens.py --regenerate | "
             "--regenerate-align | --regenerate-align-host")
    if len(sys.argv) != 2 or sys.argv[1] not in (
            "--regenerate", "--regenerate-align", "--regenerate-align-host"):
        raise SystemExit(usage)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    if sys.argv[1] == "--regenerate-align-host":
        _regenerate_align_host()
    else:
        _regenerate(align_only=sys.argv[1] == "--regenerate-align")
