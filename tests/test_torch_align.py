"""The port's `align` slice on the CPU against the JAX package run with its
device scoring ladder (GFALIGN_TPU_ALIGN_DEVICE=1) on the CPU: seeding,
the device pools, and the CLI end to end (GAF, stdout and the stderr echo
byte-equal), seeded and exhaustive.  The port runs the device ladder on
CUDA only; these tests hold it here through the kernels' plain versions
by pinning graph_align.align_engine to it (tests/test_torch_align_host.py
covers the CPU's own ladder)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from gfalign_tpu.cli.main import main as jax_main
from gfalign_tpu.engine import graph_align as jax_graph_align
from gfalign_tpu.engine import seeding as jax_seeding
from gfalign_tpu.io import fastq as jax_fastq
from gfalign_tpu.io.gfa import read_gfa as jax_read_gfa
from gfalign_torch import synth
from gfalign_torch.cli.main import main as torch_main
from gfalign_torch.engine import graph_align, seeding
from gfalign_torch.io import fastq
from gfalign_torch.io.gfa import read_gfa
from gfalign_torch.ops import seqalign
from tests.test_align_banded import _mini_arena_fixture
from tests.test_torch_goldens import band_edge_reads
from tests.test_torch_seqalign import ALIGN_WALKS

SEEDED = dict(n_segments=120, n_reads=10, seg_len=(120, 400),
              read_len=(300, 900), sub_rate=0.01, ins_rate=0.002,
              del_rate=0.002)
SMALL = dict(n_segments=12, n_reads=12, seg_len=(60, 120), read_len=(80, 200),
             bubble_every=4, tangle_k=2)


@pytest.fixture(autouse=True)
def jax_device_ladder(monkeypatch):
    monkeypatch.setenv("GFALIGN_TPU_ALIGN_DEVICE", "1")
    monkeypatch.setattr(graph_align, "align_engine", lambda device: "device")


def run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv, **kw)
        except SystemExit as exc:
            code = exc.code
    return code, out.getvalue(), err.getvalue()


def strip_clock(err):
    """The logger's `[12.34s] ` prefix is wall time; drop it."""
    return [line.split("] ", 1)[-1] for line in err.splitlines()]


def write_inputs(wl, d):
    paths = synth.write_workload(wl, str(d))
    return paths["gfa"], paths["reads"]


def assert_same_align(tmp_path, gfa, reads, extra=()):
    outs = {}
    for name, main, kw in (("jax", jax_main, {}),
                           ("torch", torch_main, {"device": "cpu"})):
        gaf = tmp_path / f"{name}.gaf"
        code, out, err = run(main, ["align", "-f", gfa, "-r", reads, "-o",
                                    str(gaf)] + list(extra), **kw)
        outs[name] = (code, out, strip_clock(err), gaf.read_bytes())
    assert outs["torch"] == outs["jax"]
    return outs["jax"]


@pytest.mark.parametrize("seed,preset", [(41, "hifi"), (46, "hifi"),
                                         (41, "CLR"), (46, "CLR")])
def test_seeded_align_matches_jax(seed, preset, tmp_path):
    gfa, reads = write_inputs(synth.make_workload(seed=seed, **SEEDED), tmp_path)
    code, out, err, gaf = assert_same_align(tmp_path, gfa, reads, ["-p", preset])
    assert code == 0 and gaf.count(b"\n") >= 10
    assert out.startswith(f"Invoking: gfalign-tpu-align -p {preset} ")


def test_seeded_align_to_stdout_echoes_on_stderr(tmp_path):
    gfa, reads = write_inputs(synth.make_workload(seed=41, **SEEDED), tmp_path)
    want = run(jax_main, ["align", "-f", gfa, "-r", reads])
    got = run(torch_main, ["align", "-f", gfa, "-r", reads], device="cpu")
    assert (got[0], got[1], strip_clock(got[2])) == \
        (want[0], want[1], strip_clock(want[2]))
    assert got[1].count("\n") >= 10 and "Invoking:" in got[2]


def test_align_overrides_round_bands_and_echo(tmp_path):
    gfa, reads = write_inputs(synth.make_workload(seed=46, **SEEDED), tmp_path)
    extra = ["--band", "60", "--wide-band", "250", "--min-score", "30",
             "--max-anchors", "6", "--seed-k", "13"]
    _, out, _, gaf = assert_same_align(tmp_path, gfa, reads, extra)
    assert "--band 64 --wide-band 256" in out and gaf


def test_band_edge_reads_reach_the_full_dp(tmp_path, monkeypatch):
    """Reads whose optimum ends on the edge lane at both band widths ride
    the whole ladder into the full pairwise DP, in both packages."""
    wl = synth.make_workload(seed=41, **SEEDED)
    gfa, _ = write_inputs(wl, tmp_path)
    reads = tmp_path / "edge.fa"
    reads.write_text("".join(f">{name}\n{seq}\n" for name, seq in band_edge_reads(
        wl, n_reads=6, piece=300, band=16, wide_band=32)))
    calls = []
    full_dp = seqalign.batched_pair_scores
    monkeypatch.setattr(seqalign, "batched_pair_scores",
                        lambda r, p: calls.append(tuple(r.shape)) or full_dp(r, p))
    code, _, _, gaf = assert_same_align(tmp_path, gfa, str(reads),
                                        ["--band", "16", "--wide-band", "32"])
    assert code == 0 and calls and gaf.count(b"\n") >= 6


def test_exhaustive_align_matches_jax(tmp_path):
    wl = synth.make_workload(seed=3, **SMALL)
    assert wl.graph.n_segments <= graph_align.SEED_THRESHOLD
    gfa, reads = write_inputs(wl, tmp_path)
    code, _, _, gaf = assert_same_align(tmp_path, gfa, reads)
    assert code == 0 and gaf.count(b"\n") >= 8


def test_align_falls_through_into_evalgfa(tmp_path):
    """Reference quirk: align has no break, so with -g it goes on into the
    evalGFA case (with -o cleared: the GAF is not overwritten)."""
    wl = synth.make_workload(seed=3, **SMALL)
    gfa, reads = write_inputs(wl, tmp_path)
    truth = tmp_path / "truth.gaf"
    synth.write_truth_gaf(wl, str(truth))
    code, out, _, gaf = assert_same_align(tmp_path, gfa, reads, ["-g", str(truth)])
    assert code == 0 and gaf.count(b"\n") >= 8
    assert out.count("\n") > 1      # the echo, then evalGFA's statistics


def test_unknown_preset_exits_1_with_the_reference_message(tmp_path):
    gfa, reads = write_inputs(synth.make_workload(seed=3, **SMALL), tmp_path)
    argv = ["align", "-f", gfa, "-r", reads, "-p", "nanopore"]
    want = run(jax_main, argv)
    got = run(torch_main, argv, device="cpu")
    assert got[:2] == want[:2] == (1, "Could not find preset: nanopore\n")


def test_seed_sample_variable_keeps_its_meaning(tmp_path, monkeypatch):
    gfa, reads = write_inputs(synth.make_workload(seed=41, **SEEDED), tmp_path)
    monkeypatch.setenv("GFALIGN_TPU_SEED_SAMPLE", "3")
    monkeypatch.setenv("GFALIGN_TORCH_SEED_SAMPLE", "3")
    assert_same_align(tmp_path, gfa, reads)


def test_fastq_reader_matches_jax(tmp_path):
    fq = tmp_path / "r.fq"
    fq.write_text("@a desc\nACGTN\n+\n~~~~~\n@b\nacgt\n+\n~~~~\n")
    fa = tmp_path / "r.fa"
    fa.write_text(">x y\nACG\nTTA\n\n>z\nGG\n")
    for path in (str(fq), str(fa), [str(fq), str(fa)]):
        assert fastq.load_reads(path) == jax_fastq.load_reads(path)
    np.testing.assert_array_equal(fastq.encode_seq("ACGTNacgtx"),
                                  jax_fastq.encode_seq("ACGTNacgtx"))


@pytest.mark.parametrize("sample_mod", [1, 3])
def test_seeding_matches_jax(sample_mod, tmp_path):
    wl = synth.make_workload(seed=41, **SEEDED)
    gfa, _ = write_inputs(wl, tmp_path)
    graph, jgraph = read_gfa(gfa), jax_read_gfa(gfa)
    index = seeding.KmerIndex(graph, k=13, sample_mod=sample_mod)
    jindex = jax_seeding.KmerIndex(jgraph, k=13, sample_mod=sample_mod)
    for field in ("kmers", "sids", "orients", "offs", "uniq", "starts"):
        np.testing.assert_array_equal(getattr(index, field),
                                      getattr(jindex, field), err_msg=field)
    codes = [fastq.encode_seq(seq) for _, seq in wl.reads]
    audits = [graph_align.CapAudit() for _ in codes]
    jaudits = [jax_graph_align.CapAudit() for _ in codes]
    got = seeding.anchors_with_diag_batch(index, codes, 4, audits=audits)
    assert got == jax_seeding.anchors_with_diag_batch(jindex, codes, 4,
                                                      audits=jaudits)
    assert [dict(a.counts) for a in audits] == [dict(a.counts) for a in jaudits]
    assert got[0] == index.anchors_with_diag(codes[0], 4)
    anchor = got[0][0][0]
    assert seeding.paths_around_anchor(graph, anchor, 600, 8) == \
        jax_seeding.paths_around_anchor(jgraph, anchor, 600, 8)


def test_device_pools_from_numpy_carries_the_jax_pools():
    jpools, _, reads, _ = _mini_arena_fixture()
    pools = graph_align.DevicePools.from_numpy(
        np.asarray(jpools.arena), np.asarray(jpools.cum_off),
        np.asarray(jpools.base_ptr), np.asarray(jpools.plen),
        np.asarray(jpools.reads), "cpu")
    assert pools.device == torch.device("cpu")
    assert (pools.p_cap, pools.s_cap, pools.lr_cap) == \
        (jpools.p_cap, jpools.s_cap, jpools.lr_cap)
    for name in ("arena", "cum_off", "base_ptr", "plen", "reads"):
        np.testing.assert_array_equal(getattr(pools, name).numpy(),
                                      np.asarray(getattr(jpools, name)), name)


def pools_pair():
    """The port's and the JAX package's pools over one small graph."""
    from gfalign_tpu.graph.model import Graph, Link

    rng = np.random.default_rng(2)
    graph = Graph()
    for i in range(24):
        graph.add_segment(f"s{i}", "".join("ACGT"[c] for c in
                                           rng.integers(0, 4, 20 + i)))
    for i in range(23):
        graph.links.append(Link(i, "+", i + 1, "+", "2M" if i % 3 == 0 else "0M"))
    work = [rng.integers(0, 4, n).astype(np.int8) for n in (30, 50, 17)]
    return (graph, work, graph_align.DevicePools([w.copy() for w in work], graph, "cpu"),
            jax_graph_align._DevicePools([w.copy() for w in work], graph))


def register(graph, pools, jpools, step_sets):
    lut = jax_graph_align.overlap_table(graph)
    rows = []
    for steps in step_sets:
        op = jax_graph_align.build_oriented(graph, steps, lut)
        rows.append((pools.path_idx(tuple(steps), op),
                     jpools.path_idx(tuple(steps), op)))
    pools.sync_paths()
    jpools.sync_paths()
    return rows


def assert_pools_equal(pools, jpools):
    assert (pools.p_cap, pools.s_cap) == (jpools.p_cap, jpools.s_cap)
    for name in ("arena", "cum_off", "base_ptr", "plen", "reads"):
        np.testing.assert_array_equal(getattr(pools, name).numpy(),
                                      np.asarray(getattr(jpools, name)), name)


def test_device_pools_grow_by_doubling_and_keep_earlier_rows():
    graph, _, pools, jpools = pools_pair()
    first = [[(i, "+"), (i + 1, "+")] for i in range(5)]
    rows = register(graph, pools, jpools, first)
    assert all(a == b for a, b in rows) and pools.p_cap == 8 and pools.s_cap == 8
    assert_pools_equal(pools, jpools)
    before = pools.cum_off[:5].clone()
    more = [[(i, "+"), (i + 1, "+"), (i + 2, "+")] for i in range(9)]
    more.append([(i, "+") for i in range(12)])              # 12 steps: s_cap 16
    more.append([(5, "-"), (4, "-")])                       # a reverse walk
    register(graph, pools, jpools, more)
    assert pools.p_cap == 16 and pools.s_cap == 16
    assert_pools_equal(pools, jpools)
    assert torch.equal(pools.cum_off[:5, :8], before)
    assert register(graph, pools, jpools, first) == rows    # looked up, not re-added


def test_device_pools_update_reads_after_masking():
    graph, work, pools, jpools = pools_pair()
    work[1][10:30] = seqalign.PAD
    work[2][:] = seqalign.PAD
    pools.update_reads([1, 2], work)
    jpools.update_reads([1, 2], work)
    pools.update_reads([], work)
    np.testing.assert_array_equal(pools.reads.numpy(), np.asarray(jpools.reads))
    assert (pools.reads[1, 10:30] == seqalign.PAD).all()


def test_overlong_overlap_path_is_irregular():
    """Overlap longer than the successor segment: the clamped n_bases makes
    the pools' unclamped-recurrence guard reject the path, and the caller
    scores it with the full DP on host arrays."""
    from gfalign_torch.graph.model import Graph, Link

    graph = Graph()
    graph.add_segment("a", "ACGTACGTAC")       # 10 bp
    graph.add_segment("b", "GTT")              # 3 bp, overlap 5 > len
    graph.links.append(Link(0, "+", 1, "+", "5M"))
    lut = graph_align.overlap_table(graph)
    steps = [(0, "+"), (1, "+")]
    op, codes = graph_align.build_oriented_codes(graph, steps, lut,
                                                 graph_align._SegCodes(graph))
    assert len(op) == len(codes) == 10          # clamped, not 10 + 3 - 5
    struct = graph_align.build_oriented_struct(graph, steps, lut)
    assert (len(struct), struct.offsets, struct.seg_lens) == \
        (len(op), op.offsets, op.seg_lens)
    pools = graph_align.DevicePools([np.zeros(8, np.int8)], graph, "cpu")
    assert pools.path_idx(tuple(steps), op) is None
    assert tuple(steps) in pools.irregular
    assert pools.path_idx(tuple(steps), op) is None


def test_path_building_matches_jax(tmp_path):
    wl = synth.make_workload(seed=3, **SMALL)
    gfa, _ = write_inputs(wl, tmp_path)
    graph, jgraph = read_gfa(gfa), jax_read_gfa(gfa)
    paths = graph_align.enumerate_paths(graph)
    jpaths = jax_graph_align.enumerate_paths(jgraph)
    assert [(p.steps, p.seq, p.offsets, p.seg_lens) for p in paths] == \
        [(p.steps, p.seq, p.offsets, p.seg_lens) for p in jpaths]
    assert [graph_align._mapq(60, s2) for s2 in (0, 30, 60, 90)] == \
        [jax_graph_align._mapq(60, s2) for s2 in (0, 30, 60, 90)]
    assert graph_align.PRESETS.keys() == jax_graph_align.PRESETS.keys()
    for name, params in graph_align.PRESETS.items():
        assert vars(params) == vars(jax_graph_align.PRESETS[name])


def test_align_reads_without_candidates_or_reads(tmp_path):
    wl = synth.make_workload(seed=41, **SEEDED)
    gfa, _ = write_inputs(wl, tmp_path)
    graph = read_gfa(gfa)
    assert graph_align.align_reads(graph, [], device="cpu") == []
    junk = [("junk", "ACGT" * 5), ("n", "N" * 40)]
    assert graph_align.align_reads(graph, junk, device="cpu") == \
        [("junk", 20, []), ("n", 40, [])]


# The names benchmark/modes/align.py and align_ul.py replace by assigning the
# module or class attribute, to sample and count the engine's work: the
# program must call each through that attribute at call time.
SEAMS = ["graph_align._align_seeded", "DevicePools.__init__",
         "DevicePools.path_idx", "DevicePools.update_reads",
         "seqalign.banded_arena_scores", "seqalign.traceback"]
_SEAM_GAF = {}


def seam_inputs(case, d):
    """"tails": SEEDED's reads, each with 80 random bases after it, so that
    a placed read keeps an uncovered stretch and a later round sends its
    masked row back to the pools; "walks": the CLR workload of
    tests/test_torch_seqalign.py's recorded walks, whose declined banded
    walks run full walks."""
    if case == "walks":
        kw, extra, _ = ALIGN_WALKS["clr-narrow"]
        paths = synth.write_workload(synth.make_workload(**kw), str(d))
        return paths["gfa"], paths["reads"], extra
    wl = synth.make_workload(seed=41, **SEEDED)
    gfa, _ = write_inputs(wl, d)
    rng = np.random.default_rng(5)
    reads = d / "tails.fa"
    reads.write_text("".join(
        f">{name}\n{seq}{''.join(rng.choice(list('ACGT'), 80))}\n"
        for name, seq in wl.reads))
    return gfa, str(reads), []


@pytest.mark.parametrize("seam", SEAMS)
def test_benchmark_seams_are_called_through_their_attributes(seam, tmp_path,
                                                             monkeypatch):
    """A counting wrapper assigned to each seam is called by a seeded align
    on the device ladder, and the GAF is the run's without it."""
    owner_name, name = seam.split(".")
    owner = {"graph_align": graph_align, "seqalign": seqalign,
             "DevicePools": graph_align.DevicePools}[owner_name]
    case = "walks" if seam == "seqalign.traceback" else "tails"
    gfa, reads, extra = seam_inputs(case, tmp_path)
    out = tmp_path / "out.gaf"
    argv = ["align", "-f", gfa, "-r", reads, "-o", str(out), *extra]
    if case not in _SEAM_GAF:
        assert run(torch_main, argv, device="cpu")[0] == 0
        _SEAM_GAF[case] = out.read_bytes()
    calls = []
    real = getattr(owner, name)

    def counting(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, counting)
    assert run(torch_main, argv, device="cpu")[0] == 0
    assert calls and out.read_bytes() == _SEAM_GAF[case]
    assert _SEAM_GAF[case].count(b"\n") >= 10
