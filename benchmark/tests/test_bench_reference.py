"""The benchmark's generator and plain references against the port, at a
small size on the CPU: the port parses what the generator writes, the
search reference prints the port's lines, the align reference passes the
port's records and the path alignment scores as the port's oracle."""

import contextlib
import io
import random

import numpy as np
import pytest

from benchmark import workload
from benchmark.reference import align as ref_align
from benchmark.reference import search as ref_search

SMALL = dict(n_segments=80, n_reads=60, seg_len=(120, 400), read_len=(300, 900),
             tangle_k=5, tangle_seg_len=(500, 1200), filter_margin=6)


def test_generator_is_the_ports_at_its_defaults(tmp_path):
    from gfalign_torch import synth
    from gfalign_torch.io.writers import write_gfa1

    kw = dict(seed=2 ** 33 + 5, n_segments=60, n_reads=40, seg_len=(120, 400),
              read_len=(300, 900))
    ours, port = workload.make_workload(**kw), synth.make_workload(**kw)
    workload.write_gfa(ours, str(tmp_path / "a.gfa"))
    buf = io.StringIO()
    write_gfa1(port.graph, buf.write)
    assert (tmp_path / "a.gfa").read_text() == buf.getvalue()
    assert ours.reads == port.reads
    workload.write_truth_gaf(ours, str(tmp_path / "a.gaf"))
    synth.write_truth_gaf(port, str(tmp_path / "b.gaf"))
    assert (tmp_path / "a.gaf").read_text() == (tmp_path / "b.gaf").read_text()


def test_the_port_parses_what_it_writes(tmp_path):
    from gfalign_torch.engine.alignments import AlignmentSet
    from gfalign_torch.io.fastq import load_reads
    from gfalign_torch.io.gfa import read_gfa

    wl = workload.make_workload(seed=3, **SMALL)
    workload.write_gfa(wl, str(tmp_path / "g.gfa"))
    workload.write_fastq(wl.reads, str(tmp_path / "r.fq"))
    n = workload.write_truth_gaf(wl, str(tmp_path / "t.gaf"), wl.filter_nodelist)
    g = read_gfa(str(tmp_path / "g.gfa"))
    assert [g.segment(i).name for i in range(g.n_segments)] == wl.names
    assert all(g.segment(i).seq == wl.seqs[nm] for i, nm in enumerate(wl.names))
    assert len(g.links) == len(wl.links)
    assert load_reads(str(tmp_path / "r.fq")) == wl.reads
    s = AlignmentSet()
    s.load(str(tmp_path / "t.gaf"))
    assert 0 < n == len(s.paths_as_ids(g.name_to_id)) < len(wl.reads)


def test_error_model_rates():
    raw = workload._rand_seq(random.Random(1), 200000)
    out = workload._apply_errors(random.Random(2), raw, 0.02, 0.06, 0.05)
    assert abs(len(out) / len(raw) - 1.01) < 0.003


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_path_score_is_the_ports_oracle(seed):
    from gfalign_torch.ops.nw_path import Step, nw_score_oracle

    rng = random.Random(seed)
    for _ in range(300):
        a = [(rng.randrange(4), rng.choice("+-")) for _ in range(rng.randint(1, 9))]
        b = [(rng.randrange(4), rng.choice("+-")) for _ in range(rng.randint(1, 9))]
        want = nw_score_oracle([Step(*s) for s in a], [Step(*s) for s in b])
        assert ref_search.path_score(a, b) == want


def _port(argv):
    from gfalign_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, device="cpu") == 0
    return buf.getvalue()


@pytest.mark.parametrize("seed,window", [(5, False), (6, True), (2 ** 31 + 7, False)])
def test_search_reference_prints_the_ports_lines(tmp_path, seed, window):
    wl = workload.make_workload(seed=seed, **SMALL)
    workload.write_gfa(wl, str(tmp_path / "g.gfa"))
    keep = wl.filter_nodelist if window else None
    workload.write_truth_gaf(wl, str(tmp_path / "t.gaf"), keep)
    (tmp_path / "n.tsv").write_text("".join(r + "\n" for r in wl.search_nodelist))
    got = _port(["search", "-f", str(tmp_path / "g.gfa"), "-g", str(tmp_path / "t.gaf"),
                 "-n", str(tmp_path / "n.tsv"), "-s", wl.source, "-d", wl.destination,
                 "--return-all-paths"])
    walks = [w for _, w, _ in workload.truth_records(wl)
             if keep is None or workload.in_window(w, keep)]
    want = ref_search.search_rows(wl.names, wl.links, wl.search_nodelist,
                                  wl.source, wl.destination,
                                  [[(n, "+") for n in w] for w in walks],
                                  return_all=True)
    assert got.splitlines() == want
    assert any(int(r.split("\t")[2]) > 0 for r in want)     # reads count
    control = ref_search.search_rows(wl.names, wl.links, wl.search_nodelist,
                                     wl.source, wl.destination,
                                     [[(n, "+") for n in w] for w in walks],
                                     return_all=True, both_strands=False)
    assert control != want


def test_align_reference_passes_the_ports_records(tmp_path):
    wl = workload.make_workload(seed=9, sub_rate=0.001, ins_rate=0.0005,
                                del_rate=0.0005, **SMALL)
    workload.write_gfa(wl, str(tmp_path / "g.gfa"))
    workload.write_fastq(wl.reads[:20], str(tmp_path / "r.fq"))
    _port(["align", "-f", str(tmp_path / "g.gfa"), "-r", str(tmp_path / "r.fq"),
           "-o", str(tmp_path / "o.gaf"), "-p", "hifi"])
    recs = ref_align.first_records((tmp_path / "o.gaf").read_text().splitlines())
    links = ref_align.link_set(wl.links)
    assert len(recs) == 20
    for name, seq in wl.reads[:20]:
        for ln in recs[name]:
            faults, score, rec = ref_align.check_record(ln, (name, seq), wl.seqs, links, 20)
            assert faults == [] and score >= 20
        # a record altered anywhere is caught
        ln = recs[name][0].split("\t")
        ln[9] = str(int(ln[9]) + 1)
        assert ref_align.check_record("\t".join(ln), (name, seq), wl.seqs, links, 20)[0]


def test_corridor_best_is_the_full_local_optimum():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a = rng.integers(0, 4, rng.integers(30, 60)).astype(np.uint8)
        b = rng.integers(0, 4, rng.integers(30, 60)).astype(np.uint8)
        b[5:25] = a[3:23]           # a shared stretch, as a read on its path
        full = _sw(a, b)
        got = ref_align.corridor_best([a], [b], [-len(a) - 1], [len(b) + 1])[0][0]
        assert got == full
        score, qs, qe, ps, pe, runs = ref_align.corridor_align(a, b, -len(a) - 1, len(b) + 1)
        assert score == full == ref_align.cigar_score(runs)
        assert sum(n for n, op in runs if op != "D") == qe - qs
        assert sum(n for n, op in runs if op != "I") == pe - ps


def test_int8_saturates():
    a = np.zeros(400, np.uint8)
    assert ref_align.corridor_best([a], [a], [-2], [2])[0][0] == 400
    assert ref_align.corridor_best([a], [a], [-2], [2], int8=True)[0][0] == 127
    score, qs, qe, ps, pe, runs = ref_align.corridor_align(a, a, -2, 2, int8=True)
    assert score == 127 and runs == [(127, "=")] and qe - qs == 127


def _sw(a, b):
    H = np.zeros((len(a) + 1, len(b) + 1), np.int64)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            s = 1 if a[i - 1] == b[j - 1] else -2
            H[i, j] = max(0, H[i - 1, j - 1] + s, H[i - 1, j] - 3, H[i, j - 1] - 3)
    return int(H.max())


@pytest.mark.parametrize("width", [16, 64])
def test_banded_check_passes_the_ports_banded_scorer(width):
    """The reference's banded DP agrees with the port's plain banded scorer
    (the plain version of K3) on pairs near and off their anchor
    diagonal; an answer raised by one, or an end cell moved off the
    optimum, is a fault."""
    import torch

    from gfalign_torch.ops import seqalign

    rng = np.random.default_rng(2 ** 32 + 9)
    reads, paths, deltas = [], [], []
    for k in range(12):
        path = rng.integers(0, 4, int(rng.integers(200, 400)))
        start = int(rng.integers(0, 100))
        read = path[start:start + int(rng.integers(80, 160))].copy()
        flip = rng.random(len(read)) < 0.05
        read[flip] = (read[flip] + 1) % 4
        if k % 3 == 0:
            read = rng.integers(0, 4, len(read))      # no alignment to find
        reads.append(read.astype(np.int8))
        paths.append(path.astype(np.int8))
        deltas.append(start + int(rng.integers(-width // 3, width // 3 + 1)))
    lr = max(map(len, reads))
    lp = max(map(len, paths))
    rc = torch.full((len(reads), lr), seqalign.PAD, dtype=torch.int8)
    pc = torch.full((len(reads), lp), seqalign.PAD, dtype=torch.int8)
    for k, (r, p) in enumerate(zip(reads, paths)):
        rc[k, :len(r)] = torch.from_numpy(r)
        pc[k, :len(p)] = torch.from_numpy(p)
    plens = torch.tensor([len(p) for p in paths], dtype=torch.int32)
    strip = seqalign.assemble_strip(
        pc.reshape(-1), torch.zeros((len(reads), 1), dtype=torch.int32),
        (torch.arange(len(reads), dtype=torch.int32) * lp)[:, None], plens,
        torch.tensor(deltas, dtype=torch.int32), lr + width, shift=0,
        w2=width // 2)
    got = [x.numpy().astype(np.int64) for x in seqalign._banded_forward_core(
        rc, strip, torch.tensor(deltas, dtype=torch.int32), plens, width=width)]
    assert got[0].max() > 50
    ok = ref_align.banded_check(reads, paths, deltas, width, got, block=5)
    assert not ok.any()
    raised = [got[0] + (got[0] > 0), *got[1:]]
    assert ref_align.banded_check(reads, paths, deltas, width, raised).sum() \
        == (got[0] > 0).sum()
    moved = [got[0], got[1], got[2] + (got[0] > 0), got[3]]
    assert ref_align.banded_check(reads, paths, deltas, width, moved).any()
