"""The port's native host runtime (gfalign_torch/io/native.py and its own
copy of the C++ source, gfalign_torch/native/) against the JAX package's
library (gfalign_tpu.io.native) and against the port's Python oracles, on
inputs written by the port's synth and randomized pairs made from a seed.
Integer results are compared exactly; parsed files record for record."""

import gzip
import io
import os
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gfalign_tpu.io import native as jax_native
from gfalign_torch import synth
from gfalign_torch.engine import evaluate as TE
from gfalign_torch.engine import seeding
from gfalign_torch.engine.alignments import AlignmentSet
from gfalign_torch.engine.search import search
from gfalign_torch.io import cache
from gfalign_torch.io import native
from gfalign_torch.io.fastq import encode_seq, iter_reads, load_reads
from gfalign_torch.io.gfa import parse_gfa_lines, read_gfa
from gfalign_torch.io.stream import iter_lines
from gfalign_torch.io.writers import write_gfa1
from gfalign_torch.ops import seqalign
from gfalign_torch.ops.nw_path import (ORIENT_CODE, Step, encode_path_batch,
                                       nw_align_oracle, nw_best_scores,
                                       revcomp_path)
from gfalign_torch.parallel.score_step import local_step
from tests.test_search_differential import random_gaf_file, random_tangle
from tests.test_torch_goldens import port_search_inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent
SA = (seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP, seqalign.PAD, seqalign._BLOCK)


def _gz(path):
    out = pathlib.Path(str(path) + ".gz")
    with open(path, "rb") as fi, gzip.open(out, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    return str(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small synth workload written by the port: GFA, truth GAF, FASTQ,
    FASTA, each also gzipped."""
    d = tmp_path_factory.mktemp("torch_native")
    wl = synth.make_workload(seed=3, n_segments=120, n_reads=150, tangle_k=4,
                             seg_len=(60, 300), read_len=(200, 900))
    paths = port_search_inputs(wl, d)
    paths["reads"] = synth.write_workload(wl, d)["reads"]
    paths["fasta"] = str(d / "reads.fa")
    with open(paths["fasta"], "w") as fh:
        for name, seq in wl.reads:
            fh.write(f">{name} desc\n{seq[:70]}\n{seq[70:]}\n")
    for key in ("gfa", "gaf", "reads", "fasta"):
        paths[key + "_gz"] = _gz(paths[key])
    return wl, paths


def _graph_fingerprint(g):
    for sid in range(g.n_segments):
        g.segment(sid)
    text = io.StringIO()
    write_gfa1(g, text.write)
    return (text.getvalue(), dict(g.name_to_id),
            [(s.name, s.seq, s.length, tuple(s.tags)) for s in g.segments],
            [(e.s1, e.or1, e.s2, e.or2, e.overlap, tuple(e.tags)) for e in g.links])


# --------------------------------------------------------------- the build

def test_library_is_built_from_the_port_source_into_build():
    assert native.available()
    assert native.SOURCE == ROOT / "gfalign_torch" / "native" / "gfalign_host.cpp"
    assert native.LIB_PATH.is_relative_to(ROOT / "build" / "gfalign_torch")
    assert native.LIB_PATH.stat().st_mtime >= native.SOURCE.stat().st_mtime
    assert native._load()._name == str(native.LIB_PATH)
    assert ROOT / "build" in {ROOT / line.strip().rstrip("/") for line in
                              (ROOT / ".gitignore").read_text().splitlines()
                              if line.strip()}
    assert not list((ROOT / "gfalign_torch" / "native").glob("*.so"))


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f() { return undeclared_name_xyz; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name_xyz"):
        native.build(bad, tmp_path / "out" / "libbad.so")
    assert not list((tmp_path / "out").glob("libbad.so*"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    src = tmp_path / "ok.cpp"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz .* not found on PATH"):
        native.build(src, tmp_path / "libok.so")


def test_build_is_skipped_when_up_to_date_and_redone_when_stale(tmp_path):
    src = tmp_path / "ok.cpp"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    lib = tmp_path / "libok.so"
    assert native.build(src, lib) > 0
    assert native.build(src, lib) == 0.0
    newer = lib.stat().st_mtime + 5
    os.utime(src, (newer, newer))
    assert native.build(src, lib) > 0
    assert not list(tmp_path.glob("*.tmp"))


# ------------------------------------------------------------------ parsers

@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_gfa_parse_matches_jax_and_line_parser(files, gz):
    _, paths = files
    path = paths["gfa_gz" if gz else "gfa"]
    for mine, ref in zip(native.parse_gfa(path), jax_native.parse_gfa(path)):
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(mine, ref)
        else:
            assert mine == ref
    got = read_gfa(path)
    want = parse_gfa_lines(iter_lines(paths["gfa"]))
    assert _graph_fingerprint(got) == _graph_fingerprint(want)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_gaf_parse_matches_jax_and_record_path(files, gz, monkeypatch):
    _, paths = files
    path = paths["gaf_gz" if gz else "gaf"]
    mine = native.parse_gaf(path, want_tokens=True)
    ref = jax_native.parse_gaf(path, want_tokens=True)
    np.testing.assert_array_equal(np.asarray(mine[0]), np.asarray(ref[0]))
    for a, b in zip(mine[1:4], ref[1:4]):
        assert list(a) == list(b)
    for field in ("step_ids", "step_orients", "offsets"):
        np.testing.assert_array_equal(getattr(mine[4], field), getattr(ref[4], field))
    assert mine[4].names == ref[4].names

    columnar = AlignmentSet()
    columnar.load(path)
    assert columnar.tokens is not None
    monkeypatch.setattr(native, "available", lambda: False)
    records = AlignmentSet()
    records.load(path)
    assert records.tokens is None
    assert columnar.count == records.count > 0
    assert ([columnar.line_at(i) for i in range(columnar.count)]
            == [records.line_at(i) for i in range(records.count)])
    for attr in ("tot_qlen", "tot_algseq", "tot_plus", "tot_minus", "tot_plen",
                 "tot_mapq", "tot_matches", "tot_blocklen"):
        assert getattr(columnar, attr) == getattr(records, attr), attr


@pytest.mark.parametrize("kind", ["reads", "fasta"])
def test_fastx_parse_matches_jax_and_line_parser(files, kind):
    _, paths = files
    want = list(iter_reads(paths[kind]))
    assert len(want) == 150
    assert native.parse_fastx(paths[kind]) == jax_native.parse_fastx(paths[kind]) == want
    assert native.parse_fastx(paths[kind + "_gz"]) == want
    assert load_reads([paths[kind], paths[kind + "_gz"]]) == want + want


def test_missing_file_is_declined():
    assert native.parse_gaf("/nonexistent/x.gaf") is None
    assert native.parse_gfa("/nonexistent/x.gfa") is None


# ------------------------------------------------------------- tracebacks

def _random_pair(rng, trial):
    """A read and a path with N (4) and PAD (5) codes; every third trial
    embeds a shared prefix so that walks are long."""
    lr = int(rng.integers(1, 120))
    lp = int(rng.integers(1, 160))
    read = rng.integers(0, 6, size=lr).astype(np.int8)
    path = rng.integers(0, 6, size=lp).astype(np.int8)
    if trial % 3 == 0 and lr > 10:
        k = min(lr, lp) - 1
        path[:k] = read[:k] % 4
        read[:k] = read[:k] % 4
    return read, path


@pytest.mark.parametrize("seed", range(3))
def test_local_traceback_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    for trial in range(80):
        read, path = _random_pair(rng, trial)
        ei = int(rng.integers(0, len(read) + 1))
        ej = int(rng.integers(0, len(path) + 1))
        got = native.local_traceback(read, path, ei, ej, *SA)
        assert got == jax_native.local_traceback(read, path, ei, ej, *SA)
        want = seqalign._traceback_py(read, path, ei, ej)
        assert (got[0], got[1], got[2], got[3], got[4]) == (
            want.score, want.qstart, want.pstart, want.matches, want.nm)
        assert seqalign._runs(got[5]) == want.cigar


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("seed", range(3))
def test_banded_traceback_matches_oracle_and_jax(seed, width):
    """End cells from the banded scorer (gates pass), shifted ones (the end
    value differs from `expected`) and ones off the band."""
    rng = np.random.default_rng(100 + seed)
    passed = 0
    for trial in range(60):
        read, path = _random_pair(rng, trial)
        delta = int(rng.integers(-8, 9))
        best, bi, bj, _ = (x.numpy() for x in seqalign._banded_forward(
            torch.from_numpy(read[None]), torch.from_numpy(path[None]),
            torch.tensor([delta]), width=width))
        ei, ej, expected = int(bi[0]), int(bj[0]), int(best[0])
        if trial % 4 == 1:
            ej += int(rng.integers(1, width))          # may leave the band
        elif trial % 4 == 2:
            expected += 1                              # end-value gate fails
        args = (read, path, ei, ej, delta, width, expected)
        got = native.banded_local_traceback(*args, *SA)
        assert got == jax_native.banded_local_traceback(*args, *SA)
        assert got == seqalign._banded_traceback_py(*args)
        passed += got is not None
    assert passed > 10


def test_traceback_dispatch_counts_its_route(monkeypatch):
    rng = np.random.default_rng(9)
    read, path = _random_pair(rng, 0)
    monkeypatch.setattr(seqalign, "TRACEBACK_CALLS", {"native": 0, "python": 0})
    native_pl = seqalign.traceback(read, path, len(read), len(path))
    assert seqalign.TRACEBACK_CALLS == {"native": 1, "python": 0}
    monkeypatch.setattr(native, "available", lambda: False)
    assert seqalign.traceback(read, path, len(read), len(path)) == native_pl
    assert seqalign.banded_traceback(read, path, 3, 3, 0, 16, -1) is None
    assert seqalign.TRACEBACK_CALLS == {"native": 1, "python": 2}


# ----------------------------------------------------------- path-space NW

def _steps(rng, n, nodes=6):
    return [Step(rng.randrange(nodes), rng.choice("+-")) for _ in range(n)]


def _keys(path):
    return np.array([s.id * 4 + ORIENT_CODE[s.orientation] for s in path], np.int64)


def test_nw_path_walk_matches_oracle():
    rng = random.Random(2)
    id2n = lambda i: f"s{i}"
    for trial in range(150):
        a = _steps(rng, rng.randrange(1, 30))
        b = _steps(rng, rng.randrange(1, 30))
        if trial % 2:
            b = [s if rng.random() > 0.2 else _steps(rng, 1)[0] for s in a[:len(b)]] or b
        oracle = nw_align_oracle(a, b)
        score, ops = native.nw_path_walk(_keys(a), _keys(b))
        assert score == oracle.score
        assert (TE._alignment_string_from_ops(a, b, ops, id2n)
                == TE._alignment_string(oracle.a, oracle.b, id2n))


@pytest.mark.parametrize("seed", range(3))
def test_nw_batch_scorers_match_the_plain_k1_path(seed):
    rng = random.Random(seed)
    cands = [_steps(rng, rng.randrange(1, 14), 10) for _ in range(rng.randrange(1, 30))]
    reads = [_steps(rng, rng.randrange(0, 12), 10) for _ in range(rng.randrange(2, 50))]
    ak, al = encode_path_batch(cands, 16, pad_key=-1)
    bk, bl = encode_path_batch(reads, 16, pad_key=-2)
    want = nw_best_scores(*(torch.from_numpy(x) for x in (ak, al, bk, bl))).numpy()
    np.testing.assert_array_equal(native.nw_best_scores_batch(ak, al, bk, bl), want)
    rows = reads + [revcomp_path(r) for r in reads]
    rk, rl = encode_path_batch(rows, 16, pad_key=-2)
    fw = native.nw_best_scores_batch(ak, al, rk, rl, with_rc=False)
    np.testing.assert_array_equal(np.maximum(fw[:, :len(reads)], fw[:, len(reads):]), want)
    for filt in (True, False):
        tallies = native.nw_evaluate_frontier(ak, al, bk, bl, filt)
        plain = local_step(*(torch.from_numpy(x) for x in (ak, al, bk, bl)),
                           filter_alignments=filt).numpy().astype(np.int64)
        plain[:, 1] += int((bl == 0).sum())    # an empty read path is kept and good
        np.testing.assert_array_equal(tallies, plain)


def test_scoring_predicate_is_the_cpu_with_the_library():
    assert TE.native_scoring_ok("cpu") and TE.native_scoring_ok(torch.device("cpu"))
    assert not TE.native_scoring_ok("cuda")     # decided without touching a card
    assert not TE.native_scoring_ok("meta")


# ------------------------------------------------------- the banded ladder

def _ladder_inputs(rng, n_pairs=40, lens=(30, 400)):
    reads = [rng.integers(0, 5, int(rng.integers(*lens))).astype(np.int8)
             for _ in range(6)]
    paths = [rng.integers(0, 6, int(rng.integers(*lens))).astype(np.int8)
             for _ in range(5)]
    for r in reads[:3]:                   # related pairs: long diagonals
        paths.append(np.concatenate([rng.integers(0, 4, 20), r % 4]).astype(np.int8))

    def blob(seqs):
        lens = np.array([len(s) for s in seqs], np.int64)
        off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        return np.concatenate(seqs), off, lens

    rid = rng.integers(0, len(reads), n_pairs).astype(np.int32)
    pid = rng.integers(0, len(paths), n_pairs).astype(np.int32)
    deltas = rng.integers(-30, 31, n_pairs).astype(np.int32)
    return reads, paths, blob(reads), blob(paths), rid, pid, deltas


@pytest.mark.parametrize("width", [16, 24, 128])
@pytest.mark.parametrize("seed", range(2))
def test_seq_banded_pairs_matches_jax_and_the_plain_scorer(seed, width):
    rng = np.random.default_rng(seed)
    reads, paths, rb, pb, rid, pid, deltas = _ladder_inputs(rng)
    got = native.seq_banded_pairs(*rb, *pb, rid, pid, deltas, width,
                                  seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP,
                                  seqalign.PAD, seqalign._BLOCK)
    ref = jax_native.seq_banded_pairs(*rb, *pb, rid, pid, deltas, width,
                                      seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP,
                                      seqalign.PAD, seqalign._BLOCK)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for n in range(0, len(rid), 7):
        plain = seqalign._banded_forward(
            torch.from_numpy(reads[rid[n]][None]), torch.from_numpy(paths[pid[n]][None]),
            torch.tensor([int(deltas[n])]), width=width)
        assert tuple(int(x[0]) for x in plain) == tuple(int(x[n]) for x in got)


def test_int16_ladder_guard_takes_int32_for_a_wrapping_gap(monkeypatch):
    """With gap -2000 the int16 ladder's chain seed block + 16*gap is below
    -32768: the port's guard sends the pairs to the int32 ladder, which
    gives the plain scorer's result under the same constants, while the
    JAX package's library (the unfixed guard) wraps."""
    gap = -2000
    rng = np.random.default_rng(4)
    reads, paths, rb, pb, rid, pid, deltas = _ladder_inputs(rng, n_pairs=12,
                                                            lens=(40, 120))
    width = 32
    got = native.seq_banded_pairs(*rb, *pb, rid, pid, deltas, width, seqalign.MATCH,
                                  seqalign.MISMATCH, gap, seqalign.PAD, seqalign._BLOCK)
    monkeypatch.setattr(seqalign, "GAP", gap)
    for n in range(len(rid)):
        plain = seqalign._banded_forward(
            torch.from_numpy(reads[rid[n]][None]), torch.from_numpy(paths[pid[n]][None]),
            torch.tensor([int(deltas[n])]), width=width)
        assert tuple(int(x[0]) for x in plain) == tuple(int(x[n]) for x in got), n
    wrapped = jax_native.seq_banded_pairs(*rb, *pb, rid, pid, deltas, width,
                                          seqalign.MATCH, seqalign.MISMATCH, gap,
                                          seqalign.PAD, seqalign._BLOCK)
    assert not np.array_equal(wrapped[0], got[0])


# ----------------------------------------------------------------- seeding

@pytest.mark.parametrize("sample_mod", [1, 3], ids=["all", "sampled"])
def test_kmer_index_and_anchor_votes_match_numpy(files, sample_mod, monkeypatch):
    wl, _ = files
    reads = [encode_seq(seq) for _, seq in wl.reads[:60]]
    built = seeding.KmerIndex(wl.graph, k=15, sample_mod=sample_mod)
    assert built.uniq.dtype == np.int32                   # the native layout
    votes = seeding.anchors_with_diag_batch(built, reads, 12)
    per_read = [built.anchors_with_diag(r, 12) for r in reads]
    monkeypatch.setattr(native, "available", lambda: False)
    plain = seeding.KmerIndex(wl.graph, k=15, sample_mod=sample_mod)
    for field in ("kmers", "sids", "orients", "offs", "uniq", "starts"):
        np.testing.assert_array_equal(getattr(built, field), getattr(plain, field))
    want = seeding.anchors_with_diag_batch(plain, reads, 12)
    assert votes == want == per_read
    assert sum(map(len, want)) > 0


# ------------------------------------------------------------------ search

@pytest.mark.parametrize("seed", range(8))
def test_native_search_matches_the_python_driver(seed, tmp_path):
    rng = random.Random(seed)
    n_nodes = rng.randrange(4, 8)
    graph = random_tangle(rng, n_nodes)
    nodes = tmp_path / "nodes.tsv"
    nodes.write_text("".join(f"{i}\t{rng.randrange(1, 3)}\n"
                             for i in range(2, n_nodes) if rng.random() < 0.8))
    aln = AlignmentSet()
    aln.load(random_gaf_file(tmp_path, rng, n_nodes, rng.randrange(2, 10), seed))
    kw = dict(max_steps=500, return_all_paths=bool(rng.getrandbits(1)), device="cpu")
    outs = {}
    for use_native in (False, True):
        buf = io.StringIO()
        search(graph, aln, str(nodes), "1", str(n_nodes), out=buf,
               use_native=use_native, **kw)
        outs[use_native] = buf.getvalue()
    assert outs[True] == outs[False] and outs[True]


def test_search_default_route_and_profile(files, monkeypatch):
    """On the CPU the default takes the C++ driver (its profile counters
    move); with the predicate off it keeps the Python driver."""
    wl, paths = files
    graph = read_gfa(paths["gfa"])
    aln = AlignmentSet()
    aln.load(paths["gaf"])
    native.search_profile()                                    # reset
    outs = []
    for predicate in (True, False):
        monkeypatch.setattr(TE, "native_scoring_ok", lambda device, p=predicate: p)
        buf = io.StringIO()
        search(graph, aln, paths["search_nodelist"], wl.source, wl.destination,
               out=buf, device="cpu", max_steps=300)
        outs.append(buf.getvalue())
        total, ev, wait, waits = native.search_profile()
        assert (total > 0) == predicate and wait == 0 and waits == 0
    assert outs[0] == outs[1] and outs[0]


# ------------------------------------------------------------------- cache

def test_cache_round_trip_and_invalidation(files, tmp_path, monkeypatch):
    _, paths = files
    monkeypatch.setenv("GFALIGN_TORCH_CACHE", str(tmp_path / "cache"))
    cold = AlignmentSet()
    cold.load(paths["gaf"])
    assert len(list((tmp_path / "cache").glob("gaf-*.npz"))) == 1
    warm = AlignmentSet()
    warm.load(paths["gaf"])
    assert [warm.line_at(i) for i in range(warm.count)] == \
        [cold.line_at(i) for i in range(cold.count)]
    assert warm.tot_qlen == cold.tot_qlen
    np.testing.assert_array_equal(warm.tokens.step_ids, cold.tokens.step_ids)
    assert warm.tokens.names == cold.tokens.names
    assert cache.load_gaf_cache(paths["gaf"]) is not None

    gaf = tmp_path / "x.gaf"
    gaf.write_text("r1\t10\t0\t10\t+\t>a\t10\t0\t10\t10\t10\t60\n")
    one = AlignmentSet()
    one.load(str(gaf))
    assert one.count == 1
    gaf.write_text("r1\t10\t0\t10\t+\t>a\t10\t0\t10\t10\t10\t60\n"
                   "r2\t10\t0\t10\t+\t>b\t10\t0\t10\t10\t10\t60\n")
    two = AlignmentSet()
    two.load(str(gaf))
    assert two.count == 2                  # size/mtime key: the stale entry is not served


def test_cache_is_off_without_the_variable(files, monkeypatch):
    monkeypatch.delenv("GFALIGN_TORCH_CACHE", raising=False)
    assert cache.cache_dir() is None
    assert cache.load_gaf_cache(files[1]["gaf"]) is None


def test_threads_are_settable():
    try:
        native.set_threads(2)
        assert native.user_threads() == 2
    finally:
        native.set_threads(0)
    assert native.user_threads() == 0


def test_sanitizer_harness_builds_against_the_port_source(tmp_path):
    """sanitize_test.cpp includes the production translation unit: it
    compiles against the port's copy (without sanitizers, for speed)."""
    src = ROOT / "gfalign_torch" / "native" / "sanitize_test.cpp"
    done = subprocess.run(["g++", "-std=c++17", "-O0", "-pthread", "-fsyntax-only",
                           str(src)], capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
