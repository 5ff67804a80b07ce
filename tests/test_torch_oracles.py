"""The port's host oracles, as the JAX package's own tests use theirs:
ReadBatch.filter_against / filter_mask (the membership filter on the
host) against the JAX package's and the device filter, the port's search
against a per-read NW oracle evaluator built on them (the checks of
tests/test_search_differential.py), and the vectorized duplicate walk
against the scalar _dup_stats_oracle (the fuzz of tests/test_dist.py)."""

import io
import random

import numpy as np
import pytest
import torch

from gfalign_tpu.engine import alignments as jax_alignments
from gfalign_tpu.engine import evaluate as jax_evaluate
from gfalign_torch.engine.alignments import (AlignmentSet, GafRecord, _dup_stats_oracle,
                                             _dup_stats_walk)
from gfalign_torch.engine.evaluate import PathScore, ReadBatch, filter_mask
from gfalign_torch.engine.search import search
from gfalign_torch.graph.model import Graph, Link
from gfalign_torch.ops.nw_path import Step, nw_score_oracle, revcomp_path
from gfalign_torch.parallel import score_step
from tests.test_dist import _random_gaf_lines


def batch_paths(batch):
    """The read paths a ReadBatch packs, decoded from its keys."""
    return [[Step(int(k) >> 2, "+-0"[int(k) & 3]) for k in keys[:n]]
            for keys, n in zip(batch.b_keys, batch.lengths)]


def oracle_evaluator(candidates, read_batch, filter_alignments=True):
    read_paths = batch_paths(read_batch)
    out = []
    for cand in candidates:
        score = PathScore()
        if filter_alignments:
            keep, score.unaligned = read_batch.filter_against({s[0] for s in cand})
        else:
            keep = [True] * len(read_paths)
        for i, rp in enumerate(read_paths):
            if not keep[i]:
                continue
            best = max(nw_score_oracle(cand, rp),
                       nw_score_oracle(cand, revcomp_path(rp)))
            if best < 0:
                score.bad += 1
            else:
                score.good += 1
        out.append(score)
    return out


def random_read_paths(rng, n_reads, n_nodes, longest=6):
    return [[Step(rng.randrange(n_nodes), rng.choice("+-"))
             for _ in range(rng.randrange(0, longest + 1))] for _ in range(n_reads)]


@pytest.mark.parametrize("seed", range(6))
def test_filter_against_matches_jax_and_the_device_filter(seed):
    rng = random.Random(seed)
    n_nodes = rng.randrange(3, 12)
    paths = random_read_paths(rng, rng.randrange(0, 30), n_nodes)
    batch = ReadBatch(paths, "cpu")
    jax_batch = jax_evaluate.ReadBatch(paths)
    side = score_step.read_side(torch.from_numpy(batch.b_keys),
                                torch.from_numpy(batch.lengths))
    for _ in range(8):
        cand = [Step(rng.randrange(n_nodes), rng.choice("+-"))
                for _ in range(rng.randrange(1, 7))]
        ids = {s.id for s in cand}
        keep, unaligned = batch.filter_against(ids)
        want_keep, want_unaligned = jax_batch.filter_against(ids)
        np.testing.assert_array_equal(keep, want_keep)
        assert unaligned == want_unaligned
        got_mask = filter_mask(cand, paths)
        np.testing.assert_array_equal(got_mask[0], keep)
        assert got_mask[1] == unaligned
        assert jax_evaluate.filter_mask(cand, paths)[1] == unaligned
        if batch.R:
            a_keys = torch.tensor([[s.id * 4 + "+-".index(s.orientation) for s in cand]],
                                  dtype=torch.int32)
            off = score_step._offending_steps(a_keys, side)[0].numpy()
            np.testing.assert_array_equal(off == 0, keep)
            assert int(off.sum()) == unaligned


def random_tangle(rng, n_nodes):
    """tests/test_search_differential.py's tangle in the port's model."""
    graph = Graph()
    for i in range(n_nodes):
        graph.add_segment(str(i + 1), "A" * rng.randrange(5, 20))
    for a in range(n_nodes):
        for b in range(a + 1, n_nodes):
            if rng.random() < 0.7:
                graph.links.append(Link(a, "+", b, "+"))
    for _ in range(rng.randrange(0, n_nodes)):
        a, b = rng.randrange(n_nodes), rng.randrange(n_nodes)
        graph.links.append(Link(a, rng.choice("+-"), b, rng.choice("+-")))
    return graph


def run_differential(seed, tmp_path):
    """The port's search (device route on the CPU, and the C++ driver)
    against the oracle evaluator on one random tangle and read set."""
    rng = random.Random(seed)
    n_nodes = rng.randrange(4, 8)
    graph = random_tangle(rng, n_nodes)
    node_file = tmp_path / "nodes.tsv"
    lines = [f"{i}\t{rng.randrange(1, 3)}" for i in range(2, n_nodes) if rng.random() < 0.8]
    node_file.write_text("\n".join(lines) + "\n")
    gaf_lines = []
    for i in range(rng.randrange(2, 10)):
        steps = "".join(rng.choice("><") + str(rng.randrange(n_nodes) + 1)
                        for _ in range(rng.randrange(1, 6)))
        gaf_lines.append(f"rd{i}\t50\t0\t50\t+\t{steps}\t50\t0\t50\t50\t50\t60")
    gaf = tmp_path / f"reads{seed}.gaf"
    gaf.write_text("\n".join(gaf_lines) + "\n")
    alignments = AlignmentSet()
    alignments.load(str(gaf))
    kwargs = dict(node_file=str(node_file), source="1", destination=str(n_nodes),
                  max_steps=500, min_nodes=0, return_all_paths=bool(rng.getrandbits(1)),
                  device="cpu")
    outs = []
    for extra in (dict(use_native=False), dict(use_native=True),
                  dict(evaluate_fn=oracle_evaluator)):
        buf = io.StringIO()
        search(graph, alignments, out=buf, **kwargs, **extra)
        outs.append(buf.getvalue())
    assert outs[0] == outs[2] and outs[1] == outs[2]
    return len(outs[0].splitlines())


@pytest.mark.parametrize("seed", range(8))
def test_search_matches_the_oracle_evaluator(seed, tmp_path):
    run_differential(seed, tmp_path)


def test_differential_seeds_have_coverage(tmp_path):
    """The random seeds print search rows (the generator does not make
    unreachable destinations only)."""
    total = 0
    for seed in range(8):
        sub = tmp_path / str(seed)
        sub.mkdir()
        total += run_differential(seed, sub)
    assert total >= 8


@pytest.mark.parametrize("seed", [31, 32])
def test_dup_stats_walk_matches_the_scalar_oracle(seed):
    """The vectorized walk (the core of mark_duplicates) against the
    scalar transcription, fuzzed over random duplicate, leak and terminal
    patterns: counters and terminal pairs in emission order, the port's
    oracle equal to the JAX package's."""
    rng = random.Random(seed)
    for _ in range(20):
        lines = _random_gaf_lines(rng)
        a = AlignmentSet()
        a._records = []
        for pos, line in enumerate(lines):
            rec = GafRecord.from_line(line, pos)
            a._records.append(rec)
            a._accumulate(rec)
        a.sort_by_name()
        a.mark_duplicates()
        qnames = [a.qname_at(i) for i in range(a.count)]
        cols = np.array([[a.numeric_at(i, c) for c in (1, 2, 4, 5, 6)]
                         for i in range(a.count)], dtype=np.int64)
        walk = _dup_stats_walk(qnames, cols, collect_pairs=True)
        oracle = _dup_stats_oracle(qnames, cols, collect_pairs=True)
        assert walk == oracle
        assert oracle == jax_alignments._dup_stats_oracle(qnames, cols, collect_pairs=True)
        assert walk[:4] == (a.primary, a.secondary, a.supplementary,
                            a.terminal_supplementary)
