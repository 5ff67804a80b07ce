"""Frontier tallies of the port (parallel/score_step.local_step and
engine/evaluate.evaluate_candidates) against the JAX package's
evaluate_candidates and _local_step, with the membership filter on and off.
Tallies are int32 and compared with tolerance zero.  The tests that call
evaluate_candidates run both CPU routes (`scoring_route`): the plain torch
device step, and the native host scorer that `native_scoring_ok` picks on
the CPU by default."""

import random

import numpy as np
import pytest
import torch

from gfalign_tpu.engine import evaluate as JE
from gfalign_tpu.ops.nw_path import Step
from gfalign_tpu.parallel.score_step import _local_step
from gfalign_torch.engine import evaluate as TE
from gfalign_torch.parallel.score_step import local_step


def random_path(rng, max_nodes, max_len, min_len=1):
    return [Step(rng.randrange(max_nodes), rng.choice("+-"))
            for _ in range(rng.randrange(min_len, max_len))]


def random_frontier(seed):
    """A frontier of candidates and a read set that includes an empty read
    path (a GAF record with path '*')."""
    rng = random.Random(seed)
    nodes = rng.randrange(4, 12)
    cands = [random_path(rng, nodes, 12) for _ in range(rng.randrange(1, 40))]
    reads = [random_path(rng, nodes, 10, min_len=0)
             for _ in range(rng.randrange(2, 60))]
    reads.append([])
    return cands, reads


def _tallies(scores):
    return [(s.bad, s.good, s.unaligned) for s in scores]


@pytest.fixture(params=["torch", "native"])
def scoring_route(request, monkeypatch):
    """The CPU scoring route under test: "torch" turns the native predicate
    off (the plain device step), "native" keeps the default (the C++ batch
    scorer)."""
    if request.param == "torch":
        monkeypatch.setattr(TE, "native_scoring_ok", lambda device: False)
    else:
        assert TE.native_scoring_ok("cpu")
    return request.param


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
@pytest.mark.parametrize("seed", range(6))
def test_evaluate_candidates_match_jax(seed, filt, scoring_route):
    cands, reads = random_frontier(seed)
    want = _tallies(JE.evaluate_candidates(cands, reads, filt))
    got = _tallies(TE.evaluate_candidates(cands, reads, filt, device="cpu"))
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_local_step_matches_jax_local_step(seed):
    """The device step alone, against the JAX per-device step (XLA scorer),
    on padded tensors whose pad reads carry b_len == 0."""
    cands, reads = random_frontier(50 + seed)
    reads = [r for r in reads if r]
    jb = JE.ReadBatch(reads)
    R = len(reads)
    b_keys = np.concatenate([jb.b_keys, np.full((8, jb.m), -2, np.int32)])
    b_len = np.concatenate([jb.lengths, np.zeros(8, np.int32)])
    n = 16
    a_keys = np.full((len(cands) + 3, n), -1, np.int32)
    a_len = np.zeros(len(cands) + 3, np.int32)
    for i, c in enumerate(cands):
        a_keys[i, :len(c)] = [s.id * 4 + (s.orientation == "-") for s in c]
        a_len[i] = len(c)
    want = np.asarray(_local_step(a_keys, a_len, b_keys, b_len))
    got = local_step(*(torch.from_numpy(x) for x in (a_keys, a_len, b_keys, b_len)),
                     filter_alignments=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    nofilt = local_step(*(torch.from_numpy(x) for x in (a_keys, a_len, b_keys, b_len)),
                        filter_alignments=False).numpy()
    np.testing.assert_array_equal(nofilt[:, 2], 0)
    np.testing.assert_array_equal(nofilt[:, :2].sum(1), R)


@pytest.mark.parametrize("seed", range(3))
def test_read_batch_from_jax_arrays_gives_identical_tallies(seed, scoring_route):
    cands, reads = random_frontier(100 + seed)
    jb = JE.ReadBatch(reads)
    tb = TE.ReadBatch.from_arrays(jb.b_keys, jb.lengths, jb.ids, device="cpu")
    direct = TE.ReadBatch(reads, device="cpu")
    np.testing.assert_array_equal(tb.b_keys, direct.b_keys)
    np.testing.assert_array_equal(tb.lengths, direct.lengths)
    for filt in (True, False):
        want = _tallies(JE.evaluate_candidates(cands, jb, filt))
        assert _tallies(TE.evaluate_candidates(cands, tb, filt)) == want


def test_read_batch_from_arrays_rejects_mismatched_ids():
    jb = JE.ReadBatch([[Step(1, "+"), Step(2, "-")], [Step(3, "+")]])
    ids = jb.ids.copy()
    ids[0, 1] = 7
    with pytest.raises(ValueError):
        TE.ReadBatch.from_arrays(jb.b_keys, jb.lengths, ids, device="cpu")


def test_device_keys_pad_to_cpu_quantum():
    batch = TE.ReadBatch([[Step(1, "+")]] * 11, device="cpu")
    b_keys, b_len = batch.device_keys()
    assert b_keys.shape == (16, batch.m) and b_len.shape == (16,)
    assert int(b_len[11:].abs().sum()) == 0
    assert batch.device_keys()[0] is b_keys  # uploaded once


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
@pytest.mark.parametrize("seed", range(4))
def test_evaluate_candidates_shuffled_reads_match_jax(seed, filt, scoring_route):
    """The port scores in the read operand's length-sorted order; the
    tallies are sums over reads, so a ReadBatch whose reads come in any
    order gives the JAX package's tallies."""
    cands, reads = random_frontier(200 + seed)
    want = _tallies(JE.evaluate_candidates(cands, reads, filt))
    shuffled = list(reads)
    random.Random(seed).shuffle(shuffled)
    batch = TE.ReadBatch(shuffled, device="cpu")
    assert _tallies(TE.evaluate_candidates(cands, batch, filt)) == want
    operand, side = batch.prepared()
    assert batch.prepared().operand is operand         # prepared once
    assert operand.ns == 2 and operand.R == batch.device_keys()[0].shape[0]
    assert (np.diff(operand.b_len.numpy()) <= 0).all()
    np.testing.assert_array_equal(side.b_ids.numpy(),
                                  np.where(operand.keys.numpy() >= 0,
                                           operand.keys.numpy() >> 2, -2))
    np.testing.assert_array_equal(side.valid.numpy()[0], operand.keys.numpy() >= 0)
    np.testing.assert_array_equal(side.real.numpy()[0], operand.b_len.numpy() > 0)


@pytest.mark.parametrize("seed", range(3))
def test_local_step_prepared_matches_local_step(seed):
    from gfalign_torch.parallel.score_step import local_step_prepared, prepare_reads

    cands, reads = random_frontier(300 + seed)
    jb = JE.ReadBatch(reads)
    tb = TE.ReadBatch.from_arrays(jb.b_keys, jb.lengths, jb.ids, device="cpu")
    a_keys, a_len = (torch.from_numpy(x) for x in TE.encode_frontier(cands))
    b_keys, b_len = tb.device_keys()
    reads = prepare_reads(b_keys, b_len)                # the kernels' 128-row blocks
    assert reads.operand.Rp % 128 == 0
    for filt in (True, False):
        want = local_step(a_keys, a_len, b_keys, b_len, filt)
        assert torch.equal(local_step_prepared(a_keys, a_len, reads, filt), want)
        via_bridge = local_step_prepared(a_keys, a_len, tb.prepared(), filt)
        assert torch.equal(via_bridge, want)


@pytest.mark.parametrize("chunk_elems", [1 << 26, 64], ids=["one-chunk", "chunked"])
@pytest.mark.parametrize("seed", range(3))
def test_offending_steps_match_brute_force(seed, chunk_elems, monkeypatch):
    """The membership filter against a set-based count: full-width and empty
    candidates, candidate nodes no read visits, read nodes on no candidate,
    empty reads, one chunk of candidates and several."""
    from gfalign_torch.parallel import score_step

    monkeypatch.setattr(score_step, "_MEMBER_CHUNK_ELEMS", chunk_elems)
    rng = np.random.default_rng(seed)
    C, n, R, m = 9, 4, 21, 6
    a_ids = rng.integers(0, 12, (C, n))
    a_len = rng.integers(0, n + 1, C)
    a_len[0], a_len[1] = n, 0
    a_keys = np.where(np.arange(n)[None, :] < a_len[:, None],
                      a_ids * 4 + rng.integers(0, 2, (C, n)), -1).astype(np.int32)
    b_ids = rng.integers(3, 20, (R, m))
    b_len = rng.integers(0, m + 1, R).astype(np.int32)
    b_len[0], b_len[1] = m, 0
    b_keys = np.where(np.arange(m)[None, :] < b_len[:, None],
                      b_ids * 4 + rng.integers(0, 2, (R, m)), -2).astype(np.int32)
    want = np.array([[sum(int(b_ids[r, j]) not in set(a_ids[c, :a_len[c]].tolist())
                          for j in range(b_len[r])) for r in range(R)] for c in range(C)])
    side = score_step.read_side(torch.from_numpy(b_keys), torch.from_numpy(b_len))
    got = score_step._offending_steps(torch.from_numpy(a_keys), side)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = score_step.read_side(torch.full((3, m), -2, dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int32))
    assert int(score_step._offending_steps(torch.from_numpy(a_keys), empty).abs().sum()) == 0
