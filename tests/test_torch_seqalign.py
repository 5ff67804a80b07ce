"""The port's plain align-mode scorers (gfalign_torch/ops/seqalign.py, CPU)
against the JAX package: the XLA scans and the Pallas kernels in interpret
mode, on the same numpy inputs.  Everything is int32 or bool, so the
tolerance is exact equality."""

import numpy as np
import pytest
import torch

from gfalign_tpu.ops import seqalign as jax_seqalign
from gfalign_tpu.ops import seqalign_pallas as jax_pallas
from gfalign_torch.engine.graph_align import DevicePools
from gfalign_torch.ops import seqalign
from tests.test_align_banded import _mini_arena_fixture

PAD = seqalign.PAD


def code_grid(rng, rows, width, alphabet=5):
    """int8 codes 0..alphabet-1 with PAD tails, mid-row PAD masks, N codes
    (4, when alphabet is 5) and one all-PAD row."""
    a = rng.integers(0, alphabet, (rows, width)).astype(np.int8)
    for i in range(rows):
        a[i, int(rng.integers(0, width + 1)):] = PAD
        if i % 3 == 0:
            lo = int(rng.integers(0, width))
            a[i, lo:int(rng.integers(lo, width))] = PAD
    a[0, :] = PAD
    return a


def as_np(outs):
    return [np.asarray(x) for x in outs]


def assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_constants_match_the_jax_package():
    for name in ("MATCH", "MISMATCH", "GAP", "PAD", "_BLOCK"):
        assert getattr(seqalign, name) == getattr(jax_seqalign, name), name
    assert seqalign.Placement._fields == jax_seqalign.Placement._fields


@pytest.mark.parametrize("seed", range(4))
def test_local_forward_matches_xla_and_pallas(seed):
    rng = np.random.default_rng(100 + seed)
    alphabet = 2 if seed % 2 else 5          # a tiny alphabet makes ties
    reads = code_grid(rng, 9, int(rng.integers(5, 40)), alphabet)
    paths = code_grid(rng, 7, int(rng.integers(5, 50)), alphabet)
    got = as_np(seqalign.batched_local_scores(reads, paths))
    assert got[0].shape == (9, 7) and got[0].dtype == np.int32
    assert_all_equal(got, jax_seqalign._jitted_forward()(reads, paths))
    assert_all_equal(got, jax_pallas.local_forward_pallas(reads, paths,
                                                          interpret=True))


@pytest.mark.parametrize("seed", range(4))
def test_local_forward_pairs_matches_xla_and_pallas(seed):
    rng = np.random.default_rng(200 + seed)
    alphabet = 2 if seed % 2 else 5
    reads = code_grid(rng, 11, int(rng.integers(5, 40)), alphabet)
    paths = code_grid(rng, 11, int(rng.integers(5, 50)), alphabet)
    got = as_np(seqalign.batched_pair_scores(reads, paths))
    assert got[0].shape == (11,)
    assert_all_equal(got, jax_seqalign._jitted_forward_pairs()(reads, paths))
    assert_all_equal(got, jax_pallas.local_forward_pairs_pallas(
        reads, paths, interpret=True))


def test_local_forward_chunks_reads(monkeypatch):
    rng = np.random.default_rng(7)
    reads, paths = code_grid(rng, 10, 20), code_grid(rng, 4, 25)
    want = as_np(seqalign.local_forward_ref(torch.from_numpy(reads),
                                            torch.from_numpy(paths)))
    monkeypatch.setattr(seqalign, "_REF_CHUNK_ELEMS", 4 * 26 * 3)
    got = as_np(seqalign.local_forward_ref(torch.from_numpy(reads),
                                           torch.from_numpy(paths)))
    assert_all_equal(got, want)


@pytest.mark.parametrize("width", [8, 12, 16, 64])
def test_banded_forward_matches_xla(width):
    rng = np.random.default_rng(300 + width)
    reads = code_grid(rng, 24, 60)
    paths = code_grid(rng, 24, 90)
    deltas = rng.integers(-20, 40, 24).astype(np.int32)
    got = as_np(seqalign.banded_pair_scores(reads, paths, deltas, width=width))
    want = jax_seqalign.banded_pair_scores(reads, paths, deltas, width=width)
    assert got[3].dtype == np.bool_
    assert_all_equal(got, want)


def arena_case(seed, n=128):
    """The JAX package's mini arena pools, carried over with from_numpy, and
    a random batch of (read row, path row, delta) with off-band deltas."""
    jpools, ops, reads, rows = _mini_arena_fixture()
    pools = DevicePools.from_numpy(
        np.asarray(jpools.arena), np.asarray(jpools.cum_off),
        np.asarray(jpools.base_ptr), np.asarray(jpools.plen),
        np.asarray(jpools.reads), "cpu")
    rng = np.random.default_rng(seed)
    ridx = rng.integers(0, len(reads), n).astype(np.int32)
    pidx = np.array([rows[int(i)] for i in rng.integers(0, len(rows), n)],
                    np.int32)
    deltas = rng.integers(-40, 160, n).astype(np.int32)
    return jpools, pools, ridx, pidx, deltas


@pytest.mark.parametrize("seed", [11, 13])
def test_banded_arena_scores_matches_xla_and_pallas(seed):
    W = 16
    jpools, pools, ridx, pidx, deltas = arena_case(seed)
    got = seqalign.banded_arena_scores(pools.arena, pools.cum_off,
                                       pools.base_ptr, pools.plen, pools.reads,
                                       ridx, pidx, deltas, width=W)
    jargs = (jpools.arena, jpools.cum_off, jpools.base_ptr, jpools.plen,
             jpools.reads, ridx, pidx, deltas)
    assert_all_equal(got, jax_seqalign._jitted_banded_arena(W)(*jargs))
    assert_all_equal(got, jax_pallas.banded_arena_scores_pallas(
        *jargs, W, interpret=True))


def test_banded_arena_scores_unmaterialized_returns_tensors():
    _, pools, ridx, pidx, deltas = arena_case(5, n=16)
    args = (pools.arena, pools.cum_off, pools.base_ptr, pools.plen, pools.reads,
            ridx, pidx, deltas)
    lazy = seqalign.banded_arena_scores(*args, width=16, materialize=False)
    assert all(isinstance(x, torch.Tensor) for x in lazy)
    assert lazy[3].dtype == torch.bool
    assert_all_equal([x.numpy() for x in lazy],
                     seqalign.banded_arena_scores(*args, width=16))


def test_banded_arena_indices_clamp_into_the_pools():
    jpools, pools, ridx, pidx, deltas = arena_case(3, n=8)
    ridx[0], pidx[1] = 10_000, 10_000
    ridx[2], pidx[3] = -5, -5
    got = seqalign.banded_arena_scores(pools.arena, pools.cum_off,
                                       pools.base_ptr, pools.plen, pools.reads,
                                       ridx, pidx, deltas, width=16)
    want = jax_seqalign._jitted_banded_arena(16)(
        jpools.arena, jpools.cum_off, jpools.base_ptr, jpools.plen,
        jpools.reads, np.clip(ridx, 0, jpools.reads.shape[0] - 1),
        np.clip(pidx, 0, jpools.cum_off.shape[0] - 1), deltas)
    assert_all_equal(got, want)


@pytest.mark.parametrize("shift", [0, 1])
def test_assemble_strip_matches_jax(shift):
    import jax.numpy as jnp

    jpools, pools, _, pidx, deltas = arena_case(7, n=64)
    n_cols, w2 = 96, 16
    got = seqalign.assemble_strip(
        pools.arena, pools.cum_off[pidx.astype(np.int64)],
        pools.base_ptr[pidx.astype(np.int64)], pools.plen[pidx.astype(np.int64)],
        torch.from_numpy(deltas), n_cols, shift, w2)
    want = jax_seqalign.assemble_strip(
        jpools.arena, jnp.take(jpools.cum_off, pidx, axis=0),
        jnp.take(jpools.base_ptr, pidx, axis=0), jnp.take(jpools.plen, pidx),
        deltas, n_cols, shift, w2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _codes(text):
    return np.array(["ACGTN".index(c) for c in text], np.int8)[None, :]


TIE_CASES = {
    # two equal maxima in one row: the smaller column wins
    "same_row": ("ACG", "ACGTTACG", (3, 3, 3)),
    # two equal maxima in two rows: the earlier row wins
    "two_rows": ("ACGTTTTACG", "ACG", (3, 3, 3)),
    # nothing aligns: best 0 reports (0, 0)
    "best_zero": ("AAAA", "CCCC", (0, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_local_tie_breaks(case):
    read, path, want = TIE_CASES[case]
    for fn in (seqalign.batched_pair_scores, seqalign.batched_local_scores):
        got = tuple(int(x.reshape(-1)[0]) for x in fn(_codes(read), _codes(path)))
        assert got == want, fn.__name__
    ref = tuple(int(np.asarray(x)[0]) for x in
                jax_seqalign._jitted_forward_pairs()(_codes(read), _codes(path)))
    assert ref == want


BANDED_TIE_CASES = {
    # (read, path, delta, width) -> (best, bi, bj, edge)
    # the read matches at path 0 and path 5; both in band: smaller lane wins
    "same_row": ("ACG", "ACGTTACG", 0, 16, (3, 3, 3, False)),
    "two_rows": ("ACGTTTTACG", "ACG", 0, 32, (3, 3, 3, False)),
    # the only match sits on lane 0 (delta - W/2 + 0 = its diagonal)
    "lane_0": ("ACGT", "TTTTTTTTACGT", 12, 8, (4, 4, 12, True)),
    # ... and on the last lane
    "last_lane": ("ACGT", "ACGTTTTTTTTT", -3, 8, (4, 4, 4, True)),
    "best_zero": ("AAAA", "CCCC", 0, 8, (0, 0, 0, False)),
}


@pytest.mark.parametrize("case", sorted(BANDED_TIE_CASES))
def test_banded_tie_breaks_and_edge_lanes(case):
    read, path, delta, width, want = BANDED_TIE_CASES[case]
    deltas = np.array([delta], np.int32)
    got = seqalign.banded_pair_scores(_codes(read), _codes(path), deltas,
                                      width=width)
    got = tuple(x.reshape(-1)[0].item() for x in got)
    ref = jax_seqalign.banded_pair_scores(_codes(read), _codes(path), deltas,
                                          width=width)
    assert got == tuple(np.asarray(x)[0].item() for x in ref)
    assert got == want


def mutated_pair(rng, lr):
    read = rng.integers(0, 4, size=lr).astype(np.int8)
    path = read.copy()
    for _ in range(max(1, int(lr * 0.05))):
        path[int(rng.integers(0, len(path)))] = rng.integers(0, 4)
    for _ in range(int(lr * 0.01) + 1):
        p = int(rng.integers(0, len(path)))
        if rng.random() < 0.5:
            path = np.delete(path, p)
        else:
            path = np.insert(path, p, np.int8(rng.integers(0, 4)))
    pre = rng.integers(0, 4, size=int(rng.integers(0, 40))).astype(np.int8)
    post = rng.integers(0, 4, size=int(rng.integers(0, 40))).astype(np.int8)
    return read, np.concatenate([pre, path, post]).astype(np.int8)


@pytest.mark.parametrize("seed", range(3))
def test_tracebacks_match_the_jax_package(seed):
    rng = np.random.default_rng(17 + seed)
    checked = 0
    for _ in range(12):
        read, path = mutated_pair(rng, int(rng.integers(40, 300)))
        if rng.random() < 0.3:     # a masked stretch, as placement rounds make
            a = int(rng.integers(0, len(read) - 10))
            read[a:a + 8] = PAD
        best, bi, bj = (int(x[0]) for x in
                        seqalign.batched_pair_scores(read[None], path[None]))
        if best <= 0:
            continue
        got = seqalign.traceback(read, path, bi, bj)
        assert got == jax_seqalign._traceback_py(read, path, bi, bj)
        assert got.score == best
        for width in (16, 64, 128):
            for expected in (best, best + 1):
                mine = seqalign._banded_traceback_py(read, path, bi, bj, bj - bi,
                                                     width, expected)
                ref = jax_seqalign._banded_traceback_py(read, path, bi, bj,
                                                        bj - bi, width, expected)
                assert mine == ref
                placed = seqalign.banded_traceback(read, path, bi, bj, bj - bi,
                                                   width, expected)
                if mine is None:
                    assert placed is None
                else:
                    assert placed == got
                    checked += 1
    assert checked >= 10


def test_runs_and_matrix_match_the_jax_package():
    rng = np.random.default_rng(5)
    read, path = mutated_pair(rng, 60)
    np.testing.assert_array_equal(seqalign._matrix(read, path),
                                  jax_seqalign._matrix(read, path))
    for ops in ("", "==X=IID", list("DD==")):
        assert seqalign._runs(ops) == jax_seqalign._runs(ops)
