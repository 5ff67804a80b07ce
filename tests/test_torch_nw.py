"""The port's NW path scorer (gfalign_torch/ops/nw_path.py) against the JAX
package: the XLA row scan, the Pallas kernels K1/K2 in interpret mode, and
the reference-transcribed oracle.  Scores are int32 and compared with
tolerance zero.  The CUDA kernels are held against the plain version in
tests/test_torch_cuda.py and by chip_smoke.py, on the card."""

import itertools
import random

import numpy as np
import pytest
import torch

from gfalign_tpu.ops import nw_pallas
from gfalign_tpu.ops import nw_path as J
from gfalign_torch.ops import nw_path as P
from gfalign_torch.ops import nw_cuda


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def random_batch(seed, C, n, R, m, nodes):
    """Ragged candidate/read key batches with empty rows; candidate keys
    carry all three orientation codes, pads are -1 / -2."""
    rng = np.random.default_rng(seed)
    a_keys = (rng.integers(0, nodes, (C, n)) * 4
              + rng.integers(0, 3, (C, n))).astype(np.int32)
    a_len = rng.integers(0, n + 1, (C,)).astype(np.int32)
    a_len[0] = 0
    for c in range(C):
        a_keys[c, a_len[c]:] = -1
    b_keys = (rng.integers(0, nodes, (R, m)) * 4
              + rng.integers(0, 2, (R, m))).astype(np.int32)
    b_len = rng.integers(0, m + 1, (R,)).astype(np.int32)
    b_len[0] = 0
    b_len[-1] = m
    for r in range(R):
        b_keys[r, b_len[r]:] = -2
    return a_keys, a_len, b_keys, b_len


# (C, n, R, m, distinct nodes): the shapes of tests/test_nw.py (:100, :121)
# plus narrow alphabets, where ties in the free last column are common
SHAPES = [(3, 12, 128, 12, 5), (8, 24, 128, 16, 10), (4, 8, 40, 8, 3),
          (3, 40, 50, 70, 6), (2, 5, 7, 33, 2)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_scores_match_jax_xla(seed, shape):
    ak, al, bk, bl = random_batch(seed, *shape)
    want = np.asarray(J.nw_pair_scores(ak, al, bk, bl))
    got = P.nw_pair_scores(*_t(ak, al, bk, bl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_best_scores_match_jax_xla(seed):
    ak, al, bk, bl = random_batch(100 + seed, 5, 16, 96, 16, 4)
    want = np.asarray(J.nw_best_scores(ak, al, bk, bl))
    np.testing.assert_array_equal(P.nw_best_scores(*_t(ak, al, bk, bl)).numpy(), want)
    np.testing.assert_array_equal(P.nw_best_scores_ref(*_t(ak, al, bk, bl)).numpy(), want)


def test_pair_scores_match_pallas_interpret():
    """tests/test_nw.py:92's case: K1 (interpret mode) on the same keys."""
    rng = random.Random(42)
    C, n, m = 3, 12, 12
    cands = [[J.Step(rng.randrange(5), rng.choice("+-"))
              for _ in range(rng.randrange(1, n + 1))] for _ in range(C)]
    reads = [[J.Step(rng.randrange(5), rng.choice("+-"))
              for _ in range(rng.randrange(1, m + 1))]
             for _ in range(nw_pallas.TILE_R)]
    ak, al = J.encode_path_batch(cands, n, pad_key=-1)
    bk, bl = J.encode_path_batch(reads, m, pad_key=-2)
    want = np.asarray(nw_pallas.nw_pair_scores_pallas(ak, al, bk, bl, interpret=True))
    np.testing.assert_array_equal(P.nw_pair_scores(*_t(ak, al, bk, bl)).numpy(), want)


@pytest.mark.parametrize("packed", [True, False], ids=["K1", "K2"])
def test_best_scores_match_pallas_interpret(packed, monkeypatch):
    """tests/test_nw.py:116's case, once through each Pallas kernel."""
    rng = np.random.default_rng(11)
    C, n, R, m = 8, 24, 128, 16
    ak = (rng.integers(0, 10, (C, n)) * 4 + rng.integers(0, 2, (C, n))).astype(np.int32)
    al = rng.integers(0, n + 1, (C,)).astype(np.int32)
    for c in range(C):
        ak[c, al[c]:] = -1
    bk = (rng.integers(0, 10, (R, m)) * 4 + rng.integers(0, 2, (R, m))).astype(np.int32)
    bl = rng.integers(0, m + 1, (R,)).astype(np.int32)
    for r in range(R):
        bk[r, bl[r]:] = -2
    build = nw_pallas._build_pallas_forward.__wrapped__
    monkeypatch.setattr(nw_pallas, "_build_pallas_forward",
                        lambda nn, mm, interpret=False: build(nn, mm, interpret,
                                                              packed=packed))
    want = np.asarray(nw_pallas.nw_best_scores_pallas(ak, al, bk, bl, interpret=True))
    np.testing.assert_array_equal(P.nw_best_scores(*_t(ak, al, bk, bl)).numpy(), want)


@pytest.mark.parametrize("alphabet", [("1+", "2+"), ("1+", "1-", "2+")])
def test_exhaustive_short_paths_match_oracle(alphabet):
    """Every pair of paths of length 0..3 over a tiny alphabet: every tie,
    free-last-column tie and empty row the walk can meet at that size."""
    steps = [J.Step(int(s[:-1]), s[-1]) for s in alphabet]
    paths = [list(p) for k in range(4) for p in itertools.product(steps, repeat=k)]
    ak, al = J.encode_path_batch(paths, 3, pad_key=-1)
    bk, bl = J.encode_path_batch(paths, 3, pad_key=-2)
    got = P.nw_pair_scores(*_t(ak, al, bk, bl)).numpy()
    want = np.array([[J.nw_score_oracle(a, b) for b in paths] for a in paths])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_rc_keys_device_parity(seed):
    rng = np.random.default_rng(seed)
    R, m = 40, 12
    keys = (rng.integers(0, 9, (R, m)) * 4 + rng.integers(0, 3, (R, m))).astype(np.int32)
    lens = rng.integers(0, m + 1, (R,)).astype(np.int32)
    for r in range(R):
        keys[r, lens[r]:] = -2
    want = np.asarray(J.rc_keys_device(keys, lens))
    got = P.rc_keys_device(*_t(keys, lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_long_path_beyond_reference_cap_matches_oracle():
    """tests/test_long_paths.py's first shape: n = 1200 > MAX_N."""
    rng = np.random.default_rng(0)
    cand = [P.Step(int(v), "+") for v in rng.integers(0, 50, 1200)]
    read = [s for s in cand[100:1100] if rng.random() > 0.02]
    read = [P.Step(s.id, "-" if rng.random() < 0.01 else s.orientation) for s in read]
    got = P.batched_best_scores([cand], [read], device="cpu", read_chunk=128)
    want = max(P.nw_score_oracle(cand, read),
               P.nw_score_oracle(cand, P.revcomp_path(read)))
    assert got[0, 0] == want


def test_long_path_batch_chunks_match_oracle():
    """tests/test_long_paths.py's second shape, read-chunked."""
    rng = np.random.default_rng(1)
    cand = [P.Step(int(v), "+") for v in rng.integers(0, 20, 600)]
    reads = []
    for _ in range(4):
        start = rng.integers(0, 300)
        reads.append(cand[start:start + int(rng.integers(50, 300))])
    got = P.batched_best_scores([cand], reads, device="cpu", read_chunk=4)
    for i, r in enumerate(reads):
        want = max(P.nw_score_oracle(cand, r),
                   P.nw_score_oracle(cand, P.revcomp_path(list(r))))
        assert got[0, i] == want


def test_cpu_tensors_never_launch_a_kernel():
    before = dict(nw_cuda.LAUNCHES)
    ak, al, bk, bl = random_batch(7, 3, 8, 16, 8, 4)
    P.nw_best_scores(*_t(ak, al, bk, bl))
    assert nw_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        nw_cuda.nw_pair_scores_cuda(*_t(ak, al, bk, bl))
    assert nw_cuda.LAUNCHES == before
