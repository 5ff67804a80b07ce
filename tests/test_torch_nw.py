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


# ---------------------------------------------------------------------------
# The prepared read operand (ops/nw_cuda.ReadOperand) and the launch geometry
# ---------------------------------------------------------------------------


def bucket_batch(seed, C, n, R, m, nodes, longest=None):
    """A ragged batch whose read lengths hit every length in [0, longest]
    (so every strip-width bucket), with empty rows in the middle."""
    ak, al, bk, bl = random_batch(seed, C, n, R, m, nodes)
    longest = m if longest is None else longest
    bl = np.resize(np.arange(longest + 1, dtype=np.int32), R)
    np.random.default_rng(seed).shuffle(bl)
    bk = np.where(np.arange(m)[None, :] < bl[:, None], np.abs(bk), -2).astype(np.int32)
    return ak, al, bk, bl


# (C, n, R, m, nodes, longest read): R is no multiple of 128 or of 8
OPERAND_SHAPES = [(5, 8, 300, 16, 5, 15), (4, 12, 37, 5, 3, None),
                  (3, 24, 130, 40, 4, None), (2, 16, 7, 70, 3, None)]


@pytest.mark.parametrize("with_rc", [True, False], ids=["fw+rc", "fw"])
@pytest.mark.parametrize("shape", OPERAND_SHAPES)
def test_read_operand_layout(shape, with_rc):
    _, _, bk, bl = bucket_batch(3, *shape)
    R, m = bk.shape
    op = nw_cuda.ReadOperand(*_t(bk, bl), with_rc=with_rc)
    assert op.Rp % nw_cuda.BLOCK_R == 0 and 0 <= op.Rp - R < nw_cuda.BLOCK_R
    lens = op.b_len.numpy()
    assert (np.diff(lens) <= 0).all()                    # longest first
    assert (lens[R:] == 0).all()                         # pad rows are empty
    order, inverse = op.order.numpy(), op.inverse.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(R))
    np.testing.assert_array_equal(order[inverse], np.arange(R))   # round trip
    np.testing.assert_array_equal(lens[:R], bl[order])
    np.testing.assert_array_equal(op.keys.numpy()[:R], bk[order])
    assert (op.keys.numpy()[R:] == -2).all()
    assert op.keys_t.shape == (2 if with_rc else 1, m, op.Rp)
    assert op.keys_t.is_contiguous() and op.keys_t.dtype == torch.int32
    np.testing.assert_array_equal(op.keys_t[0].numpy(), op.keys.numpy().T)
    if with_rc:
        want_rc = np.asarray(J.rc_keys_device(op.keys.numpy(), lens))
        np.testing.assert_array_equal(op.plane(1).numpy(), want_rc)
    blocks = lens.reshape(-1, nw_cuda.BLOCK_R)
    assert op.block_max == blocks.max(axis=1).tolist()
    assert op.block_w == [nw_cuda.strip_width(x) for x in op.block_max]
    assert op.block_w_dev.tolist() == op.block_w
    assert op.max_len == int(bl.max()) and op.live_rows == int((bl > 0).sum())
    assert op.wide_blocks == sum(w == nw_cuda.STRIP for w in op.block_w)
    scores = torch.arange(2 * op.Rp, dtype=torch.int32).reshape(2, op.Rp)
    np.testing.assert_array_equal(op.to_caller_order(scores).numpy()[:, order],
                                  scores.numpy()[:, :R])


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("shape", OPERAND_SHAPES)
def test_prepared_scores_match_jax_xla(seed, shape):
    """fw + rc, length-sorted and transposed, scored through the plain
    version and permuted back: bit-exact with the JAX package."""
    ak, al, bk, bl = bucket_batch(seed, *shape)
    op = nw_cuda.ReadOperand(*_t(bk, bl))
    got = op.to_caller_order(P.scores_prepared(*_t(ak, al), op))
    assert got.dtype == torch.int32 and got.shape == (ak.shape[0], bk.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.nw_best_scores(ak, al, bk, bl)))
    fw = nw_cuda.ReadOperand(*_t(bk, bl), with_rc=False)
    got = fw.to_caller_order(P.scores_prepared_ref(*_t(ak, al), fw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.nw_pair_scores(ak, al, bk, bl)))


@pytest.mark.parametrize("packed", [True, False], ids=["K1", "K2"])
def test_prepared_scores_match_pallas_interpret(packed, monkeypatch):
    """The operand of 100 reads (no multiple of the block) against each
    Pallas kernel in interpret mode on the same reads padded to its tile."""
    C, n, R, m = 6, 16, 100, 16
    ak, al, bk, bl = bucket_batch(21, C, n, R, m, 6, 15)
    pad = nw_pallas.TILE_R - R
    bk_pad = np.concatenate([bk, np.full((pad, m), -2, np.int32)])
    bl_pad = np.concatenate([bl, np.zeros(pad, np.int32)])
    build = nw_pallas._build_pallas_forward.__wrapped__
    monkeypatch.setattr(nw_pallas, "_build_pallas_forward",
                        lambda nn, mm, interpret=False: build(nn, mm, interpret,
                                                              packed=packed))
    want = np.asarray(nw_pallas.nw_best_scores_pallas(ak, al, bk_pad, bl_pad,
                                                      interpret=True))[:, :R]
    op = nw_cuda.ReadOperand(*_t(bk, bl))
    got = op.to_caller_order(P.scores_prepared(*_t(ak, al), op))
    np.testing.assert_array_equal(got.numpy(), want)


def test_read_operand_rejects_bad_inputs():
    _, _, bk, bl = random_batch(0, 2, 8, 16, 8, 4)
    with pytest.raises(TypeError):
        nw_cuda.ReadOperand(torch.from_numpy(bk).long(), torch.from_numpy(bl))
    with pytest.raises(ValueError):
        nw_cuda.ReadOperand(torch.from_numpy(bk), torch.from_numpy(bl[:-1]))
    op = nw_cuda.ReadOperand(*_t(bk, bl))
    with pytest.raises(ValueError, match="CUDA"):
        nw_cuda.scores_prepared(*_t(*random_batch(0, 2, 8, 16, 8, 4)[:2]), op)


@pytest.mark.parametrize("n, m, packed", [(8, 16, True), (64, 64, True),
                                          (8184, 7, True), (8184, 8, False),
                                          (8177, 8, False), (8176, 15, True),
                                          (6144, 2048, False), (16, 8192, False)])
def test_kernel_choice_follows_the_jax_rule(n, m, packed):
    assert nw_cuda.uses_packed(n, m) is packed
    n_pad = -(-n // 8) * 8
    assert packed == (n_pad + m < 8192)    # gfalign_tpu/ops/nw_pallas.py:265


@pytest.mark.parametrize("longest, width", [(0, 0), (1, 2), (2, 2), (3, 4), (7, 8),
                                            (8, 8), (15, 16), (16, 16), (17, 32),
                                            (64, 32), (5000, 32)])
def test_strip_width_per_block(longest, width):
    assert nw_cuda.strip_width(longest) == width
    assert width == 0 or width >= min(longest, nw_cuda.STRIP)


@pytest.mark.parametrize("C, n, row_blocks", [(240, 8, 79), (128, 64, 128), (1, 8, 1),
                                              (37, 8, 40), (5, 8184, 2), (100000, 8, 1),
                                              (240, 8, 5000), (3, 4096, 300)])
def test_candidate_chunk(C, n, row_blocks):
    chunk = nw_cuda.candidate_chunk(C, n, row_blocks)
    assert 1 <= chunk <= C
    assert chunk * (n + 1) <= nw_cuda.STAGE_WORDS or chunk == 1   # fits the stage
    chunks = -(-C // chunk)
    assert chunks <= 65535
    # no more candidates a block than the grid needs to reach its target
    if chunk > 1 and chunk > -(-C // 65535):
        assert (chunks - 1) * row_blocks < nw_cuda.TARGET_BLOCKS + row_blocks


def test_candidate_chunk_at_the_search_shape():
    # 10,000 reads are 79 blocks of 128 rows: 27 chunks of 9 of 240 candidates
    assert nw_cuda.candidate_chunk(240, 8, 79) == 9
    assert nw_cuda.candidate_chunk(128, 64, 128) == 8


@pytest.mark.parametrize("C, n, wide_blocks, ns", [(128, 64, 128, 2), (11, 24, 2, 2),
                                                   (4, 8000, 300, 1), (500, 4096, 64, 2)])
def test_wide_plan_keeps_scratch_within_its_cap(C, n, wide_blocks, ns):
    chunk, c_step, b_step = nw_cuda.wide_plan(C, n, wide_blocks, ns)
    assert 1 <= chunk <= c_step <= C and 1 <= b_step <= wide_blocks
    assert c_step % chunk == 0 or c_step == C
    words = -(-c_step // chunk) * ns * n * b_step * nw_cuda.BLOCK_R
    assert 4 * words <= max(nw_cuda.SCRATCH_BYTES, 4 * ns * n * nw_cuda.BLOCK_R)


@pytest.mark.parametrize("longest, pairs, want", [
    (2000, 128, (16, 128)),      # long reads: most columns a thread, 4 warps a pair
    (2048, 512, (16, 128)), (1000, 4, (8, 128)), (300, 8, (4, 96)),
    (8, 200, (4, 32)), (64, 1, (4, 32)), (600, 3, (4, 160)),   # short reads: K = 4
    (4096, 4, (16, 256)), (4097, 4, (16, 288)), (8192, 2, (16, 512)),
    (9000, 2, (16, 512)),        # wider than a block: super-strips
    (100, 100000, (16, 32))])
def test_split_layout_threads_per_pair(longest, pairs, want):
    K, T = nw_cuda.split_layout(longest, pairs)
    assert (K, T) == want
    assert T % 32 == 0 and 32 <= T <= nw_cuda.SPLIT_MAX_THREADS[K]
    assert K * T >= min(longest, K * nw_cuda.SPLIT_MAX_THREADS[K])
