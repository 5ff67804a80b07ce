"""K3, K4 and K5 (gfalign_torch/csrc/seqalign.cu) run on the CPU: the CUDA
source is built for the host with g++ and csrc/host_shim/cuda_runtime.h (a
block's threads as OS threads, blocks one after another, barriers and
shuffles as std::barrier exchanges) and driven by the launchers of
ops/seqalign_cuda.py with CPU tensors, so the kernels' indexing, ring
refills, segmented scans, wavefront, hand-over between blocks and tie
breaks are held bit-exact (tolerance 0) against the plain versions, which
tests/test_torch_seqalign.py holds against the JAX package.  What nvcc
accepts and what the card computes is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Skips without g++."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gfalign_torch.ops import cuda_build, seqalign, seqalign_cuda
from gfalign_torch.ops.seqalign import PAD


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")
    return seqalign_cuda._bind(ctypes.CDLL(str(cuda_build.build_host("seqalign"))))


def code_grid(rng, rows, width, pad_rows=True):
    """int8 codes 0-4 (4 = N) with PAD tails, PAD stretches inside every
    third row and an all-PAD first row."""
    a = rng.integers(0, 5, (rows, width)).astype(np.int8)
    for i in range(rows):
        a[i, int(rng.integers(width // 3, width + 1)):] = PAD
        if i % 3 == 0:
            lo = int(rng.integers(0, width))
            a[i, lo:int(rng.integers(lo, width))] = PAD
    if pad_rows:
        a[0, :] = PAD
    return torch.from_numpy(a)


def arena_pools(rng, n_paths, s_cap, lr, n_reads, path_pads=False):
    """A random segment arena (with PAD codes inside when path_pads) and
    paths of 1-s_cap steps with overlap drops, tables padded with INT32_MAX
    as DevicePools pads them; ragged reads."""
    arena = rng.integers(0, 5, 3000).astype(np.int8)
    if path_pads:
        arena[rng.random(3000) < 0.02] = PAD
    arena = torch.from_numpy(arena)
    cum_off = torch.full((n_paths, s_cap), (1 << 31) - 1, dtype=torch.int32)
    base_ptr = torch.zeros((n_paths, s_cap), dtype=torch.int32)
    plen = torch.zeros((n_paths,), dtype=torch.int32)
    for p in range(n_paths):
        pos = 0
        for k in range(int(rng.integers(1, s_cap + 1))):
            seg_len = int(rng.integers(10, 60))
            start = int(rng.integers(0, 3000 - 80))
            drop = int(rng.integers(0, 6)) if k else 0
            cum_off[p, k] = pos
            base_ptr[p, k] = start + drop - pos
            pos += seg_len - drop
        plen[p] = pos
    return arena, cum_off, base_ptr, plen, code_grid(rng, n_reads, lr)


def run_banded(lib, pools, ridx, pidx, deltas, width):
    out = seqalign_cuda._launch_banded(lib, *pools, ridx, pidx, deltas, width, None)
    return out[0], out[1], out[2], out[3].bool()


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# width -> (lanes, threads a pair) the launcher picks; (w, layout) cases force
# another geometry through the same source
K3_CASES = {
    "w8": (8, None), "w16": (16, None), "w128": (128, None), "w512": (512, None),
    "w520": (520, None), "w1024": (1024, None), "w2048": (2048, None),
    "w12-dead-thread": (12, None), "w48": (48, None), "w32": (32, None),
    "w64": (64, None), "w144-dead-threads": (144, None), "w256": (256, None),
    "w128-block": (128, (4, 0)),
    "w512-block": (512, (16, 0)),
    "w16-path-pads": (16, None), "w128-path-pads": (128, None),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_on_the_host_matches_plain(case, host_lib, monkeypatch):
    width, layout = K3_CASES[case]
    if layout is not None:
        monkeypatch.setattr(seqalign_cuda, "banded_layout", lambda w: layout)
    rng = np.random.default_rng(width)
    n_pairs, lr = (12, 70) if width > 512 else (37, 150)
    pools = arena_pools(rng, 9, 5, lr, 11, path_pads=case.endswith("path-pads"))
    ridx = torch.from_numpy(rng.integers(-1, 12, n_pairs).astype(np.int32))
    pidx = torch.from_numpy(rng.integers(0, 10, n_pairs).astype(np.int32))
    deltas = torch.from_numpy(rng.integers(-60, lr + 40, n_pairs).astype(np.int32))
    before = seqalign_cuda.LAUNCHES["banded"]
    got = run_banded(host_lib, pools, ridx, pidx, deltas, width)
    assert seqalign_cuda.LAUNCHES["banded"] == before + 1
    want = seqalign.banded_arena_scores_ref(*pools, ridx, pidx, deltas, width)
    assert_same(got, want)
    assert int(want[0].max()) > 0


def test_k3_read_pool_off_a_word_boundary(host_lib):
    # a contiguous view whose rows of lr = 152 codes start one byte past a
    # word: the live-row count must not read it as words
    rng = np.random.default_rng(11)
    pools = arena_pools(rng, 9, 5, 152, 11)
    store = torch.full((11 * 152 + 1,), PAD, dtype=torch.int8)
    store[1:] = pools[4].reshape(-1)
    reads = store[1:].view(11, 152)
    assert reads.is_contiguous() and reads.data_ptr() % 4 == 1
    pools = pools[:4] + (reads,)
    ridx = torch.from_numpy(rng.integers(0, 11, 20).astype(np.int32))
    pidx = torch.from_numpy(rng.integers(0, 9, 20).astype(np.int32))
    deltas = torch.from_numpy(rng.integers(-20, 160, 20).astype(np.int32))
    for width in (128, 520):
        assert_same(run_banded(host_lib, pools, ridx, pidx, deltas, width),
                    seqalign.banded_arena_scores_ref(*pools, ridx, pidx, deltas,
                                                     width))


def _codes(s):
    return torch.tensor([["ACGTN-".index(c) for c in s]], dtype=torch.int8)


_READ40 = "ACGT" * 10


# test_torch_seqalign.py's BANDED_TIE_CASES: (read, path, delta, width) ->
# (best, bi, bj, edge)
BANDED_TIE_CASES = {
    "same_row": ("ACG", "ACGTTACG", 0, 16, (3, 3, 3, False)),
    "two_rows": ("ACGTTTTACG", "ACG", 0, 32, (3, 3, 3, False)),
    "lane_0": ("ACGT", "TTTTTTTTACGT", 12, 8, (4, 4, 12, True)),
    "last_lane": ("ACGT", "ACGTTTTTTTTT", -3, 8, (4, 4, 4, True)),
    "best_zero": ("AAAA", "CCCC", 0, 8, (0, 0, 0, False)),
    # a PAD ("-") inside the path blocks: the alignment steps round it
    # with two gaps (39 matches - 6), not through it (39 - 2)
    "path_pad": (_READ40, _READ40[:20] + "-" + _READ40[21:], 0, 16,
                 (33, 40, 40, False)),
}


@pytest.mark.parametrize("case", list(BANDED_TIE_CASES))
def test_k3_tie_breaks_and_edge_lanes_on_the_host(case, host_lib):
    read, path, delta, width, want = BANDED_TIE_CASES[case]
    reads, paths = _codes(read), _codes(path)
    lp = paths.shape[1]
    pools = (paths.reshape(-1), torch.zeros((1, 1), dtype=torch.int32),
             torch.zeros((1, 1), dtype=torch.int32),
             torch.tensor([lp], dtype=torch.int32), reads)
    zero = torch.zeros((1,), dtype=torch.int32)
    got = run_banded(host_lib, pools, zero, zero,
                     torch.tensor([delta], dtype=torch.int32), width)
    assert tuple(x.item() for x in got) == want


# (N, lr, lp, layout (K, T, blocks a pair) or None for the launcher's, seed)
K4_CASES = {
    "many-pairs": (40, 60, 100, None, 1),
    "few-pairs-split": (3, 90, 300, (4, 32, 3), 2),
    "K16-split": (2, 120, 500, (16, 32, 1), 3),
    "K16-two-blocks": (2, 120, 900, (16, 32, 2), 4),
    "wider-than-a-block": (2, 80, 2500, None, 5),    # three blocks of 4 warps
    "ties": (6, 40, 60, (4, 32, 1), 6),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_on_the_host_matches_plain(case, host_lib, monkeypatch):
    N, lr, lp, layout, seed = K4_CASES[case]
    if layout is not None:
        monkeypatch.setattr(seqalign_cuda, "pairs_layout", lambda lp, pairs, sms: layout)
    rng = np.random.default_rng(seed)
    reads, paths = code_grid(rng, N, lr), code_grid(rng, N, lp)
    if case == "ties":          # two letters: many equal scores
        reads = torch.where(reads == PAD, reads, reads % 2)
        paths = torch.where(paths == PAD, paths, paths % 2)
    K, T, parts = seqalign_cuda.pairs_layout(lp, N, seqalign_cuda.HOST_SMS)
    if case == "wider-than-a-block":
        assert parts > 1
    before = seqalign_cuda.LAUNCHES["pairs"]
    out = seqalign_cuda._launch_pairs(host_lib, reads, paths, None)
    assert seqalign_cuda.LAUNCHES["pairs"] == before + 1
    assert_same(tuple(out), seqalign.local_forward_pairs_ref(reads, paths))


def test_k4_tie_across_blocks_keeps_the_left_column(host_lib, monkeypatch):
    # the read matches at columns 1-4 and 201-204 of a path of N codes; with
    # 128 columns a block the two ends lie in blocks 0 and 1
    monkeypatch.setattr(seqalign_cuda, "pairs_layout", lambda lp, pairs, sms: (4, 32, 3))
    reads = _codes("ACGT")
    paths = torch.full((1, 300), 4, dtype=torch.int8)
    paths[0, 0:4] = paths[0, 200:204] = reads[0]
    out = seqalign_cuda._launch_pairs(host_lib, reads, paths, None)
    assert tuple(int(x) for x in out[:, 0]) == (4, 4, 4)
    assert_same(tuple(out), seqalign.local_forward_pairs_ref(reads, paths))


def test_k4_pad_inside_the_path_blocks(host_lib):
    reads, paths = _codes(_READ40), _codes(_READ40[:20] + "-" + _READ40[21:])
    out = seqalign_cuda._launch_pairs(host_lib, reads, paths, None)
    assert tuple(int(x) for x in out[:, 0]) == (33, 40, 40)
    assert_same(tuple(out), seqalign.local_forward_pairs_ref(reads, paths))


def test_k4_workspace_chunks(host_lib, monkeypatch):
    rng = np.random.default_rng(8)
    reads, paths = code_grid(rng, 5, 300), code_grid(rng, 5, 150)
    monkeypatch.setattr(seqalign_cuda, "pairs_layout", lambda lp, pairs, sms: (4, 32, 2))
    monkeypatch.setattr(seqalign_cuda, "SCRATCH_BYTES", 4 * 2 * 300 * 2)
    before = seqalign_cuda.LAUNCHES["pairs"]
    out = seqalign_cuda._launch_pairs(host_lib, reads, paths, None)
    assert seqalign_cuda.LAUNCHES["pairs"] - before > 1
    assert_same(tuple(out), seqalign.local_forward_pairs_ref(reads, paths))


def test_k3_wide_keys_on_the_host(host_lib):
    # reads of 33,000 rows: (lr + 1) << bit_length(lr + 2) passes 2^31, so
    # the kernel keeps its keys in 64 bits
    rng = np.random.default_rng(10)
    lr = 33000
    pools = arena_pools(rng, 3, 4, lr, 3)
    reads = pools[4]
    reads[1, :lr - 10] = torch.from_numpy(rng.integers(0, 4, lr - 10).astype(np.int8))
    idx = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    deltas = torch.tensor([0, -30, 5, 40], dtype=torch.int32)
    got = run_banded(host_lib, pools, idx, idx % 3, deltas, 16)
    assert_same(got, seqalign.banded_arena_scores_ref(*pools, idx, idx % 3, deltas, 16))


def test_k5_on_the_host_matches_plain(host_lib):
    rng = np.random.default_rng(9)
    reads, paths = code_grid(rng, 7, 50), code_grid(rng, 5, 2100)  # two strips
    before = seqalign_cuda.LAUNCHES["cross"]
    out = seqalign_cuda._launch_cross(host_lib, reads, paths, None)
    assert seqalign_cuda.LAUNCHES["cross"] == before + 1
    assert_same(tuple(out), seqalign.local_forward_ref(reads, paths))


def test_banded_layout_serves_the_widths_served_before():
    # multiples of 4 up to 2048 and of 16 up to 8192; a multiple of 16 up
    # to 512 takes the group kernel with a power-of-two group that covers it
    for width in range(1, 8300):
        served = width % 4 == 0 and (width <= 2048 or (width % 16 == 0 and width <= 8192))
        if not served:
            with pytest.raises(ValueError, match="band width"):
                seqalign_cuda.banded_layout(width)
            continue
        lanes, group = seqalign_cuda.banded_layout(width)
        assert width % lanes == 0
        if group:
            assert lanes == 16 and group & (group - 1) == 0 and group <= 32
            assert (group // 2) * lanes < width <= group * lanes
        else:
            assert width > 512 or width % 16


@pytest.mark.parametrize("lp, pairs", [(8192, 16), (700, 64), (20000, 5), (16, 1),
                                       (8192, 4096), (20000, 300), (16, 1000)])
def test_pairs_layout_covers_the_path(lp, pairs):
    K, T, parts = seqalign_cuda.pairs_layout(lp, pairs, 132)
    assert T % 32 == 0 and 32 <= T <= 512 and K in (4, 8, 16)
    assert parts * T * K >= lp > (parts - 1) * T * K


# (lp, pairs, SMs) -> layout: as many blocks a pair as keep one block an
# SM, of 4 to 16 warps
@pytest.mark.parametrize("lp, pairs, sms, want", [
    (8192, 16, 132, (8, 128, 8)), (8192, 32, 132, (8, 256, 4)),
    (8192, 64, 132, (8, 512, 2)), (8192, 128, 132, (16, 512, 1)),
    (8192, 256, 132, (16, 512, 1)), (4096, 1024, 132, (8, 512, 1)),
    (8192, 16, 64, (8, 256, 4)), (20000, 300, 132, (16, 512, 3)),
    (20000, 5, 132, (8, 128, 20)), (700, 64, 132, (8, 96, 1))])
def test_pairs_layout_fills_one_wave(lp, pairs, sms, want):
    assert seqalign_cuda.pairs_layout(lp, pairs, sms) == want
