"""K3, K4, K5, the walk and the banded walk (gfalign_torch/csrc/seqalign.cu) run on the CPU: the CUDA
source is built for the host with g++ and csrc/host_shim/cuda_runtime.h (a
block's threads as OS threads, blocks one after another, barriers and
shuffles as std::barrier exchanges) and driven by the launchers of
ops/seqalign_cuda.py with CPU tensors, so the kernels' indexing, ring
refills, segmented scans, wavefront, hand-over between blocks and tie
breaks are held bit-exact (tolerance 0) against the plain versions, which
tests/test_torch_seqalign.py holds against the JAX package.  What nvcc
accepts and what the card computes is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Skips without g++."""

import contextlib
import ctypes
import io
import shutil

import numpy as np
import pytest
import torch

from gfalign_torch import synth
from gfalign_torch.bench_seqalign import (BAND_WALK_CASES,
                                          WALK_BLOCK_RUNS, WALK_CASES,
                                          band_walk_case, walk_block_case,
                                          walk_budget, walk_mode_patches,
                                          walk_case)
from gfalign_torch.cli.main import main
from gfalign_torch.io import native
from gfalign_torch.ops import cuda_build, seqalign, seqalign_cuda
from gfalign_torch.ops.seqalign import PAD
from gfalign_torch.utils import profiling


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


def test_k3_block_kernel_sizes_its_strip_by_the_longest_read(host_lib):
    # a pool padded to 262,144 columns (a read over 131,072 bases pads it
    # so): at a band of 2048 the pool's width would ask for more shared
    # memory than a block may take; the launch's longest read sizes it
    rng, live = np.random.default_rng(18), 400
    lr = 1 << 18
    pools = arena_pools(rng, 3, 4, 64, 3)
    reads = torch.full((3, lr), PAD, dtype=torch.int8)
    for r in range(3):
        reads[r, :live - 40 * r] = torch.from_numpy(
            rng.integers(0, 4, live - 40 * r).astype(np.int8))
    pools = pools[:4] + (reads,)
    idx = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    deltas = torch.tensor([0, -30, 5, 40], dtype=torch.int32)
    assert seqalign_cuda.banded_layout(2048) == (16, 0)
    assert 8 * pools[1].shape[1] + lr + 2048 + 12 > seqalign_cuda.SMEM_MAX
    got = run_banded(host_lib, pools, idx, idx % 3, deltas, 2048)
    assert_same(got, seqalign.banded_arena_scores_ref(*pools, idx, idx % 3, deltas, 2048))


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


def launch_walk(lib, read, path, ei, ej):
    """The walk kernel's source from (ei, ej), one sa_walk launch: its
    result words and its code words."""
    before = seqalign_cuda.LAUNCHES["walk"]
    got = seqalign_cuda._launch_walk(lib, torch.from_numpy(read[:ei].copy()),
                                     torch.from_numpy(path[:ej].copy()), None)
    assert seqalign_cuda.LAUNCHES["walk"] == before + 1
    return got


def run_walk(lib, read, path, ei, ej):
    out, _ = launch_walk(lib, read, path, ei, ej)
    return seqalign_cuda.walk_result(out, ei, ej)


def native_walk(read, path, ei, ej):
    return native.local_traceback(read, path, ei, ej, seqalign.MATCH,
                                  seqalign.MISMATCH, seqalign.GAP, PAD,
                                  seqalign._BLOCK)


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_on_the_host_matches_native(case, host_lib):
    read, path, ei, ej = walk_case(case)
    assert run_walk(host_lib, read, path, ei, ej) == native_walk(read, path, ei, ej)


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_codes_on_the_host_match_plain(case, host_lib):
    # every cell's move, not only those the walk passes through
    read, path, ei, ej = walk_case(case)
    _, codes = launch_walk(host_lib, read, path, ei, ej)
    _, want = seqalign.walk_codes_ref(torch.from_numpy(read[:ei].copy()),
                                      torch.from_numpy(path[:ej].copy()))
    np.testing.assert_array_equal(seqalign_cuda.walk_codes(codes, ei, ej),
                                  want.numpy()[1:, 1:])


def test_walk_layout_constants_match_the_library(host_lib, monkeypatch):
    assert (host_lib.sa_walk_k(), host_lib.sa_walk_head(),
            host_lib.sa_walk_tile_words()) == (
        seqalign_cuda.WALK_K, seqalign_cuda.WALK_HEAD,
        seqalign_cuda.WALK_TILE_WORDS)
    monkeypatch.setattr(seqalign_cuda, "WALK_K", 2 * seqalign_cuda.WALK_K)
    with pytest.raises(RuntimeError, match="walk kernel's layout"):
        seqalign_cuda._bind(host_lib)


@pytest.mark.parametrize("threads", [32, 64, 128, 512])
def test_walk_layouts_on_the_host(threads, host_lib, monkeypatch):
    # 1,100 x 1,400 cells: one to six blocks of one to sixteen warps, the
    # walk through several tiles of codes both ways
    monkeypatch.setattr(seqalign_cuda, "walk_layout",
                        lambda cols: (threads, -(-cols // (8 * threads))))
    read, path, ei, ej = walk_case("several-tiles")
    assert ei > 512 and ej > 512
    assert run_walk(host_lib, read, path, ei, ej) == native_walk(read, path, ei, ej)


@pytest.mark.parametrize("case, mode", WALK_BLOCK_RUNS)
def test_blocked_walk_on_the_host_matches_plain(case, mode, host_lib, monkeypatch):
    """The walk cut to the ladder's score's columns (seqalign.walk_window),
    as one tile and in row blocks of 64 rows (the budget forced small),
    against the plain walk codes and their walk over the whole rectangle,
    field for field: seeded pairs, a net deletion drift, PAD-masked rows
    (no cut, and whole-width blocks for the band), ties at the window's
    first column, several blocks and one."""
    read, path, ei, ej, score = walk_block_case(case)
    want = seqalign.full_walk(torch.from_numpy(read[:ei].copy()),
                              torch.from_numpy(path[:ej].copy()))
    c0 = seqalign.walk_window(read, path, ei, ej, score)
    budget = walk_budget(mode, ej - c0)
    for name, value in walk_mode_patches(mode).items():
        monkeypatch.setattr(seqalign_cuda, name, value)
    plan = seqalign_cuda.walk_plan(ei, ej - c0, budget)
    assert plan.whole == (mode == "whole")
    before = profiling.snapshot()
    out, codes = seqalign_cuda._launch_walk(
        host_lib, torch.from_numpy(read[:ei].copy()),
        torch.from_numpy(path[c0:ej].copy()), None, budget)
    got = seqalign_cuda.walk_result(out, ei, ej - c0)
    assert got[0] >= score
    assert got[:2] + (got[2] + c0,) + got[3:] == want
    counts = profiling.since(before)["counts"]
    blocks = counts["kernels.seqalign.walk_blocks"]
    assert counts["kernels.seqalign.walk"] == 1
    assert counts["kernels.seqalign.walk_cells"] >= ei * (ej - c0)
    if mode == "whole":
        assert blocks == 1 and codes is not None
    elif mode.startswith("band") and case != "pad-masked":
        assert blocks == -(-ei // plan.every) > 2    # the band's blocks, once
    else:
        assert 1 <= blocks <= -(-ei // plan.block_rows)


def test_walk_refused_launch_raises(host_lib, monkeypatch):
    read, path, ei, ej = walk_case("random-0")
    monkeypatch.setattr(seqalign_cuda, "walk_layout", lambda cols: (48, 8))
    before = seqalign_cuda.LAUNCHES["walk"]
    with pytest.raises(RuntimeError, match="sa_walk launch failed"):
        run_walk(host_lib, read, path, ei, ej)
    assert seqalign_cuda.LAUNCHES["walk"] == before


@pytest.mark.parametrize("cols, blocks", [(0, 1), (1, 1), (512, 1), (513, 2),
                                          (45000, 88), (10 ** 7, 19532)])
def test_walk_layout_covers_the_columns(cols, blocks):
    T, parts = seqalign_cuda.walk_layout(cols)
    assert (T, parts) == (64, blocks)
    assert parts * T * seqalign_cuda.WALK_K >= cols


def native_band_walks(walks):
    return [native.banded_local_traceback(*walk, seqalign.MATCH,
                                          seqalign.MISMATCH, seqalign.GAP, PAD,
                                          seqalign._BLOCK) for walk in walks]


def host_band_walks(lib, walks):
    return seqalign_cuda._band_walks(lib, walks, torch.device("cpu"), None)


# A team of several warps costs the host build a barrier of 128 OS threads
# a row, so the tests run most walks under a layout of one warp or less
# (few_threads: 16 to 64 lanes a thread up to 2,048 lanes) and the
# launcher's own layouts on fewer cases (MULTI_WARP_CASES)
MULTI_WARP_CASES = ("random", "masked-runs", "drift", "edge-walk", "path-end",
                    "expected-missed")


@pytest.fixture
def few_threads(monkeypatch):
    def layout(width):
        lanes = max(16, 1 << (-(-width // 32) - 1).bit_length())
        return lanes, 1 << (-(-width // lanes) - 1).bit_length()

    monkeypatch.setattr(seqalign_cuda, "bandtrace_layout", layout)


@pytest.mark.parametrize("width", [16, 24, 100, 128, 512, 520, 2048])
def test_bandtrace_on_the_host_matches_native(width, host_lib, few_threads):
    """The banded walk kernel's source against the native walk, every
    small case of bench_seqalign in one launch, teams of one to 32 threads
    of 16 to 64 lanes: dead lanes (24, 100, 520), masked rows at the path's
    ends, skipped PAD rows, both gates (the card tests take every case at
    every band, tests/test_torch_cuda.py)."""
    walks = [band_walk_case(case, width) for case in BAND_WALK_CASES]
    before = seqalign_cuda.LAUNCHES["bandtrace"]
    assert host_band_walks(host_lib, walks) == native_band_walks(walks)
    assert seqalign_cuda.LAUNCHES["bandtrace"] == before + 1


@pytest.mark.parametrize("width", [128, 200, 512, 520, 2048, 4096])
def test_bandtrace_layouts_on_the_host_match_native(width, host_lib):
    """The launcher's own layouts (bandtrace_layout): one warp of 4 lanes
    a thread (128), two teams of two warps a block (200, dead lanes),
    teams of four warps of 4, 8, 16 and 32 lanes (512, 520 with dead
    lanes, 2,048, 4,096), on MULTI_WARP_CASES in one launch."""
    walks = [band_walk_case(case, width) for case in MULTI_WARP_CASES]
    assert host_band_walks(host_lib, walks) == native_band_walks(walks)


@pytest.mark.parametrize("width", [24, 128, 520])
def test_bandtrace_codes_on_the_host_match_plain(width, host_lib):
    """Every cell's move of the forward pass, not only those the walks
    pass through, against band_codes_ref: masked and plain rows, dead
    lanes, the band's edge lanes, and chunks of PAD rows skipped (a walk
    alone in its launch, so that its warp's other teams are idle)."""
    walks = [band_walk_case(case, width) for case in
             ("random", "masked-runs", "path-start", "path-end", "n-codes")]
    jobs = [seqalign_cuda._BandJob(*w[:7], seqalign.band_end(len(w[0]), len(w[1]),
                                                             *w[2:6]),
                                   *seqalign_cuda.bandtrace_layout(width))
            for w in walks]
    for group in ((jobs, jobs[1:2]) if jobs[0].team <= 32 else (jobs[1:2],)):
        _, codes, first = seqalign_cuda._launch_bandtrace(
            host_lib, group, torch.device("cpu"), None)
        for job, at in zip(group, first):
            _, want = seqalign.band_codes_ref(torch.from_numpy(job.read[:job.end_i]),
                                              torch.from_numpy(job.path[:job.end_j]),
                                              job.delta, width)
            np.testing.assert_array_equal(
                seqalign_cuda.band_codes(codes, int(at), job.end_i, width),
                want.numpy()[1:])


def test_bandtrace_long_deletion_on_the_host(host_lib, few_threads, width=2048):
    """A walk whose D run crosses 400 lanes of a wide band in one row
    leaves its stage's window of lanes sideways (the window reaches at
    most 383 lanes left of the walk); the next stage goes on from it."""
    walk = band_walk_case("long-deletion", width)
    got = host_band_walks(host_lib, [walk])
    assert got == native_band_walks([walk]) and "D" * 400 in got[0][5]


def test_bandtrace_wave_of_every_layout_and_its_budget_on_the_host(host_lib,
                                                                  few_threads,
                                                                  monkeypatch):
    """One launch takes walks of several layouts (blocks of each, the
    longest first); at a budget of one byte each walk on the band is a
    launch of its own, with the same results."""
    walks = [band_walk_case(case, width) for width in (16, 100, 520, 2048)
             for case in ("random", "edge-walk", "end-on-edge")]
    want = native_band_walks(walks)
    before = seqalign_cuda.LAUNCHES["bandtrace"]
    assert host_band_walks(host_lib, walks) == want
    assert seqalign_cuda.LAUNCHES["bandtrace"] == before + 1
    monkeypatch.setattr(seqalign_cuda, "BANDTRACE_BUDGET", 1)
    assert host_band_walks(host_lib, walks) == want
    on_band = sum(seqalign.band_end(len(w[0]), len(w[1]), *w[2:6]) is not None
                  for w in walks)
    assert seqalign_cuda.LAUNCHES["bandtrace"] == before + 1 + on_band
    order, blocks = seqalign_cuda._bandtrace_blocks(
        [seqalign_cuda._BandJob(*w[:7], 1, *seqalign_cuda.bandtrace_layout(w[5]))
         for w in walks])
    assert sorted(order) == list(range(len(walks)))
    assert blocks[:, 1].sum() == len(walks)


@pytest.mark.parametrize("width, want", [
    (4, (4, 4)), (16, (4, 4)), (17, (4, 8)), (100, (4, 32)), (128, (4, 32)),
    (129, (4, 64)), (512, (4, 128)), (513, (8, 128)), (1024, (8, 128)),
    (1025, (16, 128)), (2048, (16, 128)), (2049, (32, 128)), (4096, (32, 128)),
    (8192, (64, 128))])
def test_bandtrace_layout_covers_the_band(width, want):
    lanes, team = seqalign_cuda.bandtrace_layout(width)
    assert (lanes, team) == want and lanes * team >= width
    assert lanes * team % 16 == 0 and team <= seqalign_cuda.BT_THREADS


def test_bandtrace_layout_refuses_what_it_does_not_take(host_lib, monkeypatch):
    for width in (3, 8193):
        with pytest.raises(ValueError, match="band width"):
            seqalign_cuda.bandtrace_layout(width)
    assert (host_lib.sa_bandtrace_table_words(), host_lib.sa_bandtrace_block_words(),
            host_lib.sa_bandtrace_head()) == (
        seqalign_cuda.BT_TABLE_WORDS, seqalign_cuda.BT_BLOCK_WORDS,
        seqalign_cuda.BT_HEAD)
    monkeypatch.setattr(seqalign_cuda, "BT_HEAD", 2 * seqalign_cuda.BT_HEAD)
    with pytest.raises(RuntimeError, match="banded walk's layout"):
        seqalign_cuda._bind(host_lib)


def test_align_through_the_host_bandtrace_matches_the_native_walks(
        host_lib, few_threads, monkeypatch, tmp_path):
    """The placement loop's waves through the banded walk kernel's source
    (as on CUDA, here on the CPU): the GAF and the walk counters of the
    native walks, fewer launches than walks."""
    kw = dict(seed=7, n_segments=80, n_reads=16, seg_len=(200, 600),
              read_len=(400, 900), sub_rate=0.03, ins_rate=0.03,
              del_rate=0.03, tangle_read_frac=0.3)
    paths = synth.write_workload(synth.make_workload(**kw), str(tmp_path))
    argv = ["align", "-f", paths["gfa"], "-r", paths["reads"], "-o",
            str(tmp_path / "out.gaf"), "-p", "CLR", "--band", "24",
            "--wide-band", "40"]

    def run():
        before = profiling.snapshot()
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv, device="cpu") == 0
        return ((tmp_path / "out.gaf").read_bytes(),
                profiling.since(before)["counts"])

    plain_gaf, plain = run()

    def waves(walks, device="cpu"):
        return [seqalign._placement(res, w[2], w[3])
                for res, w in zip(host_band_walks(host_lib, walks), walks)]

    monkeypatch.setattr(seqalign, "banded_tracebacks", waves)
    gaf, counts = run()
    assert gaf == plain_gaf != b""
    for key in ("banded_walks", "declined", "full_walks"):
        assert counts[f"align.traceback.{key}"] == plain[f"align.traceback.{key}"] > 0
    assert 0 < counts["kernels.seqalign.bandtrace"] < counts["align.traceback.banded_walks"]
