"""The port on the card: the CUDA kernels K1-K5 against their plain PyTorch
versions, and the frontier step and CLI on CUDA against the CPU run.  Every
test needs a CUDA device and skips without one.  This file imports neither
jax nor the JAX package, so on a machine without jax it runs without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import contextlib
import io
import random

import numpy as np
import pytest
import torch

from gfalign_torch import synth
from gfalign_torch.bench_seqalign import (BAND_WALK_CASES, WALK_BLOCK_RUNS,
                                          WALK_CASES, WALK_CLR, band_walk_case,
                                          clr_band_walks, clr_pair,
                                          ultra_long_band_walks,
                                          ultra_long_banded_inputs,
                                          walk_block_case, walk_budget, walk_case,
                                          walk_mode_patches)
from gfalign_torch.cli.main import main
from gfalign_torch.engine.evaluate import evaluate_candidates
from gfalign_torch.io import native
from gfalign_torch.ops import nw_cuda, seqalign, seqalign_cuda
from gfalign_torch.ops.nw_path import Step, nw_best_scores_ref, nw_pair_scores_ref
from gfalign_torch.utils import profiling
from tests.test_torch_goldens import port_search_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_batch(seed, C, n, R, m, nodes):
    """Ragged key batches with empty rows, pads -1 / -2, on the CPU."""
    rng = np.random.default_rng(seed)
    a_keys = (rng.integers(0, nodes, (C, n)) * 4
              + rng.integers(0, 3, (C, n))).astype(np.int32)
    a_len = rng.integers(0, n + 1, (C,)).astype(np.int32)
    a_len[0] = 0
    a_keys[np.arange(n)[None, :] >= a_len[:, None]] = -1
    b_keys = (rng.integers(0, nodes, (R, m)) * 4
              + rng.integers(0, 2, (R, m))).astype(np.int32)
    b_len = rng.integers(0, m + 1, (R,)).astype(np.int32)
    b_len[0], b_len[-1] = 0, m
    b_keys[np.arange(m)[None, :] >= b_len[:, None]] = -2
    return [torch.from_numpy(x) for x in (a_keys, a_len, b_keys, b_len)]


# (C, n, R, m, distinct nodes, longest read or None for m)
KERNEL_SHAPES = {
    "K1": (8, 24, 256, 16, 10, None),
    "K1-narrow": (5, 12, 300, 5, 3, None),
    "K1-search-like": (37, 8, 3000, 16, 6, 15),       # every bucket, ragged chunk
    "K1-one-candidate": (1, 8, 129, 16, 4, 15),
    "K1-m33": (9, 24, 700, 33, 5, None),              # a strip and one column
    "K1-strips": (3, 40, 130, 70, 6, None),
    "K1-m64": (20, 64, 1000, 64, 6, None),
    "K1-under-8192": (2, 8176, 5, 15, 30, None),      # pad8(n) + m = 8191
    "K2-over-8192": (2, 8176, 5, 16, 30, None),       # pad8(n) + m = 8192
    "K2": (2, 6144, 256, 2048, 50, None),
    "K2-1-pair": (1, 8190, 1, 64, 20, None),
    "K2-3-pairs": (3, 8000, 1, 600, 20, None),
    "K2-200-pairs": (2, 8190, 100, 8, 20, None),
    "K2-long-candidate": (1, 60000, 2, 40, 9, None),  # 234 KB of keys: streamed
    "K2-wide-read": (1, 300, 2, 9000, 30, None),      # wider than one block
}


def shaped_batch(name):
    C, n, R, m, nodes, longest = KERNEL_SHAPES[name]
    ak, al, bk, bl = random_batch(5, C, n, R, m, nodes)
    if name.startswith("K2-") and R <= 2:     # few pairs: make them full length
        al[:], bl[:] = n, m
        ak = torch.from_numpy(np.random.default_rng(1).integers(0, nodes * 4, (C, n))
                              .astype(np.int32))
        bk = torch.from_numpy(np.random.default_rng(2).integers(0, nodes * 4, (R, m))
                              .astype(np.int32))
    elif longest is not None:
        bl = torch.minimum(bl, torch.tensor(longest, dtype=torch.int32))
        bk = torch.where(torch.arange(m)[None, :] < bl[:, None], bk, -2).int()
    return ak, al, bk, bl, "packed" if nw_cuda.uses_packed(n, m) else "split"


@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
def test_kernel_matches_plain(shape, cuda):
    ak, al, bk, bl, kind = shaped_batch(shape)
    assert kind == ("packed" if shape.startswith("K1") else "split")
    ak, al, bk, bl = (x.to(cuda) for x in (ak, al, bk, bl))
    before = nw_cuda.LAUNCHES[kind]
    got = nw_cuda.nw_pair_scores_cuda(ak, al, bk, bl)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES[kind] > before
    assert torch.equal(got, nw_pair_scores_ref(ak, al, bk, bl))
    best = nw_cuda.nw_best_scores_cuda(ak, al, bk, bl)     # both orientations
    assert torch.equal(best, nw_best_scores_ref(ak, al, bk, bl))


def test_prepared_operand_is_reused(cuda):
    ak, al, bk, bl, _ = shaped_batch("K1-search-like")
    ak, al, bk, bl = (x.to(cuda) for x in (ak, al, bk, bl))
    operand = nw_cuda.ReadOperand(bk, bl)
    assert len(set(operand.block_w)) > 4                   # several instances
    want = nw_best_scores_ref(ak, al, bk, bl)
    for C in (37, 5, 1):
        got = nw_cuda.scores_prepared(ak[:C].contiguous(), al[:C].contiguous(), operand)
        assert got.shape == (C, operand.Rp)
        assert torch.equal(operand.to_caller_order(got), want[:C])
        assert int(got[:, operand.R:].abs().sum()) == 0    # pad rows score 0


def test_kernel_rejects_bad_inputs(cuda):
    ak, al, bk, bl = (x.to(cuda) for x in random_batch(1, 3, 8, 16, 8, 4))
    with pytest.raises(TypeError):
        nw_cuda.nw_pair_scores_cuda(ak.long(), al, bk, bl)
    with pytest.raises(ValueError):
        nw_cuda.nw_pair_scores_cuda(ak, al, bk, bl.cpu())
    with pytest.raises(ValueError):
        nw_cuda.nw_pair_scores_cuda(ak.t(), al, bk, bl)
    with pytest.raises(ValueError):
        nw_cuda.nw_pair_scores_cuda(ak, al, bk.t(), bl)
    operand = nw_cuda.ReadOperand(bk, bl)
    with pytest.raises(ValueError):
        nw_cuda.scores_prepared(ak, al[:2], operand)
    with pytest.raises(ValueError, match="128-row"):
        nw_cuda.scores_prepared(ak, al, nw_cuda.ReadOperand(bk, bl, block_rows=8))
    with pytest.raises(ValueError, match="CUDA"):
        nw_cuda.scores_prepared(ak.cpu(), al.cpu(), nw_cuda.ReadOperand(bk.cpu(), bl.cpu()))


@pytest.mark.parametrize("filt", [True, False])
def test_evaluate_candidates_cuda_matches_cpu(filt, cuda):
    rng = random.Random(3)
    def path(k):
        return [Step(rng.randrange(8), rng.choice("+-")) for _ in range(k)]
    cands = [path(rng.randrange(1, 12)) for _ in range(37)]
    reads = [path(rng.randrange(0, 10)) for _ in range(300)]
    got = evaluate_candidates(cands, reads, filt, device=cuda)
    want = evaluate_candidates(cands, reads, filt, device="cpu")
    assert got == want


def test_cli_on_cuda_matches_cpu(cuda, tmp_path):
    wl = synth.make_workload(seed=2, n_segments=120, n_reads=300, tangle_k=5)
    paths = port_search_inputs(wl, tmp_path)
    outs = {}
    for mode, extra in (("search", ["-n", paths["search_nodelist"], "-s",
                                    wl.source, "-d", wl.destination]),
                        ("evalPath", ["-p", wl.true_path])):
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main([mode, "-f", paths["gfa"], "-g", paths["gaf"]] + extra,
                            device=dev) == 0
            outs[mode, dev] = buf.getvalue()
        assert outs[mode, "cuda"] == outs[mode, "cpu"] != ""


def code_grid(seed, rows, width):
    """int8 codes 0-4 with PAD tails, mid-row PAD masks and an all-PAD row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, (rows, width)).astype(np.int8)
    for i in range(rows):
        a[i, int(rng.integers(0, width + 1)):] = seqalign.PAD
        if i % 3 == 0:
            lo = int(rng.integers(0, width))
            a[i, lo:int(rng.integers(lo, width))] = seqalign.PAD
    a[0, :] = seqalign.PAD
    return torch.from_numpy(a)


def assert_outputs_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shape", [(9, 7, 37, 45), (33, 5, 100, 130),
                                   (6, 3, 300, 2500), (3, 3, 200, 9000),
                                   (2, 2, 40000, 64), (5, 2, 400, 20000)],
                         ids=["tiny", "one-warp", "warps", "strips", "wide-key",
                              "many-blocks"])
def test_local_kernels_match_plain(shape, cuda):
    R, P, lr, lp = shape
    reads = code_grid(1, R, lr).to(cuda)
    paths = code_grid(2, P, lp).to(cuda)
    before = dict(seqalign_cuda.LAUNCHES)
    got = seqalign.batched_local_scores(reads, paths)              # K5
    assert_outputs_equal(got, seqalign.local_forward_ref(reads, paths))
    pair_paths = code_grid(3, R, lp).to(cuda)
    got = seqalign.batched_pair_scores(reads, pair_paths)          # K4
    assert_outputs_equal(got, seqalign.local_forward_pairs_ref(reads, pair_paths))
    assert seqalign_cuda.LAUNCHES["cross"] > before["cross"]
    assert seqalign_cuda.LAUNCHES["pairs"] > before["pairs"]


@pytest.mark.parametrize("width", [8, 16, 128, 512, 520, 1024, 2048, 4096])
def test_banded_kernel_matches_plain(width, cuda):
    reads = code_grid(4, 40, 300).to(cuda)
    paths = code_grid(5, 40, 700).to(cuda)
    deltas = torch.from_numpy(np.random.default_rng(6).integers(-40, 300, 40)
                              .astype(np.int32)).to(cuda)
    before = seqalign_cuda.LAUNCHES["banded"]
    got = seqalign.banded_pair_scores(reads, paths, deltas, width=width)   # K3
    assert_outputs_equal(got, seqalign._banded_forward(reads, paths, deltas,
                                                       width=width))
    assert seqalign_cuda.LAUNCHES["banded"] > before


def test_banded_kernel_read_pool_off_a_word(cuda):
    # rows of 300 codes in a contiguous view one byte past a word
    reads = code_grid(4, 40, 300).to(cuda)
    store = torch.full((40 * 300 + 1,), seqalign.PAD, dtype=torch.int8, device=cuda)
    store[1:] = reads.reshape(-1)
    shifted = store[1:].view(40, 300)
    assert shifted.is_contiguous() and shifted.data_ptr() % 4 == 1
    paths = code_grid(5, 40, 700).to(cuda)
    deltas = torch.from_numpy(np.random.default_rng(6).integers(-40, 300, 40)
                              .astype(np.int32)).to(cuda)
    for width in (128, 520):
        got = seqalign.banded_pair_scores(shifted, paths, deltas, width=width)
        assert_outputs_equal(got, seqalign._banded_forward(reads, paths, deltas,
                                                           width=width))


@pytest.mark.parametrize("width", [1024, 2048])
def test_banded_kernel_at_ultra_long_reads(width, cuda):
    """K3 at ont_r10.align's shape: a read pool padded to 262,144 columns,
    three reads over 131,072 live rows (the longest 201.6 kb), so int64
    keys and the block kernel's strip sized by the longest read; equal to
    the plain version on the same inputs."""
    args = tuple(x.to(cuda) for x in ultra_long_banded_inputs())
    got = seqalign_cuda.banded_arena_scores_cuda(*args, width)
    want = seqalign.banded_arena_scores_ref(*args, width)
    assert_outputs_equal(got, want)
    assert int(got[1].max()) > 1 << 17


def test_seqalign_kernels_reject_bad_inputs(cuda):
    reads, paths = code_grid(1, 4, 32).to(cuda), code_grid(2, 4, 48).to(cuda)
    with pytest.raises(TypeError):
        seqalign.batched_pair_scores(reads.int(), paths)
    with pytest.raises(ValueError):
        seqalign.batched_pair_scores(reads, paths.cpu())
    with pytest.raises(ValueError):
        seqalign.batched_pair_scores(reads, paths[:3])
    with pytest.raises(ValueError):
        seqalign_cuda.local_forward_cuda(reads.t(), paths, pairwise=False)
    with pytest.raises(ValueError, match="band width"):
        seqalign.banded_pair_scores(reads, paths, torch.zeros(4, dtype=torch.int32),
                                    width=6)


def host_band_walks(walks):
    """The native host walk (seq_banded_traceback) of each banded walk."""
    return [native.banded_local_traceback(
        *walk, seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP, seqalign.PAD,
        seqalign._BLOCK) for walk in walks]


@pytest.mark.parametrize("width", [16, 100, 128, 200, 512, 520, 1024, 2048, 4096,
                                   8192])
def test_bandtrace_kernel_matches_native_and_plain(width, cuda):
    """The banded walk kernel (sa_bandtrace) against the native walk and
    the plain version, bit-exact, on every small case of bench_seqalign's
    (PAD-masked reads and paths, N codes, ties, local starts, bands over
    either end of the path, declines of both gates, ends on and off the
    band's edge), one launch for all of them."""
    walks = [band_walk_case(case, width) for case in BAND_WALK_CASES]
    before = seqalign_cuda.LAUNCHES["bandtrace"]
    got = seqalign_cuda.banded_walks_cuda(walks, cuda)
    assert seqalign_cuda.LAUNCHES["bandtrace"] == before + 1
    assert got == host_band_walks(walks)
    assert got == [seqalign.banded_walk_ref(*walk) for walk in walks]
    assert got[BAND_WALK_CASES.index("edge-walk")] is None
    assert got[BAND_WALK_CASES.index("random")] is not None


def mixed_band_walks(cuda):
    """One wave of every layout: the small cases at bands 128-2,048 and
    CLR-sized walks at 512 and 1,024."""
    return ([band_walk_case(case, width) for width in (128, 512, 1024, 2048)
             for case in BAND_WALK_CASES]
            + clr_band_walks(6, 512, cuda) + clr_band_walks(3, 1024, cuda, seed=16))


def test_bandtrace_kernel_on_a_mixed_wave(cuda):
    walks = mixed_band_walks(cuda)
    before = seqalign_cuda.LAUNCHES["bandtrace"]
    got = seqalign_cuda.banded_walks_cuda(walks, cuda)
    assert seqalign_cuda.LAUNCHES["bandtrace"] == before + 1
    assert got == host_band_walks(walks)
    assert sum(g is not None and len(g[5]) > 10_000 for g in got) >= 6


def test_bandtrace_budget_splits_a_wave(cuda, monkeypatch):
    """A wave over the codes budget runs as several launches, one a walk
    at a budget of one byte (the walks of no rows, which hold no codes,
    together), with the results of one walk at a time."""
    walks = mixed_band_walks(cuda)
    rows = [w[2] for w in walks
            if seqalign.band_end(len(w[0]), len(w[1]), *w[2:6]) is not None]
    whole = seqalign_cuda.banded_walks_cuda(walks, cuda)
    alone = [seqalign_cuda.banded_walks_cuda([w], cuda)[0] for w in walks]
    monkeypatch.setattr(seqalign_cuda, "BANDTRACE_BUDGET", 1)
    before = seqalign_cuda.LAUNCHES["bandtrace"]
    split = seqalign_cuda.banded_walks_cuda(walks, cuda)
    assert (seqalign_cuda.LAUNCHES["bandtrace"] - before
            == sum(r > 0 for r in rows) + (0 in rows))
    assert split == alone
    assert split == whole


@pytest.mark.parametrize("width", [1024, 2048])
def test_bandtrace_kernel_at_ultra_long_reads(width, cuda):
    """The banded walk at ont_r10.align's shape: reads of 3-201.6 kb, the
    longest twice (once 700 diagonals off, so that its band loses it),
    ending at K3's best cells; equal to the native walk."""
    walks = ultra_long_band_walks(width, cuda)
    got = seqalign_cuda.banded_walks_cuda(walks, cuda)
    assert got == host_band_walks(walks)
    assert max(w[2] for w, g in zip(walks, got) if g is not None) > 150_000


def test_align_on_cuda_walks_banded_on_the_card(cuda, tmp_path):
    """On CUDA every banded walk goes to the banded walk kernel, in waves,
    and every full walk to the walk kernel; the GAF is the CPU run's."""
    kw = dict(seed=7, n_segments=80, n_reads=24, seg_len=(200, 600),
              read_len=(1000, 3000), sub_rate=0.03, ins_rate=0.03,
              del_rate=0.03, tangle_read_frac=0.3)
    paths = synth.write_workload(synth.make_workload(**kw), str(tmp_path))
    gafs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.gaf"
        before = profiling.snapshot()
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["align", "-f", paths["gfa"], "-r", paths["reads"], "-o",
                         str(out), "-p", "CLR", "--band", "24", "--wide-band",
                         "40"], device=dev) == 0
        counts[dev] = profiling.since(before)["counts"]
        gafs[dev] = out.read_bytes()
    assert gafs["cuda"] == gafs["cpu"] != b""
    card, host = counts["cuda"], counts["cpu"]
    for key in ("banded_walks", "declined", "full_walks"):
        assert card[f"align.traceback.{key}"] == host[f"align.traceback.{key}"] > 0
    assert "align.traceback.native" not in card
    assert card["align.traceback.banded_cuda"] == card["align.traceback.banded_walks"]
    assert card["align.traceback.cuda"] == card["align.traceback.full_walks"]
    assert 0 < card["kernels.seqalign.bandtrace"] < card["align.traceback.banded_walks"]


@pytest.mark.parametrize("case", list(WALK_CASES) + list(WALK_CLR))
def test_walk_kernel_matches_the_host_walk(case, cuda):
    """The exact full-matrix walk on the card (sa_walk) against the native
    host walk, the CPU's route: one walk launch a walk.  The CLR-sized
    pairs end at K4's best cell."""
    if case in WALK_CLR:
        lr, lp, pad = WALK_CLR[case]
        read, path = clr_pair(np.random.default_rng(lr), lr, lp, pad)
        _, bi, bj = seqalign.batched_pair_scores(torch.from_numpy(read[None]).to(cuda),
                                                 torch.from_numpy(path[None]).to(cuda))
        ei, ej = int(bi[0]), int(bj[0])
    else:
        read, path, ei, ej = walk_case(case)
    before = dict(seqalign_cuda.LAUNCHES), dict(seqalign.TRACEBACK_CALLS)
    got = seqalign.traceback(read, path, ei, ej, cuda)
    assert seqalign_cuda.LAUNCHES["walk"] == before[0]["walk"] + 1
    assert seqalign.TRACEBACK_CALLS["cuda"] == before[1]["cuda"] + 1
    assert seqalign.TRACEBACK_CALLS["native"] == before[1]["native"]
    assert got == seqalign.traceback(read, path, ei, ej)
    if case in WALK_CLR:
        assert got.score > 1000 and ei * ej > 5 * 10 ** 8


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_kernel_codes_match_plain(case, cuda):
    """Every cell's walk code on the card against the plain version's."""
    read, path, ei, ej = walk_case(case)
    r = torch.from_numpy(read[:ei].copy())
    p = torch.from_numpy(path[:ej].copy())
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _, codes = seqalign_cuda._launch_walk(seqalign_cuda._lib(), r.to(cuda),
                                          p.to(cuda), stream)
    _, want = seqalign.walk_codes_ref(r, p)
    np.testing.assert_array_equal(seqalign_cuda.walk_codes(codes.cpu(), ei, ej),
                                  want.numpy()[1:, 1:])


def card_walk(read, path, cuda, budget):
    """The walk on the card of read against path from their last cell
    under `budget`: (score, qstart, pstart, matches, nm, ops), its blocks."""
    r = torch.from_numpy(np.ascontiguousarray(read)).to(cuda)
    p = torch.from_numpy(np.ascontiguousarray(path)).to(cuda)
    before = profiling.snapshot()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    out, _ = seqalign_cuda._launch_walk(seqalign_cuda._lib(), r, p, stream, budget)
    return (seqalign_cuda.walk_result(out.cpu(), len(read), len(path)),
            profiling.since(before)["counts"]["kernels.seqalign.walk_blocks"])


@pytest.mark.parametrize("case, mode", WALK_BLOCK_RUNS)
def test_blocked_walk_kernel_matches_unblocked_and_plain(case, mode, cuda, monkeypatch):
    """The walk on the card cut to the ladder's score's columns, in row
    blocks of 64 rows (the budget forced small) or as one tile, against the
    unblocked walk over the whole rectangle and the plain version."""
    read, path, ei, ej, score = walk_block_case(case)
    want = seqalign.full_walk(torch.from_numpy(read[:ei].copy()),
                              torch.from_numpy(path[:ej].copy()))
    whole, _ = card_walk(read[:ei], path[:ej], cuda, walk_budget("whole", ej))
    assert whole == want
    c0 = seqalign.walk_window(read, path, ei, ej, score)
    for name, value in walk_mode_patches(mode).items():
        monkeypatch.setattr(seqalign_cuda, name, value)
    got, blocks = card_walk(read[:ei], path[c0:ej], cuda, walk_budget(mode, ej - c0))
    assert got[:2] + (got[2] + c0,) + got[3:] == want
    assert (blocks == 1) == (mode == "whole")


@pytest.mark.parametrize("case", list(WALK_CLR))
def test_blocked_walk_kernel_at_clr_sizes(case, cuda, monkeypatch):
    """The CLR-sized pairs, ending at K4's best cell, walked in the band's
    row blocks, in whole-width ones and as one tile: the same walk."""
    lr, lp, pad = WALK_CLR[case]
    read, path = clr_pair(np.random.default_rng(lr), lr, lp, pad)
    _, bi, bj = seqalign.batched_pair_scores(torch.from_numpy(read[None]).to(cuda),
                                             torch.from_numpy(path[None]).to(cuda))
    read, path = read[:int(bi[0])], path[:int(bj[0])]
    whole, _ = card_walk(read, path, cuda, walk_budget("whole", len(path)))
    for mode, block_rows in (("band", 8192), ("rows", 2048)):
        with monkeypatch.context() as patch:
            for name, value in walk_mode_patches(mode).items():
                patch.setattr(seqalign_cuda, name, value)
            budget = walk_budget(mode, len(path), block_rows)
            plan = seqalign_cuda.walk_plan(len(read), len(path), budget)
            got, blocks = card_walk(read, path, cuda, budget)
        assert got == whole and blocks > 1, mode
        if mode == "band" and not pad:  # the band's blocks, one launch
            assert blocks == -(-len(read) // plan.every)


def test_walk_kernel_rejects_bad_inputs(cuda, monkeypatch):
    read, path, ei, ej = walk_case("random-0")
    r, p = torch.from_numpy(read).to(cuda), torch.from_numpy(path).to(cuda)
    with pytest.raises(TypeError):
        seqalign_cuda.full_walk_cuda(r.int(), p)
    with pytest.raises(ValueError):
        seqalign_cuda.full_walk_cuda(r, p.cpu())
    with pytest.raises(ValueError):
        seqalign_cuda.full_walk_cuda(r[None], p)
    with pytest.raises(ValueError):
        seqalign.traceback(read, path, len(read) + 1, ej, cuda)
    # a launch the kernel refuses raises, and no host walk stands in
    monkeypatch.setattr(seqalign_cuda, "walk_layout", lambda cols: (48, 8))
    before = dict(seqalign.TRACEBACK_CALLS)
    with pytest.raises(RuntimeError, match="sa_walk launch failed"):
        seqalign.traceback(read, path, ei, ej, cuda)
    assert seqalign.TRACEBACK_CALLS["native"] == before["native"]


@pytest.mark.parametrize("kw", [dict(seed=41, n_segments=120, n_reads=10,
                                     seg_len=(120, 400), read_len=(300, 900),
                                     sub_rate=0.01, ins_rate=0.002, del_rate=0.002),
                                dict(seed=3, n_segments=12, n_reads=12,
                                     seg_len=(60, 120), read_len=(80, 200),
                                     bubble_every=4, tangle_k=2)],
                         ids=["seeded", "exhaustive"])
def test_align_on_cuda_matches_cpu(kw, cuda, tmp_path):
    paths = synth.write_workload(synth.make_workload(**kw), str(tmp_path))
    gafs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.gaf"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["align", "-f", paths["gfa"], "-r", paths["reads"], "-o",
                         str(out)], device=dev) == 0
        gafs[dev] = out.read_bytes()
    assert gafs["cuda"] == gafs["cpu"] != b""
