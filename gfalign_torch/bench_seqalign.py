"""Times K3, K4 and the walk (csrc/seqalign.cu) on the card at the shapes
the seeded and band-edge `align` runs and clr.align's fallback walks give
them, synthesised here so that no 300 s
align run is needed, under other launch geometries than the wrapper's own,
to check the rules of ops/seqalign_cuda.py (`banded_layout`,
`pairs_layout`, `walk_layout`):

    python -m gfalign_torch.bench_seqalign

Shapes: K3 at N = 4,096 pairs (width 128) and 3,910 (width 512) of reads
of lr = 8,192 whose lengths are those of make_workload(seed=0)'s first
reads (2-8 kb), each against a path of random segments around the read's
source (1% substitutions, a diagonal off by up to 8), and at widths 1,024
and 2,048 (bands of several warps, which keep one block a pair) on the
first 1,024 of those pairs; K4 at 16 pairs of
4,096 x 8,192, 12 reads of 3 kb and 4 all-PAD rows, as the band-edge run
sends them, and at more pairs (32, 64, 128 and 256 of 4,096 x 8,192,
1,024 of 2,048 x 4,096, all live: each side of pairs_layout's switch from
split pairs to one block a pair), as a chunk of
seeded.SeededAlign.score_full can hold when many band-edge pairs survive a
round; the walk at WALK_CLR's three CLR-sized pairs (20-30 kb reads at 87%
against 40-60 kb paths) under one to eight warps a block.  Every variant is checked against the default geometry's outputs,
and the default against the plain version on a few pairs.  Needs a CUDA
device; prints one line per variant with the card's name and power limit
first.

Copied into a checkout whose ops/seqalign_cuda.py predates the layouts
(one block per pair), it times that checkout's wrappers at the same shapes
instead, so that old and new kernels can be read on one card in one
session.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import synth
from .bench_nw import time_ms
from .ops import seqalign, seqalign_cuda
from .ops.seqalign import PAD

K3_PAIRS = {128: 4096, 512: 3910}   # pairs of the seeded run's largest chunks
K3_WIDE = {1024: 1024, 2048: 1024}  # bands of several warps: the block kernel
PLAIN_PAIRS = 48                    # pairs the plain version checks
# K4: name -> (pairs, lr, lp, live read, live path, all-PAD pairs)
K4_SHAPES = {"16 pairs 4096 x 8192": (16, 4096, 8192, 3000, 7000, 4),
             "32 pairs 4096 x 8192": (32, 4096, 8192, 3000, 7000, 0),
             "64 pairs 4096 x 8192": (64, 4096, 8192, 3000, 7000, 0),
             "128 pairs 4096 x 8192": (128, 4096, 8192, 3000, 7000, 0),
             "256 pairs 4096 x 8192": (256, 4096, 8192, 3000, 7000, 0),
             "1024 pairs 2048 x 4096": (1024, 2048, 4096, 1500, 3500, 0)}
K4_PLAIN_PAIRS = 16                 # pairs the plain version checks
# The exact full-matrix walk (sa_walk) at the sizes of clr.align's fallback
# walks: name -> (read template length, path length, PAD bases mid-read)
WALK_CLR = {"clr 20 kb x 40 kb": (20000, 40000, 0),
            "clr 25 kb x 50 kb, a PAD stretch": (25000, 50000, 800),
            "clr 30 kb x 60 kb": (30000, 60000, 0)}
# ... and small pairs that reach each of its cases (walk_case)
WALK_CASES = ("random-0", "random-1", "random-2", "pad-masked", "repeats",
              "homopolymers", "mid-row-start", "row-0", "column-0", "corner",
              "several-tiles")


def _mutated(rng, seq, rate=0.01):
    out = seq.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = rng.integers(0, 4, int(hit.sum()))
    return out


def banded_inputs(rng, read_lens, lr=8192, s_cap=24):
    """K3's pools for one path and one read per pair: the arena of 3,000
    random segments of 300-1,200 bases, paths of random segments up to the
    read's length plus 400, each read a mutated slice of its path, the
    delta its offset give or take 8.  Returns the eight argument tensors of
    banded_arena_scores_cuda, on the CPU."""
    seg_lens = rng.integers(300, 1201, 3000)
    starts = np.concatenate([[0], np.cumsum(seg_lens)[:-1]])
    arena = rng.integers(0, 4, int(seg_lens.sum())).astype(np.int8)
    N = len(read_lens)
    cum_off = np.full((N, s_cap), (1 << 31) - 1, np.int32)
    base_ptr = np.zeros((N, s_cap), np.int32)
    plen = np.zeros(N, np.int32)
    reads = np.full((N, lr), PAD, np.int8)
    deltas = np.zeros(N, np.int32)
    for n, length in enumerate(read_lens):
        pos, pieces = 0, []
        for k in range(s_cap):
            s = int(rng.integers(0, len(seg_lens)))
            cum_off[n, k], base_ptr[n, k] = pos, starts[s] - pos
            pieces.append(arena[starts[s]:starts[s] + seg_lens[s]])
            pos += int(seg_lens[s])
            if pos >= length + 400:
                break
        plen[n] = pos
        path = np.concatenate(pieces)
        x0 = int(rng.integers(0, max(1, pos - length)))
        read = _mutated(rng, path[x0:x0 + min(length, lr)])
        reads[n, :len(read)] = read
        deltas[n] = x0 + int(rng.integers(-8, 9))
    idx = np.arange(N, dtype=np.int32)
    return tuple(torch.from_numpy(x) for x in
                 (arena, cum_off, base_ptr, plen, reads, idx, idx, deltas))


# K3 at ont_r10.align's shape: a read pool padded to 262,144 columns (a
# read over 131,072 bases), live reads of these lengths, bands 1,024 / 2,048
K3_ULTRA_LONG_LR = 262_144
K3_ULTRA_LONG_READS = (201_600, 160_000, 140_000, 20_000, 3_000)


def ultra_long_banded_inputs():
    """banded_inputs at K3_ULTRA_LONG's shape (three reads over 131,072
    live rows, the longest the cell's), plus the longest read again with
    its diagonal 700 off, so that its band loses it part of the way."""
    rng = np.random.default_rng(K3_ULTRA_LONG_LR)
    args = banded_inputs(rng, K3_ULTRA_LONG_READS, lr=K3_ULTRA_LONG_LR, s_cap=320)
    idx = torch.tensor(list(range(len(K3_ULTRA_LONG_READS))) + [0], dtype=torch.int32)
    deltas = torch.cat([args[7], args[7][:1] + 700])
    return args[:5] + (idx, idx.clone(), deltas)


def local_inputs(rng, R, P, lr, lp, live_read, live_path, pad_rows=0):
    """Reads (R, lr) and paths (P, lp) of int8 codes on the CPU: paths of
    live_path random bases, each read a mutated slice of path r % P of
    live_read bases, the last pad_rows reads all PAD."""
    paths = np.full((P, lp), PAD, np.int8)
    paths[:, :live_path] = rng.integers(0, 4, (P, live_path))
    reads = np.full((R, lr), PAD, np.int8)
    for r in range(R - pad_rows):
        x0 = int(rng.integers(0, live_path - live_read + 1))
        reads[r, :live_read] = _mutated(rng, paths[r % P, x0:x0 + live_read])
    return torch.from_numpy(reads), torch.from_numpy(paths)


def _mutated_indels(rng, seq, sub, ins, dele):
    """seq with substitutions, insertions and deletions at these rates."""
    out = seq.copy()
    hit = rng.random(len(out)) < sub
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    out = out[rng.random(len(out)) >= dele]
    at = np.flatnonzero(rng.random(len(out)) < ins)
    return np.insert(out, at, rng.integers(0, 4, len(at)).astype(np.int8))


def clr_pair(rng, lr, lp, pad=0):
    """(read, path) int8 codes of a CLR-like pair: a template of lr random
    bases mid-path among lp, the read the template at ~87% identity (2%
    substitutions, 6% insertions, 5% deletions), `pad` bases of it masked
    with PAD mid-read, as an earlier placement round masks them."""
    template = rng.integers(0, 4, lr).astype(np.int8)
    read = _mutated_indels(rng, template, 0.02, 0.06, 0.05)
    if pad:
        read[len(read) // 2:len(read) // 2 + pad] = PAD
    left = (lp - lr) // 2
    path = np.concatenate([rng.integers(0, 4, left), template,
                           rng.integers(0, 4, lp - lr - left)]).astype(np.int8)
    return read, path


def walk_case(name: str):
    """(read, path, end_i, end_j) of a small full-walk case (WALK_CASES), as
    int8 codes: a read mutated from its path, ending at the pair's best
    cell by the plain local scorer, unless the case names its end cell."""
    rng = np.random.default_rng(sum(map(ord, name)))
    flank = lambda n: rng.integers(0, 4, n).astype(np.int8)
    if name.startswith("random") or name in ("pad-masked", "row-0", "column-0",
                                             "corner"):
        core = flank(int(rng.integers(60, 400)))
        read = _mutated_indels(rng, core, 0.05, 0.02, 0.02)
        path = np.concatenate([flank(int(rng.integers(0, 40))), core,
                               flank(int(rng.integers(0, 40)))])
        if name == "random-2":
            read[rng.random(len(read)) < 0.03] = 4      # N codes
        if name == "pad-masked":                        # masked stretches
            read[20:45] = PAD
            read[len(read) // 2:len(read) // 2 + 6] = PAD
    elif name == "repeats":                             # many equal moves
        core = np.tile(np.array([0, 1], np.int8), 90)
        read = _mutated_indels(rng, core, 0.03, 0.03, 0.03)
        path = np.concatenate([flank(10), np.tile(np.array([0, 1], np.int8), 100),
                               flank(10)])
    elif name == "homopolymers":                        # gaps that can slide
        runs = rng.integers(1, 9, 60)
        core = np.repeat(rng.integers(0, 4, 60).astype(np.int8), runs)
        read = _mutated_indels(rng, core, 0.0, 0.05, 0.05)
        path = np.concatenate([flank(15), core, flank(15)])
    elif name == "mid-row-start":                       # a local start inside
        core = flank(200)
        read = np.concatenate([flank(60), _mutated_indels(rng, core, 0.03, 0.01, 0.01)])
        path = np.concatenate([flank(80), core, flank(30)])
    elif name == "several-tiles":                       # blocks and walk tiles
        core = flank(1100)
        read = _mutated_indels(rng, core, 0.04, 0.02, 0.02)
        path = np.concatenate([flank(300), core, flank(200)])
    else:
        raise KeyError(name)
    read, path = read.astype(np.int8), path.astype(np.int8)
    if name == "row-0":
        return read, path, 0, len(path) // 2
    if name == "column-0":
        return read, path, len(read) // 2, 0
    if name == "corner":
        return read, path, len(read), len(path)
    _, bi, bj = seqalign.local_forward_pairs_ref(torch.from_numpy(read[None]),
                                                 torch.from_numpy(path[None]))
    return read, path, int(bi[0]), int(bj[0])


# ... and pairs for the cut walk and its row blocks (walk_block_case)
WALK_BLOCK_CASES = ("random-3", "random-4", "drift", "pad-masked",
                    "left-edge-ties", "several-blocks", "one-block")


def walk_block_case(name: str):
    """(read, path, end_i, end_j, score) of a pair for the cut walk and its
    row blocks (WALK_BLOCK_CASES), as int8 codes: the read a mutated stretch
    of a path with a long left flank, so that the ladder's score (`score`,
    H at the end cell) cuts the walk's columns (seqalign.walk_window);
    ending at the pair's best cell, or at the corner for 'left-edge-ties'.
    'drift' has a net deletion bias, 'pad-masked' masked stretches (no
    cut), 'left-edge-ties' a read of homopolymer runs with deletions only,
    whose alignment starts at the window's first column with equal moves
    around it; 'several-blocks' is the largest."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    flank = lambda n: rng.integers(0, 4, n).astype(np.int8)
    n = {"several-blocks": 640, "one-block": 150}.get(name, 360)
    core = flank(n)
    read = _mutated_indels(rng, core, 0.03, 0.01, 0.02)
    if name == "drift":
        read = _mutated_indels(rng, core, 0.01, 0.005, 0.06)
    elif name == "pad-masked":
        read[40:90] = PAD
        read[len(read) // 2:len(read) // 2 + 7] = PAD
    elif name == "left-edge-ties":
        core = np.repeat(rng.integers(0, 4, 120).astype(np.int8),
                         rng.integers(1, 5, 120))
        keep = np.ones(len(core), bool)
        keep[rng.choice(len(core), len(core) // 25, replace=False)] = False
        keep[1] = False                   # a deletion at the start
        read = core[keep]
    left = int(rng.integers(n // 2, n + 1))
    path = np.concatenate([flank(left), core,
                           flank(int(rng.integers(0, 30)))]).astype(np.int8)
    read = read.astype(np.int8)
    if name == "left-edge-ties":          # the flank's last base ties too
        path[left - 1] = core[0]
        ei, ej = len(read), left + len(core)
        score, _ = seqalign.walk_codes_ref(torch.from_numpy(read),
                                           torch.from_numpy(path[:ej].copy()))
        return read, path, ei, ej, int(score)
    best, bi, bj = seqalign.local_forward_pairs_ref(
        torch.from_numpy(read[None]), torch.from_numpy(path[None]))
    return read, path, int(bi[0]), int(bj[0]), int(best[0])


# the walk modes each case runs in (walk_budget, walk_mode_patches)
WALK_BLOCK_RUNS = ([(case, mode) for case in WALK_BLOCK_CASES
                    for mode in ("whole", "band", "rows")]
                   + [("left-edge-ties", "band-wide")])


def walk_budget(mode: str, cols: int, block_rows: int = 64) -> int:
    """A walk budget (seqalign_cuda.WALK_BUDGET) that walks a rectangle of
    `cols` columns as one tile ('whole') or in row blocks of block_rows
    rows (the other modes)."""
    if mode == "whole":
        return 1 << 40
    return 2 * seqalign_cuda.walk_groups(cols) * block_rows


def walk_mode_patches(mode: str) -> dict:
    """What a test sets on ops/seqalign_cuda to walk in `mode` under
    walk_budget's budget: 'rows' takes no band (whole-width row blocks),
    'band-wide' the band's blocks after a forward pass of 512 threads a
    block; 'whole' and 'band' nothing."""
    if mode == "rows":
        return {"walk_band": lambda *args: None}
    if mode == "band-wide":
        return {"WALK_FWD_THREADS": 512}
    return {}


# The banded walk (sa_bandtrace): small walks that reach each of its cases
# (band_walk_case)
BAND_WALK_CASES = ("random", "pad-masked", "masked-runs", "n-codes", "repeats",
                   "homopolymers", "drift", "edge-walk", "mid-row-start", "path-start",
                   "path-end", "path-pads", "expected-missed", "end-on-edge",
                   "end-off-band", "row-0")


def band_walk_case(name: str, width: int):
    """(read, path, end_i, end_j, delta, width, expected) of a small banded
    walk (BAND_WALK_CASES), int8 codes: a read mutated from a stretch of its
    path, its diagonal a few off, ending at the pair's best cell in the
    band by K3's plain version with that score expected, unless the case
    names its end or its score.  'drift' is a deletion-biased read whose
    end lies a few lanes off lane 0; 'edge-walk' an exact read with one
    deletion whose walk steps onto lane 0, the second gate;
    'long-deletion' (not in BAND_WALK_CASES: 2.7 kb) a walk that crosses
    400 lanes of PAD in one row, for bands of 1,024 lanes and more;
    'expected-missed' expects one more than the end's value; 'end-on-edge'
    and 'end-off-band' end on lane width - 1 and off the band; 'path-start'
    and 'path-end' put the band over either end of the path;
    'masked-runs' masks the read's first 100 bases and 100 mid-read."""
    rng = np.random.default_rng(sum(map(ord, name)) * 8192 + width)
    flank = lambda n: rng.integers(0, 4, n).astype(np.int8)
    n = int(rng.integers(150, 400))
    core = flank(n)
    read = _mutated_indels(rng, core, 0.04, 0.02, 0.02)
    left = int(rng.integers(20, 120))
    right = int(rng.integers(0, 60))
    if name == "pad-masked":                 # an earlier placement's masks
        read[15:40] = PAD
        read[len(read) // 2:len(read) // 2 + 9] = PAD
    elif name == "masked-runs":              # whole chunks of PAD rows
        read[:100] = PAD
        read[len(read) // 2 - 40:len(read) // 2 + 60] = PAD
    elif name == "n-codes":
        read[rng.random(len(read)) < 0.04] = 4
    elif name == "repeats":                  # many equal moves
        core = np.tile(np.array([2, 3], np.int8), n // 2)
        read = _mutated_indels(rng, core, 0.03, 0.03, 0.03)
    elif name == "homopolymers":             # gaps that can slide
        core = np.repeat(flank(n // 4), rng.integers(1, 8, n // 4))
        read = _mutated_indels(rng, core, 0.0, 0.04, 0.04)
    elif name == "drift":
        read = _mutated_indels(rng, core, 0.01, 0.0, 0.12)
    elif name == "edge-walk":  # exact, one deletion: lane 0 above it, 1 below
        read = np.delete(core, n // 2)
    elif name == "long-deletion":  # 400 PAD mid-path that the read skips
        read = _mutated_indels(rng, flank(2700), 0.002, 0.0, 0.0)
        core = np.concatenate([read[:1350], np.full(400, PAD, np.int8),
                               read[1350:]])
        n = len(core)
    elif name == "mid-row-start":            # a local start inside the band
        read = np.concatenate([flank(50), read])
        left += 50
    elif name == "path-start":
        left = 2
    elif name == "path-end":
        right = 0
        read = np.concatenate([read, flank(40)])
    path = np.concatenate([flank(left), core, flank(right)]).astype(np.int8)
    if name == "path-pads":
        path[left + n // 3:left + n // 3 + 5] = PAD
    read = read.astype(np.int8)
    delta = left + int(rng.integers(-4, 5))
    if name == "drift":  # the end near lane 4, and the lanes fall upwards
        delta = left + n - len(read) + width // 2 - 4
    elif name == "edge-walk":
        delta = left + width // 2
    elif name == "long-deletion":        # the start on lane ~300
        delta = left + width // 2 - 300
    best, bi, bj, _ = seqalign._banded_forward(
        torch.from_numpy(read[None]), torch.from_numpy(path[None]),
        torch.tensor([delta], dtype=torch.int32), width=width)
    v, ei, ej = int(best[0]), int(bi[0]), int(bj[0])
    if name == "expected-missed":
        v += 1
    elif name == "end-on-edge":
        ej = ei + delta - width // 2 + width - 1
    elif name == "end-off-band":
        ej = ei + delta + width
    elif name == "row-0":
        ei, ej, v = 0, max(0, delta - width // 2 + 3), 0
    return read, path, ei, ej, delta, width, v


def clr_band_walks(n: int, width: int, device, seed: int = 15):
    """n banded walks of CLR-like pairs (clr_pair: reads of 10-30 kb at 87%
    against paths 2 kb longer) in a band of `width` lanes around the
    template's diagonal, each ending at K3's best cell on `device` with its
    score expected: clr.align's walk shapes."""
    rng = np.random.default_rng(seed)
    pairs = [clr_pair(rng, int(lt), int(lt) + 2000)   # template at 1,000
             for lt in rng.integers(10_000, 30_001, n)]
    lr = max(len(r) for r, _ in pairs)
    lp = max(len(p) for _, p in pairs)
    reads = np.full((n, lr), PAD, np.int8)
    paths = np.full((n, lp), PAD, np.int8)
    for k, (read, path) in enumerate(pairs):
        reads[k, :len(read)], paths[k, :len(path)] = read, path
    deltas = np.full(n, 1000, np.int32)
    best, bi, bj, _ = (x.cpu().numpy() for x in seqalign.banded_pair_scores(
        torch.from_numpy(reads).to(device), torch.from_numpy(paths).to(device),
        torch.from_numpy(deltas).to(device), width=width))
    return [(read, path, int(bi[k]), int(bj[k]), 1000, width, int(best[k]))
            for k, (read, path) in enumerate(pairs)]


def ultra_long_band_walks(width: int, device):
    """The banded walks of ultra_long_banded_inputs' pairs at `width`
    (reads of 3-201.6 kb in a pool padded to 262,144, the longest twice,
    once 700 diagonals off): each pair's read and path as int8 numpy
    arrays, ending at K3's best cell on `device` with its score expected,
    as the placement loop asks for them."""
    arena, cum_off, base_ptr, plen, reads, ridx, pidx, deltas = \
        ultra_long_banded_inputs()
    best, bi, bj, _ = seqalign.banded_arena_scores(
        *(x.to(device) for x in (arena, cum_off, base_ptr, plen, reads)),
        ridx, pidx, deltas, width=width)
    a, co, bp = arena.numpy(), cum_off.numpy(), base_ptr.numpy()
    walks = []
    for n in range(len(ridx)):
        r, p = int(ridx[n]), int(pidx[n])
        read = reads[r].numpy()
        read = read[:int(np.flatnonzero(read != PAD)[-1]) + 1]
        steps = co[p] < int(plen[p])
        x = np.arange(int(plen[p]))
        k = np.searchsorted(co[p][steps], x, side="right") - 1
        path = a[bp[p][steps][k] + x]
        walks.append((read, path, int(bi[n]), int(bj[n]), int(deltas[n]),
                      width, int(best[n])))
    return walks


def synthetic_shapes(seed: int = 0):
    """The phase-10 shapes of chip_smoke.py, on the CPU: 'banded' (K3, the
    4,096 pairs of width 128; width 512 takes the first 3,910), 'pairs'
    (K4, 16 pairs of 4,096 x 8,192) and 'cross' (K5, 256 reads of 512
    against 32 paths of 4,096)."""
    rng = np.random.default_rng(seed)
    wl = synth.make_workload(seed=0)
    read_lens = [len(r[1]) for r in wl.reads[:max(K3_PAIRS.values())]]
    return {"banded": banded_inputs(rng, read_lens),
            "pairs": local_inputs(rng, 16, 16, 4096, 8192, 3000, 7000, pad_rows=4),
            "cross": local_inputs(rng, 256, 32, 512, 4096, 400, 3500)}


def _equal(got, want):
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_seqalign: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    shapes = synthetic_shapes()
    new = hasattr(seqalign_cuda, "banded_layout")
    label = "default" if new else "one block a pair (this checkout's kernel)"
    k3 = tuple(x.cuda() for x in shapes["banded"])
    for width, n in {**K3_PAIRS, **K3_WIDE}.items():
        args = k3[:5] + tuple(x[:n].contiguous() for x in k3[5:])

        def run(args=args, width=width):
            return seqalign_cuda.banded_arena_scores_cuda(*args, width)
        want = run()
        plain = seqalign.banded_arena_scores_ref(
            *args[:5], *(x[:PLAIN_PAIRS] for x in args[5:]), width)
        assert _equal((w[:PLAIN_PAIRS] for w in want), plain), ("K3", width)
        print(f"K3 width {width} N={n} lr=8192: {label}: {time_ms(run):.3f} ms",
              flush=True)
        if not new or width in K3_WIDE:
            continue
        default = seqalign_cuda.banded_layout
        variants = [(4, 0)] if width == 128 else [(16, 0)]
        for layout in variants:
            seqalign_cuda.banded_layout = lambda w, layout=layout: layout
            try:
                assert _equal(run(), want), ("K3", width, layout)
                ms = time_ms(run)
            finally:
                seqalign_cuda.banded_layout = default
            print(f"K3 width {width} N={n} lr=8192: (lanes, threads a pair) = "
                  f"{layout}{' (one block a pair)' if layout[1] == 0 else ''}: "
                  f"{ms:.3f} ms", flush=True)
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (n, lr, lp, live_read, live_path, pad) in K4_SHAPES.items():
        inputs = (shapes["pairs"] if n == 16 else
                  local_inputs(rng, n, n, lr, lp, live_read, live_path, pad))
        reads, paths = (x.cuda() for x in inputs)

        def run_pairs(reads=reads, paths=paths):
            return seqalign_cuda.local_forward_cuda(reads, paths, True)
        want = run_pairs()
        m = K4_PLAIN_PAIRS
        assert _equal((w[:m] for w in want),
                      seqalign.local_forward_pairs_ref(reads[:m], paths[:m])), \
            ("K4", name)
        print(f"K4 {name}: {label}"
              + (f" {seqalign_cuda.pairs_layout(lp, n, sms)}" if new else "")
              + f": {time_ms(run_pairs):.3f} ms", flush=True)
        if not new:
            continue
        default = seqalign_cuda.pairs_layout
        blocks = lambda K, T: -(-lp // (K * T))
        for K, T in [(4, 64), (4, 128), (4, 256), (8, 64), (8, 128), (8, 256),
                     (8, 512), (16, 64), (16, 128), (16, 512)]:
            layout = (K, T, blocks(K, T))
            if layout == default(lp, n, sms) or (n > 16 and K != 8 and T != 512):
                continue
            seqalign_cuda.pairs_layout = lambda lp, pairs, sms, layout=layout: layout
            try:
                assert _equal(run_pairs(), want), ("K4", name, layout)
                ms = time_ms(run_pairs)
            finally:
                seqalign_cuda.pairs_layout = default
            print(f"K4 {name}: (K, T, blocks a pair) = {layout}: {ms:.3f} ms",
                  flush=True)
    if hasattr(seqalign_cuda, "walk_layout"):
        walk_variants(np.random.default_rng(13))
    return 0


def walk_variants(rng):
    """The walk (sa_walk) at WALK_CLR's sizes, each pair ending at K4's
    best cell, under one to eight warps a block; each variant's walk equal
    to the default's."""
    default = seqalign_cuda.walk_layout
    for name, (lr, lp, pad) in WALK_CLR.items():
        read, path = clr_pair(rng, lr, lp, pad)
        _, bi, bj = seqalign.batched_pair_scores(torch.from_numpy(read[None]).cuda(),
                                                 torch.from_numpy(path[None]).cuda())
        ei, ej = int(bi[0]), int(bj[0])
        r, p = torch.from_numpy(read[:ei].copy()).cuda(), torch.from_numpy(path[:ej].copy()).cuda()
        stream = torch.cuda.current_stream().cuda_stream

        def run(r=r, p=p):
            return seqalign_cuda._launch_walk(seqalign_cuda._lib(), r, p, stream)[0]
        want = seqalign_cuda.walk_result(run().cpu(), ei, ej)
        for T in (64, 32, 128, 256):
            layout = (T, -(-ej // (seqalign_cuda.WALK_K * T)))
            seqalign_cuda.walk_layout = lambda cols, layout=layout: layout
            try:
                assert seqalign_cuda.walk_result(run().cpu(), ei, ej) == want, (name, T)
                ms = time_ms(run)
            finally:
                seqalign_cuda.walk_layout = default
            print(f"walk {name}: {ei} x {ej}: (threads, blocks) = {layout}"
                  f"{' (default)' if layout == default(ej) else ''}: {ms:.3f} ms",
                  flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
