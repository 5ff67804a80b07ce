"""Times K3 and K4 (csrc/seqalign.cu) on the card at the shapes the seeded
and band-edge `align` runs give them, synthesised here so that no 300 s
align run is needed, under other launch geometries than the wrapper's own,
to check the rules of ops/seqalign_cuda.py (`banded_layout`,
`pairs_layout`):

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
graph_align.score_pairs_full can hold when many band-edge pairs survive a
round.  Every variant is checked against the default geometry's outputs,
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
