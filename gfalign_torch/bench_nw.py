"""Times K1 and K2 (csrc/nw_path.cu) on the card at the main path's kinds of
shape under other launch geometries than the wrapper's own, to check the
rules of ops/nw_cuda.py (`candidate_chunk`'s TARGET_BLOCKS, `split_layout`):

    python -m gfalign_torch.bench_nw

Shapes: a search-like frontier (240 candidates of 2-6 of 8 steps against
10,000 reads of 2-15 steps drawn like make_workload(seed=0)'s, m = 16),
bench.py's (128 x 16,384, n = m = 64), a long-path batch (2 candidates of
6,000 of 8,192 steps x 32 reads of 500-2,000 of 2,048) and a ragged batch of
512 long pairs.  Every variant is checked against the default geometry's
scores, and the default against the plain version where that takes under a
few seconds.  Needs a CUDA device; prints one line per variant with the
card's name and power limit first.

Copied into a checkout whose ops/nw_cuda.py still has the thread-per-pair
layout (no ReadOperand), it times that wrapper on the stacked forward and
reverse-complement rows at the same shapes instead, so that the two layouts
can be read on one card in one session.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from .ops import nw_cuda, nw_path

# read path lengths of make_workload(seed=0)'s 10,000 reads: steps -> count
SEARCH_READ_LENGTHS = {2: 16, 3: 213, 4: 823, 5: 1175, 6: 1209, 7: 1241, 8: 1246,
                       9: 1215, 10: 1110, 11: 937, 12: 530, 13: 225, 14: 58, 15: 2}


def time_ms(fn, reps=5):
    """Median device time of fn() by CUDA events; the card spins for about a
    millisecond first so that the host's launch overhead stays outside."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def keys(rng, lens, width, pad, nodes, orients):
    k = (rng.integers(0, nodes, (len(lens), width)) * 4
         + rng.integers(0, orients, (len(lens), width))).astype(np.int32)
    k[np.arange(width)[None, :] >= np.asarray(lens)[:, None]] = pad
    return (torch.from_numpy(k).cuda(),
            torch.from_numpy(np.asarray(lens, dtype=np.int32)).cuda())


def shapes(rng):
    search_lens = rng.permutation(np.repeat(list(SEARCH_READ_LENGTHS),
                                            list(SEARCH_READ_LENGTHS.values())))
    return {
        "search-like": (keys(rng, rng.integers(2, 7, 240), 8, -1, 1100, 2),
                        keys(rng, search_lens, 16, -2, 1100, 2)),
        "bench": (keys(rng, np.full(128, 64), 64, -1, 40, 3),
                  keys(rng, np.full(16384, 64), 64, -2, 40, 2)),
        "long-path": (keys(rng, np.full(2, 6000), 8192, -1, 50, 2),
                      keys(rng, rng.integers(500, 2001, 32), 2048, -2, 50, 2)),
        "512-pairs": (keys(rng, rng.integers(0, 6145, 2), 6144, -1, 50, 3),
                      keys(rng, rng.integers(0, 2049, 128), 2048, -2, 50, 2)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_nw: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for name, ((ak, al), (bk, bl)) in shapes(np.random.default_rng(0)).items():
        if not hasattr(nw_cuda, "ReadOperand"):
            both = torch.cat([bk, nw_path.rc_keys_device(bk, bl)])
            both_len = torch.cat([bl, bl])
            ms = time_ms(lambda: nw_cuda.nw_pair_scores_cuda(ak, al, both, both_len))
            print(f"{name}: thread-per-pair layout: {ms:.3f} ms", flush=True)
            continue
        op = nw_cuda.ReadOperand(bk, bl)
        want = nw_cuda.scores_prepared(ak, al, op)
        if name != "bench":
            assert torch.equal(want, nw_path.scores_prepared_ref(ak, al, op)), name
        packed = nw_cuda.uses_packed(ak.shape[1], bk.shape[1])
        if packed:
            default, rule = nw_cuda.TARGET_BLOCKS, "TARGET_BLOCKS"
            variants = [132 * k for k in (2, 4, 8, 16, 32)]
        else:
            default, rule = nw_cuda.split_layout, "split_layout"
            longest = op.max_len
            variants = [(k, min(32 * -(-longest // (32 * k)), nw_cuda.SPLIT_MAX_THREADS[k]))
                        for k in (4, 8, 16)]
        for v in variants:
            if packed:
                nw_cuda.TARGET_BLOCKS = v
            else:
                nw_cuda.split_layout = lambda *a, v=v: v
            try:
                got = nw_cuda.scores_prepared(ak, al, op)
                assert torch.equal(got, want), (name, v)
                ms = time_ms(lambda: nw_cuda.scores_prepared(ak, al, op))
            finally:
                if packed:
                    nw_cuda.TARGET_BLOCKS = default
                else:
                    nw_cuda.split_layout = default
            chosen = (v == default) if packed else (v == default(
                longest, ak.shape[0] * op.live_rows * op.ns))
            print(f"{name}: {rule} = {v}: {ms:.3f} ms"
                  + (" (the wrapper's choice)" if chosen else ""), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
