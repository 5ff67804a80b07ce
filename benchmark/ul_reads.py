"""Ultra-long reads of set lengths on the benchmark's graph: the reads of a
configuration whose `reads` give a length law and a number of quantiles
(configs/ont_r10.json) instead of a uniform range.

The graph is `workload.make_workload`'s (with no reads), from the data
seed.  The reads are drawn with its steps, from a second generator seeded
by the data seed: a start segment on the backbone, either allele at each
bubble, the walk along the backbone to the read's raw length, errors by
`workload._apply_errors`, a random strand.  Their raw lengths are the
(k + 0.5) / n quantiles of a log-normal law of the given median and
sigma, in the generator's order; a start from which the backbone ends
before the read's length is drawn again, so that every read has its
length.  numpy and the standard library only: nothing of the program
shapes its own inputs.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist
from typing import List

from . import workload

READ_SEED_TAG = 0x0171  # the reads' generator: (data seed, this tag)


def quantile_lengths(median: float, sigma: float, n: int) -> List[int]:
    """Raw read lengths at the (k + 0.5) / n quantiles of a log-normal law."""
    z = NormalDist()
    return [int(round(median * math.exp(sigma * z.inv_cdf((k + 0.5) / n))))
            for k in range(n)]


def make(config: dict, seed: int) -> workload.Workload:
    """The workload of a configuration with quantile reads: the graph of
    its `graph` keys and its reads' `quantiles` reads at its error rates,
    from `seed` (the data seed)."""
    g, r = config["graph"], config["reads"]
    wl = workload.make_workload(
        seed=seed, n_segments=g["n_segments"], n_reads=0,
        seg_len=tuple(g["seg_len"]), bubble_every=g["bubble_every"],
        tangle_k=g["tangle_k"], tangle_budget=g["tangle_budget"],
        tangle_seg_len=tuple(g["tangle_seg_len"]), allele_div=g["allele_div"],
        filter_margin=g["filter_margin"])
    backbone = wl.backbone
    n_seg = len(backbone)
    index = {name: i for i, name in enumerate(backbone)}
    bubble_at = {index[name[:-1]]: name for name in wl.names if name.endswith("b")}
    # bases of the backbone from segment i to its end
    tail = [0] * (n_seg + 1)
    for i in range(n_seg - 1, -1, -1):
        tail[i] = tail[i + 1] + len(wl.seqs[backbone[i]])
    rng = random.Random(seed * 65536 + READ_SEED_TAG)
    lengths = quantile_lengths(r["median_len"], r["sigma"], r["quantiles"])
    for n, target in enumerate(lengths):
        while True:
            start_i = rng.randrange(n_seg - 1)
            if tail[start_i + 1] >= target:
                break
        use_alt = start_i in bubble_at and rng.random() < 0.5
        start_seg = bubble_at[start_i] if use_alt else backbone[start_i]
        start_off = rng.randrange(max(1, len(wl.seqs[start_seg]) - 1))
        parts = [wl.seqs[start_seg][start_off:]]
        walk = [start_seg]
        i, total = start_i, len(parts[0])
        while total < target and i + 1 < n_seg:
            i += 1
            use_alt = i in bubble_at and rng.random() < 0.5
            seg = bubble_at[i] if use_alt else backbone[i]
            parts.append(wl.seqs[seg])
            total += len(wl.seqs[seg])
            walk.append(seg)
        raw = "".join(parts)[:target]
        seq = workload._apply_errors(rng, raw, r["sub_rate"], r["ins_rate"],
                                     r["del_rate"])
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = workload.revcomp(seq)
        name = f"ul{n}"
        wl.reads.append((name, seq))
        wl.read_lens.append(len(seq))
        wl.truth.append(workload.ReadTruth(name, start_seg, start_off, walk,
                                           strand, len(raw)))
    return wl
