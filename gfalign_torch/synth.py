"""Synthetic-but-realistic assembly-graph workload generator.

Scale validation (BASELINE config 5) needs workloads far beyond the
reference's bundled toys (testFiles/random3.gfa is 5 segments / 4 GAF
records): real gfalign usage aligns HiFi reads to thousand-segment
assembly graphs and resolves multi-node tangles (reference README.md:33-55
workflow).  This module builds such an instance deterministically:

  * a linear backbone of `n_segments` random-sequence segments with 0M
    links (names "1".."N", like the fixtures);
  * heterozygous BUBBLES: every ~`bubble_every` backbone positions an
    alternate allele segment ("<i>b", a mutated copy) bridges the two
    neighbors, so sampled walks branch;
  * one TANGLE: `tangle_k` consecutive backbone segments fully cross-linked
    (K_k, like random3's K4), giving the search mode a real path-explosion
    region; the search nodelist grants interior tangle nodes a visit budget
    of `tangle_budget`;
  * HiFi-like READS: walks sampled from the graph (random allele at each
    bubble), with substitution/indel errors and random strand, plus their
    truth locations for validation.

All randomness flows from one seed; identical seeds reproduce the workload
byte-for-byte (tests and benchmarks share instances by seed).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .graph.model import Graph, Link

BASES = "ACGT"


@dataclass
class ReadTruth:
    name: str
    start_seg: str          # backbone/bubble segment name of the first base
    start_off: int          # offset within that (forward-oriented) segment
    walk: List[str]         # segment names visited, in walk order
    strand: str             # '+' = as sampled, '-' = emitted reverse-complement


@dataclass
class Workload:
    graph: Graph
    reads: List[Tuple[str, str]]
    truth: List[ReadTruth]
    tangle_nodes: List[str]          # backbone names inside the tangle
    source: str                      # search source (first tangle node)
    destination: str                 # search destination (last tangle node)
    search_nodelist: List[str]       # "name\tcount" rows (interior nodes)
    filter_nodelist: List[str]       # names for the filter mode
    true_path: str                   # backbone walk through the tangle "2+,3+,.."
    backbone: List[str] = field(default_factory=list)


def _rand_seq(rng: random.Random, n: int) -> str:
    # numpy fast path (seeded from the caller's rng so workloads stay
    # reproducible from `seed`); the per-char Python loop cost ~10 min
    # for the 100 Mb scale-proof graph
    import numpy as np

    nrng = np.random.default_rng(rng.getrandbits(32))
    return (np.frombuffer(b"ACGT", np.uint8)[nrng.integers(0, 4, n)]
            .tobytes().decode())


def _apply_errors(rng: random.Random, raw: str, sub_rate: float,
                  ins_rate: float, del_rate: float) -> str:
    """Vectorized read-error model (same per-char semantics as the old
    Python loop: roll < del -> drop; < del+ins -> insert a random base
    before the char; < del+ins+sub -> substitute; else keep).  Seeded from
    the caller's rng so workloads stay reproducible from `seed`; the
    per-char loop cost ~8 min for 100k x 5 kb scale-proof reads."""
    import numpy as np

    if not raw:
        return raw
    nrng = np.random.default_rng(rng.getrandbits(32))
    lut = np.zeros(256, np.uint8)
    for i, b in enumerate(BASES):
        lut[ord(b)] = i
    idx = lut[np.frombuffer(raw.encode(), np.uint8)]          # 0..3
    n = len(idx)
    rolls = nrng.random(n)
    d, di, dis = del_rate, del_rate + ins_rate, del_rate + ins_rate + sub_rate
    del_m = rolls < d
    ins_m = (~del_m) & (rolls < di)
    sub_m = (~del_m) & (rolls < dis)      # ins positions also substitute,
    # matching the original loop's fall-through
    base_b = np.frombuffer(b"ACGT", np.uint8)
    emit = np.where(sub_m, (idx + 1 + nrng.integers(0, 3, n)) % 4, idx)
    counts = np.where(del_m, 0, np.where(ins_m, 2, 1))
    ends = np.cumsum(counts)
    out = np.empty(int(ends[-1]), np.uint8)
    keep = counts > 0
    out[ends[keep] - 1] = base_b[emit[keep]]
    if ins_m.any():
        out[ends[ins_m] - 2] = base_b[nrng.integers(0, 4, int(ins_m.sum()))]
    return out.tobytes().decode()


def _mutate(rng: random.Random, seq: str, rate: float) -> str:
    out = []
    for ch in seq:
        if rng.random() < rate:
            out.append(rng.choice([b for b in BASES if b != ch]))
        else:
            out.append(ch)
    return "".join(out)


def make_workload(seed: int = 0,
                  n_segments: int = 1000,
                  n_reads: int = 10000,
                  seg_len: Tuple[int, int] = (300, 1200),
                  read_len: Tuple[int, int] = (2000, 8000),
                  bubble_every: int = 7,
                  tangle_k: int = 6,
                  tangle_budget: int = 2,
                  sub_rate: float = 0.002,
                  ins_rate: float = 0.0005,
                  del_rate: float = 0.0005,
                  tangle_read_frac: float = 0.0) -> Workload:
    rng = random.Random(seed)
    graph = Graph()

    backbone = [str(i + 1) for i in range(n_segments)]
    seqs: Dict[str, str] = {}
    for name in backbone:
        seqs[name] = _rand_seq(rng, rng.randint(*seg_len))
        graph.add_segment(name, seqs[name])
    for i in range(n_segments - 1):
        graph.links.append(Link(graph.name_to_id[backbone[i]], "+",
                                graph.name_to_id[backbone[i + 1]], "+", "0M"))

    # tangle: DIRECTED K_k (both directions) over consecutive backbone
    # segments centered mid-graph — revisits under the nodelist budget make
    # the path space combinatorial, like a real repeat tangle
    t0 = max(1, n_segments // 2 - tangle_k // 2)
    tangle = backbone[t0:t0 + tangle_k]
    for i in range(len(tangle)):
        for j in range(len(tangle)):
            if i == j or j == i + 1:
                continue  # self / backbone link already present
            graph.links.append(Link(graph.name_to_id[tangle[i]], "+",
                                    graph.name_to_id[tangle[j]], "+", "0M"))

    # bubbles: alternate allele b-segments outside the tangle
    bubble_at: Dict[int, str] = {}   # backbone index -> allele name
    for i in range(2, n_segments - 2, bubble_every):
        if t0 - 2 <= i <= t0 + tangle_k + 1:
            continue
        alt = backbone[i] + "b"
        seqs[alt] = _mutate(rng, seqs[backbone[i]], 0.02)
        graph.add_segment(alt, seqs[alt])
        graph.links.append(Link(graph.name_to_id[backbone[i - 1]], "+",
                                graph.name_to_id[alt], "+", "0M"))
        graph.links.append(Link(graph.name_to_id[alt], "+",
                                graph.name_to_id[backbone[i + 1]], "+", "0M"))
        bubble_at[i] = alt

    # reads: sample walks along the backbone, branching at bubbles
    reads: List[Tuple[str, str]] = []
    truth: List[ReadTruth] = []
    from .graph.stats import revcomp

    for r in range(n_reads):
        target = rng.randint(*read_len)
        if rng.random() < tangle_read_frac:
            # coverage concentrated on the tangle (deep-coverage repeat
            # region — the regime the search mode exists for)
            start_i = rng.randrange(max(0, t0 - 2), t0 + tangle_k)
        else:
            start_i = rng.randrange(n_segments - 1)
        use_alt = start_i in bubble_at and rng.random() < 0.5
        start_seg = bubble_at[start_i] if use_alt else backbone[start_i]
        start_off = rng.randrange(max(1, len(seqs[start_seg]) - 1))
        parts = [seqs[start_seg][start_off:]]
        walk = [start_seg]
        i = start_i
        while sum(map(len, parts)) < target and i + 1 < n_segments:
            i += 1
            use_alt = i in bubble_at and rng.random() < 0.5
            seg = bubble_at[i] if use_alt else backbone[i]
            parts.append(seqs[seg])
            walk.append(seg)
        raw = "".join(parts)[:target]
        seq = _apply_errors(rng, raw, sub_rate, ins_rate, del_rate)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp(seq)
        name = f"r{r}"
        reads.append((name, seq))
        truth.append(ReadTruth(name, start_seg, start_off, walk, strand))

    interior = tangle[1:-1]
    # filter window: the tangle plus margin (reference filter keeps only
    # records whose EVERY path node is listed, src/alignments.cpp:459-472,
    # so a realistic tangle nodelist spans the reads around it)
    lo = max(0, t0 - 12)
    hi = min(n_segments, t0 + tangle_k + 12)
    window = backbone[lo:hi]
    window += [bubble_at[i] for i in range(lo, hi) if i in bubble_at]
    return Workload(
        graph=graph,
        reads=reads,
        truth=truth,
        tangle_nodes=tangle,
        source=tangle[0],
        destination=tangle[-1],
        search_nodelist=[f"{n}\t{tangle_budget}" for n in interior],
        filter_nodelist=window,
        true_path=",".join(n + "+" for n in tangle),
        backbone=backbone,
    )


def write_truth_gaf(wl: Workload, path: str) -> None:
    """GAF records synthesized directly from the sampled truth walks
    (bypasses the aligner — for benchmarks of the downstream stages whose
    inputs just need to be well-formed alignments)."""
    segs = wl.graph.segments
    name_to_id = wl.graph.name_to_id
    with open(path, "w") as fh:
        for (name, seq), t in zip(wl.reads, wl.truth):
            qlen = len(seq)
            plen = sum(segs[name_to_id[n]].length for n in t.walk)
            pstart = t.start_off
            pend = min(plen, pstart + qlen)
            p = "".join(">" + n for n in t.walk)
            fh.write(f"{name}\t{qlen}\t0\t{qlen}\t+\t{p}\t{plen}\t{pstart}"
                     f"\t{pend}\t{qlen}\t{qlen}\t60\n")


def write_workload(wl: Workload, out_dir: str) -> Dict[str, str]:
    """Write graph.gfa, reads.fq, search_nodelist.tsv, filter_nodelist.ls;
    returns the path of each."""
    import pathlib

    from .io.writers import write_gfa1

    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "gfa": str(d / "graph.gfa"),
        "reads": str(d / "reads.fq"),
        "search_nodelist": str(d / "search_nodelist.tsv"),
        "filter_nodelist": str(d / "filter_nodelist.ls"),
    }
    with open(paths["gfa"], "w") as fh:
        write_gfa1(wl.graph, fh.write)
    with open(paths["reads"], "w") as fh:
        for name, seq in wl.reads:
            fh.write(f"@{name}\n{seq}\n+\n{'~' * len(seq)}\n")
    with open(paths["search_nodelist"], "w") as fh:
        fh.write("".join(row + "\n" for row in wl.search_nodelist))
    with open(paths["filter_nodelist"], "w") as fh:
        fh.write("".join(n + "\n" for n in wl.filter_nodelist))
    return paths
