"""The benchmark's workload generator: an assembly graph and long reads
sampled from it, all from one seed.

A frozen copy of the port's generator (`gfalign_torch/synth.py`:
`make_workload`, `write_truth_gaf`), rewritten on numpy and the standard
library so that nothing of the program under test shapes its own inputs.
With its default arguments it draws the same random numbers in the same
order as that generator, so both make the same graph and the same reads
from one seed.  Two parameters are new: `tangle_seg_len`, the length range
of the tangle's segments (a collapsed repeat is longer than the unique
segments around it), and `filter_margin`, the backbone segments on each
side of the tangle that the filter window keeps.

  * a linear backbone of `n_segments` random segments named "1".."N",
    joined by 0M links;
  * one TANGLE: `tangle_k` consecutive backbone segments linked every one
    to every other in both directions (a directed K_k); the search node
    list grants its interior nodes a visit budget of `tangle_budget`;
  * heterozygous BUBBLES: every `bubble_every` backbone positions an
    allele "<i>b", a copy of the segment with `allele_div` substitutions,
    bridges the two neighbours;
  * READS: walks along the backbone that take either allele at each
    bubble, with substitutions, insertions and deletions at the given
    rates, emitted on a random strand, with their truth.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Every cell's graph and reads come from this one seed; a run's own seed
# only deals them out in another order, so every run does the same work.
DATA_SEED = 1

BASES = "ACGT"
_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
_BASE = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[_BASE] = np.arange(4, dtype=np.uint8)


def revcomp(seq: str) -> str:
    return seq.translate(_RC)[::-1]


@dataclass
class ReadTruth:
    name: str
    start_seg: str          # segment holding the read's first raw base
    start_off: int          # offset of that base in the forward segment
    walk: List[str]         # segment names visited, in walk order
    strand: str             # '+' as sampled, '-' emitted reverse-complemented
    raw_len: int            # bases of the walk the read covers, before errors


@dataclass
class Workload:
    names: List[str]                          # segment names, in GFA order
    seqs: Dict[str, str]                      # name -> forward sequence
    links: List[Tuple[str, str, str, str]]    # (name1, or1, name2, or2), 0M
    reads: List[Tuple[str, str]]
    truth: List[ReadTruth]
    tangle_nodes: List[str]
    source: str
    destination: str
    search_nodelist: List[str]                # "name\tcount" rows
    filter_nodelist: List[str]                # the filter window's names
    backbone: List[str] = field(default_factory=list)
    read_lens: List[int] = field(default_factory=list)


def _rand_seq(rng: random.Random, n: int) -> str:
    nrng = np.random.default_rng(rng.getrandbits(32))
    return (np.frombuffer(b"ACGT", np.uint8)[nrng.integers(0, 4, n)]
            .tobytes().decode())


def _apply_errors(rng: random.Random, raw: str, sub_rate: float,
                  ins_rate: float, del_rate: float) -> str:
    """Per base: roll < del drops it; < del + ins inserts a random base
    before it (and substitutes it); < del + ins + sub substitutes it."""
    if not raw:
        return raw
    nrng = np.random.default_rng(rng.getrandbits(32))
    idx = _CODE[np.frombuffer(raw.encode(), np.uint8)]
    n = len(idx)
    rolls = nrng.random(n)
    shift = nrng.integers(0, 3, n)
    d, di, dis = del_rate, del_rate + ins_rate, del_rate + ins_rate + sub_rate
    hit = np.flatnonzero(rolls < dis)
    kind = np.searchsorted(np.array([d, di]), rolls[hit], side="right")
    dels, inss = hit[kind == 0], hit[kind == 1]
    subs = hit[kind > 0]          # insert positions substitute as well
    idx[subs] = (idx[subs] + 1 + shift[subs]) % 4
    out = _BASE[idx]
    if inss.size:
        new = _BASE[nrng.integers(0, 4, inss.size)]
        out = np.insert(out, inss, new)
        # an inserted base lands before its base; later deletions shift by
        # the insertions before them
        dels = dels + np.searchsorted(inss, dels)
    if dels.size:
        out = np.delete(out, dels)
    return out.tobytes().decode()


def _error_len(rng: random.Random, n: int, ins_rate: float,
               del_rate: float) -> int:
    """The length `_apply_errors` gives a raw read of n bases, from the
    same draws, without making the read."""
    if not n:
        return 0
    rolls = np.random.default_rng(rng.getrandbits(32)).random(n)
    return n - int((rolls < del_rate).sum()) + int(
        ((rolls >= del_rate) & (rolls < del_rate + ins_rate)).sum())


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
                  tangle_read_frac: float = 0.0,
                  tangle_seg_len: Optional[Tuple[int, int]] = None,
                  allele_div: float = 0.02,
                  filter_margin: int = 12,
                  sequences: bool = True) -> Workload:
    """With `sequences` False the reads are not made, only their lengths
    (the same lengths, from the same draws); their sequences read ""."""
    rng = random.Random(seed)
    t0 = max(1, n_segments // 2 - tangle_k // 2)
    backbone = [str(i + 1) for i in range(n_segments)]
    seqs: Dict[str, str] = {}
    for i, name in enumerate(backbone):
        span = seg_len
        if tangle_seg_len is not None and t0 <= i < t0 + tangle_k:
            span = tangle_seg_len
        seqs[name] = _rand_seq(rng, rng.randint(*span))
    names = list(backbone)
    links = [(backbone[i], "+", backbone[i + 1], "+")
             for i in range(n_segments - 1)]

    tangle = backbone[t0:t0 + tangle_k]
    for i in range(len(tangle)):
        for j in range(len(tangle)):
            if i == j or j == i + 1:
                continue
            links.append((tangle[i], "+", tangle[j], "+"))

    bubble_at: Dict[int, str] = {}
    for i in range(2, n_segments - 2, bubble_every):
        if t0 - 2 <= i <= t0 + tangle_k + 1:
            continue
        alt = backbone[i] + "b"
        seqs[alt] = _mutate(rng, seqs[backbone[i]], allele_div)
        names.append(alt)
        links.append((backbone[i - 1], "+", alt, "+"))
        links.append((alt, "+", backbone[i + 1], "+"))
        bubble_at[i] = alt

    reads: List[Tuple[str, str]] = []
    truth: List[ReadTruth] = []
    read_lens: List[int] = []
    for r in range(n_reads):
        target = rng.randint(*read_len)
        if rng.random() < tangle_read_frac:
            start_i = rng.randrange(max(0, t0 - 2), t0 + tangle_k)
        else:
            start_i = rng.randrange(n_segments - 1)
        use_alt = start_i in bubble_at and rng.random() < 0.5
        start_seg = bubble_at[start_i] if use_alt else backbone[start_i]
        start_off = rng.randrange(max(1, len(seqs[start_seg]) - 1))
        parts = [seqs[start_seg][start_off:]]
        walk = [start_seg]
        i = start_i
        total = len(parts[0])
        while total < target and i + 1 < n_segments:
            i += 1
            use_alt = i in bubble_at and rng.random() < 0.5
            seg = bubble_at[i] if use_alt else backbone[i]
            parts.append(seqs[seg])
            total += len(seqs[seg])
            walk.append(seg)
        raw_len = min(target, total)
        if sequences:
            raw = "".join(parts)[:target]
            seq = _apply_errors(rng, raw, sub_rate, ins_rate, del_rate)
            qlen = len(seq)
        else:
            seq, qlen = "", _error_len(rng, raw_len, ins_rate, del_rate)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp(seq)
        name = f"r{r}"
        reads.append((name, seq))
        read_lens.append(qlen)
        truth.append(ReadTruth(name, start_seg, start_off, walk, strand, raw_len))

    interior = tangle[1:-1]
    lo = max(0, t0 - filter_margin)
    hi = min(n_segments, t0 + tangle_k + filter_margin)
    window = backbone[lo:hi]
    window += [bubble_at[i] for i in range(lo, hi) if i in bubble_at]
    return Workload(
        names=names, seqs=seqs, links=links, reads=reads, truth=truth,
        tangle_nodes=tangle, source=tangle[0], destination=tangle[-1],
        search_nodelist=[f"{n}\t{tangle_budget}" for n in interior],
        filter_nodelist=window, backbone=backbone, read_lens=read_lens)


def from_config(config: dict, seed: int, sequences: bool = True) -> Workload:
    """The workload of a configuration file's `graph` and `reads`."""
    g, r = config["graph"], config["reads"]
    return make_workload(
        seed=seed, n_segments=g["n_segments"], n_reads=r["n_reads"],
        seg_len=tuple(g["seg_len"]), read_len=tuple(r["read_len"]),
        bubble_every=g["bubble_every"], tangle_k=g["tangle_k"],
        tangle_budget=g["tangle_budget"], sub_rate=r["sub_rate"],
        ins_rate=r["ins_rate"], del_rate=r["del_rate"],
        tangle_seg_len=tuple(g["tangle_seg_len"]), allele_div=g["allele_div"],
        filter_margin=g["filter_margin"], sequences=sequences)


def write_gfa(wl: Workload, path: str) -> None:
    """GFA1: a header, one S line a segment (with its LN tag), one L line a
    link, in the workload's order."""
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.2\n")
        for name in wl.names:
            seq = wl.seqs[name]
            fh.write(f"S\t{name}\t{seq}\tLN:i:{len(seq)}\n")
        for n1, o1, n2, o2 in wl.links:
            fh.write(f"L\t{n1}\t{o1}\t{n2}\t{o2}\t0M\n")


def write_fastq(reads: Sequence[Tuple[str, str]], path: str) -> None:
    with open(path, "w") as fh:
        fh.write("".join(f"@{name}\n{seq}\n+\n{'~' * len(seq)}\n"
                         for name, seq in reads))


def truth_records(wl: Workload) -> List[Tuple[str, List[str], str]]:
    """(read name, walk, GAF line) of every read: the record the truth walk
    gives, as `write_truth_gaf` writes it."""
    out = []
    for (name, _), qlen, t in zip(wl.reads, wl.read_lens, wl.truth):
        plen = sum(len(wl.seqs[n]) for n in t.walk)
        pstart = t.start_off
        pend = min(plen, pstart + qlen)
        p = "".join(">" + n for n in t.walk)
        out.append((name, t.walk, f"{name}\t{qlen}\t0\t{qlen}\t+\t{p}\t{plen}\t"
                                  f"{pstart}\t{pend}\t{qlen}\t{qlen}\t60\n"))
    return out


def in_window(walk: Sequence[str], window: Sequence[str]) -> bool:
    """Whether every node of a record's path lies in the window (the filter
    mode's rule: a record is kept only when all of its nodes are listed)."""
    keep = set(window)
    return all(n in keep for n in walk)


def write_truth_gaf(wl: Workload, path: str,
                    window: Optional[Sequence[str]] = None,
                    order: Optional[Sequence[int]] = None) -> int:
    """The truth walks as GAF records (every read, or with `window` only
    those whose every node lies in it), in read order or in `order`;
    returns the records written."""
    recs = truth_records(wl)
    if order is not None:
        recs = [recs[k] for k in order]
    n = 0
    with open(path, "w") as fh:
        for _, walk, line in recs:
            if window is None or in_window(walk, window):
                fh.write(line)
                n += 1
    return n
