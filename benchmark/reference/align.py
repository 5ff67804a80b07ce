"""Plain reference for gfalign's `align` mode, on numpy and the standard
library alone.

The program aligns long reads to an assembly graph and writes one GAF
record a placement: read name and length, the query interval, strand
'+', the graph path ('>' forward, '<' reverse steps), its length, the
interval on it, residue matches, block length, mapping quality and the
tags NM (edits), AS (block length - 2.94 x NM), dv (NM / block length),
id (matches / block length) and cg (the CIGAR, in =, X, I and D).  The
alignment is local, scored +1 a match, -2 a mismatch and -3 a gap base.

This module judges records by what they say, against sequences the
benchmark made itself:

  * `check_record`: every field is consistent with the read, the graph
    and the CIGAR, and the CIGAR's matches and mismatches are the bases'
    own;
  * `corridor_best`: the best local alignment score of a read against a
    path sequence, inside a band of diagonals, in int32 (or, for the
    control, in saturating int8 arithmetic), batched over pairs; with the
    band of a banded scorer's lanes it is that scorer's plain reference
    (`banded_check`);
  * `corridor_align`: the same for one pair, with its traceback, which
    makes a record: the reference aligner that the control puts in the
    program's place.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

MATCH, MISMATCH, GAP = 1, -2, -3
_CODE = np.full(256, 4, np.uint8)
for _k, _b in enumerate(b"ACGT"):
    _CODE[_b] = _k
_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
_OP_RE = re.compile(r"(\d+)([=XID])")
_STEP_RE = re.compile(r"([><])([^><]+)")


def codes(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def revcomp(seq: str) -> str:
    return seq.translate(_RC)[::-1]


def parse_path(path: str) -> List[Tuple[str, str]]:
    steps = [(name, "+" if arrow == ">" else "-")
             for arrow, name in _STEP_RE.findall(path)]
    if "".join(("<" if o == "-" else ">") + n for n, o in steps) != path:
        raise ValueError(f"not a GAF path: {path[:80]}")
    return steps


def path_seq(steps: Sequence[Tuple[str, str]], seqs: Dict[str, str]) -> str:
    """The oriented steps' sequence (the graph's links all overlap 0)."""
    return "".join(seqs[n] if o == "+" else revcomp(seqs[n]) for n, o in steps)


def link_set(links) -> set:
    """Every traversable (name1, or1, name2, or2), each link both ways."""
    flip = {"+": "-", "-": "+"}
    out = set()
    for n1, o1, n2, o2 in links:
        out.add((n1, o1, n2, o2))
        out.add((n2, flip[o2], n1, flip[o1]))
    return out


def _g(x: float) -> str:
    return f"{x:g}"


def cigar_score(ops: Sequence[Tuple[int, str]]) -> int:
    w = {"=": MATCH, "X": MISMATCH, "I": GAP, "D": GAP}
    return sum(n * w[op] for n, op in ops)


def check_record(line: str, read: Tuple[str, str], seqs: Dict[str, str],
                 links: set, min_score: int) -> Tuple[List[str], int, dict]:
    """(faults, score, record) of one GAF line for `read` (name, sequence).
    The faults name each field that disagrees with what the line says
    elsewhere or with the sequences; the score is the CIGAR's."""
    f = line.rstrip("\n").split("\t")
    faults: List[str] = []
    if len(f) != 17:
        return [f"{len(f)} columns"], 0, {}
    name, qlen, qs, qe, strand, path, plen, ps, pe, matches, block, mapq = f[:12]
    tags = dict(t.split(":", 2)[0::2] for t in f[12:])
    try:
        qlen, qs, qe, plen, ps, pe, matches, block, mapq = map(
            int, (qlen, qs, qe, plen, ps, pe, matches, block, mapq))
        nm = int(tags["NM"])
        cg = tags["cg"]
        steps = parse_path(path)
        seq = path_seq(steps, seqs)
    except (KeyError, ValueError) as exc:
        return [f"unreadable: {exc}"], 0, {}
    rec = dict(name=name, qs=qs, qe=qe, steps=steps, ps=ps, pe=pe, seq=seq)
    if name != read[0] or qlen != len(read[1]):
        faults.append("read")
    if strand != "+":
        faults.append("strand")
    if not 0 <= qs < qe <= qlen:
        faults.append("query interval")
    if any((a, oa, b, ob) not in links
           for (a, oa), (b, ob) in zip(steps, steps[1:])):
        faults.append("path not in graph")
    if plen != len(seq):
        faults.append("path length")
    if not 0 <= ps < pe <= plen:
        faults.append("path interval")
    elif ps >= len(seqs[steps[0][0]]) or pe <= plen - len(seqs[steps[-1][0]]):
        faults.append("path not minimal")
    ops = [(int(n), op) for n, op in _OP_RE.findall(cg)]
    if "".join(f"{n}{op}" for n, op in ops) != cg or not ops:
        return faults + ["cigar"], 0, rec
    n_of = np.array([n for n, _ in ops], np.int64)
    kind = np.array(["=XID".index(op) for _, op in ops], np.int8)
    eat_q = np.where(kind <= 2, n_of, 0)
    eat_p = np.where((kind <= 1) | (kind == 3), n_of, 0)
    if eat_q.sum() != qe - qs or eat_p.sum() != pe - ps:
        return faults + ["cigar span"], 0, rec
    # every aligned base pair, and whether the CIGAR calls it a match
    per_base = np.repeat(kind, n_of)
    q_pos = qs + np.cumsum(np.repeat(eat_q > 0, n_of)) - 1
    p_pos = ps + np.cumsum(np.repeat(eat_p > 0, n_of)) - 1
    paired = per_base <= 1
    rq = codes(read[1])[q_pos[paired]]
    pq = codes(seq)[p_pos[paired]]
    same = (rq == pq) & (rq < 4)
    if not np.array_equal(same, per_base[paired] == 0):
        faults.append("cigar bases")
    n_eq = int(n_of[kind == 0].sum())
    n_edit = int(n_of[kind > 0].sum())
    if matches != n_eq:
        faults.append("matches")
    if nm != n_edit:
        faults.append("NM")
    if block != int(n_of.sum()):
        faults.append("block length")
    if not 0 <= mapq <= 60:
        faults.append("mapq")
    if (tags.get("AS") != _g(block - 2.94 * nm)
            or tags.get("dv") != _g(nm / block if block else 0.0)
            or tags.get("id") != _g(matches / block if block else 0.0)):
        faults.append("tags")
    score = cigar_score(ops)
    if score < min_score:
        faults.append("score below the preset's minimum")
    return faults, score, rec


def _pad(arrays: Sequence[np.ndarray], fill: int) -> np.ndarray:
    out = np.full((len(arrays), max(len(a) for a in arrays)), fill, np.uint8)
    for k, a in enumerate(arrays):
        out[k, :len(a)] = a
    return out


def corridor_best(reads: Sequence[np.ndarray], paths: Sequence[np.ndarray],
                  dlo: Sequence[int], dhi: Sequence[int],
                  int8: bool = False, keep: bool = False, probe=None):
    """Best local alignment score of each read against its path over the
    cells (i, j) with dlo <= j - i <= dhi (1-based i in the read, j in the
    path), rows in lockstep over the pairs.  Returns (best, end_i, end_u)
    arrays, and with `keep` also the rows of H (n_rows, S, width) as int8
    (int8 mode only).  int8 saturates every cell at 127, as 8-bit lanes
    without an overflow fallback would.  With `probe`, (i, u) arrays of
    one cell a pair (row i, lane u = j - i - dlo), an array of H at each
    of those cells is appended (-1 where the cell lies outside the band)."""
    S = len(reads)
    dlo = np.asarray(dlo, np.int64)
    width = int((np.asarray(dhi, np.int64) - dlo).max()) + 1
    n_rows = max(len(r) for r in reads)
    R = _pad(reads, 5)
    margin = width + 1
    P = np.full((S, max(len(p) for p in paths) + 2 * margin), 6, np.uint8)
    for k, p in enumerate(paths):
        P[k, margin:margin + len(p)] = p
    plen = np.array([len(p) for p in paths], np.int64)[:, None]
    qlen = np.array([len(r) for r in reads], np.int64)
    u = np.arange(width, dtype=np.int64)[None, :]
    width_ok = u <= (np.asarray(dhi, np.int64) - dlo)[:, None]
    up_pad = np.full((S, 1), -(1 << 20), np.int64)
    ramp = -GAP * np.arange(width, dtype=np.int64)[None, :]
    H = np.zeros((S, width), np.int64)
    best = np.zeros(S, np.int64)
    end_i = np.zeros(S, np.int64)
    end_u = np.zeros(S, np.int64)
    rows = np.zeros((n_rows, S, width), np.int8) if keep else None
    cap = 127 if int8 else None
    base_j = dlo[:, None] + u                  # j - i for each lane
    rowsel = np.arange(S)[:, None]
    if probe is not None:
        p_i = np.asarray(probe[0], np.int64)
        p_u = np.asarray(probe[1], np.int64)
        p_ok = (p_u >= 0) & (p_u < width)
        at = np.full(S, -1, np.int64)
    for i in range(1, n_rows + 1):
        j = base_j + i                          # 1-based path column
        live = (j >= 1) & (j <= plen) & width_ok & (i <= qlen)[:, None]
        pc = P[rowsel, np.clip(j - 1 + margin, 0, P.shape[1] - 1)]
        rc = R[:, i - 1:i] if i <= R.shape[1] else np.full((S, 1), 5, np.uint8)
        s = np.where((pc == rc) & (rc < 4), MATCH, MISMATCH)
        up = np.concatenate([H[:, 1:], up_pad], axis=1)
        c = np.maximum(np.maximum(H + s, up + GAP), 0)
        if cap is not None:
            c = np.minimum(c, cap)
        c = np.where(live, c, 0)
        H = np.maximum.accumulate(c + ramp, axis=1) - ramp
        if cap is not None:
            H = np.minimum(H, cap)
        H = np.where(live, H, 0)
        if keep:
            rows[i - 1] = H
        if probe is not None:
            hit = np.flatnonzero(p_ok & (p_i == i))
            if hit.size:
                at[hit] = H[hit, p_u[hit]]
        row_best = H.max(axis=1)
        better = row_best > best
        if better.any():
            best = np.where(better, row_best, best)
            end_i = np.where(better, i, end_i)
            end_u = np.where(better, H.argmax(axis=1), end_u)
    if keep:
        return best, end_i, end_u, rows
    if probe is not None:
        return best, end_i, end_u, at
    return best, end_i, end_u


def corridor_align(read: np.ndarray, path: np.ndarray, dlo: int, dhi: int,
                   int8: bool = False):
    """(score, qs, qe, ps, pe, CIGAR ops) of the best local alignment of
    one read against one path inside the corridor, traced back from the
    first cell that reaches the best score."""
    best, end_i, end_u, rows = corridor_best([read], [path], [dlo], [dhi],
                                             int8=int8, keep=True)
    i, uu = int(end_i[0]), int(end_u[0])
    ops: List[str] = []
    H = rows[:, 0, :].astype(np.int64)
    width = H.shape[1]

    def at(ii: int, u: int) -> int:
        if ii == 0 or u < 0 or u >= width:
            return 0
        return int(H[ii - 1, u])

    qe, pe = i, i + dlo + uu
    while i > 0 and at(i, uu) > 0:
        j = i + dlo + uu
        v = at(i, uu)
        s = MATCH if (read[i - 1] == path[j - 1] and read[i - 1] < 4) else MISMATCH
        if v == at(i - 1, uu) + s and (at(i - 1, uu) > 0 or v == s):
            ops.append("=" if s == MATCH else "X")
            i -= 1
        elif v == at(i - 1, uu + 1) + GAP:
            ops.append("I")
            i, uu = i - 1, uu + 1
        elif v == at(i, uu - 1) + GAP:
            ops.append("D")
            uu -= 1
        else:
            break
    qs, ps = i, i + dlo + uu
    runs: List[Tuple[int, str]] = []
    for op in reversed(ops):
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return int(best[0]), qs, qe, ps, pe, runs


def trim(steps: Sequence[Tuple[str, str]], seqs: Dict[str, str],
         ps: int, pe: int) -> Tuple[List[Tuple[str, str]], int, int, int]:
    """The steps whose bases [ps, pe) touches, with the interval on them."""
    off, keep, base = 0, [], None
    for n, o in steps:
        ln = len(seqs[n])
        if off + ln > ps and off < pe:
            if base is None:
                base = off
            keep.append((n, o))
        off += ln
    plen = sum(len(seqs[n]) for n, _ in keep)
    return keep, plen, ps - base, pe - base


def record_line(name: str, qlen: int, steps, seqs, qs: int, qe: int,
                ps: int, pe: int, runs) -> str:
    """A GAF line for an alignment against `steps`, trimmed to the steps
    it touches, in the program's format."""
    sub, plen, ps, pe = trim(steps, seqs, ps, pe)
    n_eq = sum(n for n, op in runs if op == "=")
    nm = sum(n for n, op in runs if op != "=")
    block = sum(n for n, _ in runs)
    path = "".join((">" if o == "+" else "<") + n for n, o in sub)
    cg = "".join(f"{n}{op}" for n, op in runs)
    return "\t".join([name, str(qlen), str(qs), str(qe), "+", path, str(plen),
                      str(ps), str(pe), str(n_eq), str(block), "60",
                      f"NM:i:{nm}", f"AS:f:{_g(block - 2.94 * nm)}",
                      f"dv:f:{_g(nm / block)}", f"id:f:{_g(n_eq / block)}",
                      f"cg:Z:{cg}"])


def truth_steps(walk: Sequence[str], strand: str) -> List[Tuple[str, str]]:
    """The truth walk as the read lies on it: forward, or reversed with
    every step reverse-complemented for a read emitted on '-'."""
    if strand == "+":
        return [(n, "+") for n in walk]
    return [(n, "-") for n in reversed(walk)]


def truth_corridor(qlen: int, walk_len: int, start_off: int, raw_len: int,
                   strand: str, margin: int) -> Tuple[int, int]:
    """Diagonals (j - i) that the read's true alignment on its walk keeps
    within, widened by `margin`: the read's first base sits at path
    position p0 and its last near p0 + raw_len, so the diagonal runs from
    p0 to p0 + raw_len - qlen."""
    p0 = start_off if strand == "+" else walk_len - start_off - raw_len
    d0, d1 = p0, p0 + raw_len - qlen
    return min(d0, d1) - margin, max(d0, d1) + margin


def record_corridor(runs: Sequence[Tuple[int, str]], qs: int, ps: int,
                    margin: int) -> Tuple[int, int]:
    """Diagonals (j - i) that a record's own alignment visits, widened by
    `margin`."""
    d = ps - qs
    lo = hi = d
    for n, op in runs:
        if op == "I":
            d -= n
        elif op == "D":
            d += n
        lo, hi = min(lo, d), max(hi, d)
    return lo - margin, hi + margin


def ops_of(cg: str) -> List[Tuple[int, str]]:
    return [(int(n), op) for n, op in _OP_RE.findall(cg)]


def first_records(lines: Sequence[str]) -> Dict[str, List[str]]:
    """GAF lines grouped by read name, in file order."""
    out: Dict[str, List[str]] = {}
    for ln in lines:
        out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def band_of(delta: int, width: int) -> Tuple[int, int]:
    """Diagonals (j - i) of a banded scorer's `width` lanes centred on the
    anchor diagonal `delta`: lane u is diagonal delta - width // 2 + u."""
    lo = delta - width // 2
    return lo, lo + width - 1


def banded_check(reads: Sequence[np.ndarray], paths: Sequence[np.ndarray],
                 deltas: Sequence[int], width: int, got, block: int = 16,
                 int8: bool = False) -> np.ndarray:
    """Faults of a banded scorer's answers for pairs at one `width`: got
    is (best, end_i, end_j, edge) arrays, the scorer's best local score of
    each read against its path inside the band around its delta, the
    1-based cell where it ends and whether that cell is on a band-edge
    lane.  A pair is at fault when its best differs from the reference's,
    when a positive best's end cell is not a cell of the band where the
    reference's H reaches that best (any such cell: scorers break ties
    differently), or when the edge flag disagrees with the end cell's
    lane.  With `int8`, the reference itself in saturating int8 stands in
    for the scorer (the control).  Returns a bool array, one a pair."""
    n = len(reads)
    lo = np.array([band_of(int(d), width)[0] for d in deltas], np.int64)
    hi = lo + width - 1
    best_g, ei_g, ej_g, edge_g = (np.asarray(x, np.int64) for x in got)
    if int8:
        best_g = np.zeros(n, np.int64)
        ei_g = np.zeros(n, np.int64)
        ej_g = np.zeros(n, np.int64)
        for b0 in range(0, n, block):
            sl = slice(b0, b0 + block)
            b, i, u = corridor_best(reads[sl], paths[sl], lo[sl], hi[sl], int8=True)
            best_g[sl], ei_g[sl], ej_g[sl] = b, i, i + lo[sl] + u
        lane = ej_g - ei_g - lo
        edge_g = (best_g > 0) & ((lane <= 0) | (lane >= width - 1))
    lane = ej_g - ei_g - lo
    best = np.zeros(n, np.int64)
    at = np.zeros(n, np.int64)
    for b0 in range(0, n, block):
        sl = slice(b0, b0 + block)
        b, _, _, h = corridor_best(reads[sl], paths[sl], lo[sl], hi[sl],
                                   probe=(ei_g[sl], lane[sl]))
        best[sl], at[sl] = b, h
    plen = np.array([len(p) for p in paths], np.int64)
    qlen = np.array([len(r) for r in reads], np.int64)
    placed = best_g > 0
    cell_ok = ((ei_g >= 1) & (ei_g <= qlen) & (ej_g >= 1) & (ej_g <= plen)
               & (lane >= 0) & (lane < width) & (at == best))
    edge_want = placed & ((lane <= 0) | (lane >= width - 1))
    return ((best_g != best) | (placed & ~cell_ok)
            | (edge_g.astype(bool) != edge_want))
