"""The yardstick of the kernel rooflines: the card's published peaks and
the work each kernel's call needs, counted from the arguments of the call
into the kernel layer (not from how a kernel does it), so that a new
kernel does not move its own yardstick.

Peaks (one NVIDIA H100 SXM5 at its 700 W limit): 132 SMs x 64 INT32 lanes
x the 1,980 MHz boost clock of the Hopper white paper = 16.73 T int32
operations/s; HBM3 at 3.35 TB/s.

Both kernels run a dynamic-programming recurrence with one int32 value a
cell.  A cell of either costs OPS_PER_CELL operations as the recurrences
are written (gfalign's local alignment, reference/align.py; its path
alignment, reference/search.py): a compare and a select for the
substitution score, three adds (diagonal + score, up + gap, left + gap)
and three maxima (over the three and, for the local one, against 0; for
the path alignment, the free last-column gap's select in its place).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 8
PAD_CODE = 5         # the port's read padding code in its K3 read pool


def least_time(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def banded_work(read_rows: np.ndarray, width: int) -> Dict[str, float]:
    """K3's work for pairs whose reads have `read_rows` live rows each, in
    a band of `width` lanes: read length x band cells a pair; the read's
    bytes and its strip of path (read length + width) read once, the four
    int32 results and the three int32 inputs (read, path, diagonal) once."""
    rows = np.asarray(read_rows, np.float64)
    cells = float((rows * width).sum())
    nbytes = float((rows + rows + width).sum() + rows.size * (4 * 4 + 3 * 4))
    return {"cells": cells, "ops": cells * OPS_PER_CELL, "bytes": nbytes}


def live_rows(reads, read_idx) -> np.ndarray:
    """Rows up to each pair's read's last non-padding code: `reads` holds
    the pool's rows (arrays of read codes), `read_idx` each pair's row."""
    idx = np.asarray(read_idx, np.int64).ravel()
    last = {}
    for r in np.unique(idx).tolist():
        row = np.asarray(reads[r]) if 0 <= r < len(reads) else np.empty(0)
        nz = np.flatnonzero(row != PAD_CODE)
        last[r] = int(nz[-1]) + 1 if nz.size else 0
    return np.array([last[r] for r in idx.tolist()], np.int64)


def path_work(cand_lens: np.ndarray, read_lens: np.ndarray) -> Dict[str, float]:
    """K1's work for a frontier: the useful cells, candidate length x read
    path length over every pair, twice (forward and reverse-complement);
    the keys of both sides read once and a score written a pair and
    orientation."""
    n = np.asarray(cand_lens, np.float64)
    m = np.asarray(read_lens, np.float64)
    cells = 2.0 * float(n.sum()) * float(m.sum())
    pairs = 2.0 * n.size * m.size
    nbytes = 4.0 * (n.sum() + 2.0 * m.sum()) + 4.0 * pairs
    return {"cells": cells, "ops": cells * OPS_PER_CELL, "bytes": float(nbytes)}


def share(work: Dict[str, float], kernel_s: float):
    """A kernel's share of its roofline in %, or None with nothing to read."""
    if not work or kernel_s <= 0 or work.get("cells", 0) <= 0:
        return None
    return 100.0 * least_time(work["ops"], work["bytes"]) / kernel_s
