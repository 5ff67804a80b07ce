"""FASTQ/FASTA reader -> read batches.

Host-side input stage for the align mode.  Reads are returned as
(name, sequence) plus 2-bit packed numpy arrays for device kernels
(A=0, C=1, G=2, T=3; other characters map to 4 and never match).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from .stream import iter_lines

_BASE_CODE = np.full(256, 4, dtype=np.int8)
for i, base in enumerate("ACGT"):
    _BASE_CODE[ord(base)] = i
    _BASE_CODE[ord(base.lower())] = i


def encode_seq(seq: str) -> np.ndarray:
    return _BASE_CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def iter_reads(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence); auto-detects FASTQ vs FASTA."""
    lines = iter_lines(path)
    pending_name = None
    fasta_seq: List[str] = []
    for line in lines:
        if not line:
            continue
        if line.startswith("@") and pending_name is None:
            # FASTQ record: @name / seq / + / qual
            name = line[1:]  # full header, spaces included (GAF qName keeps them)
            try:
                seq = next(lines)
                next(lines)  # '+'
                next(lines)  # qualities
            except StopIteration:
                break
            yield name, seq
        elif line.startswith(">"):
            if pending_name is not None:
                yield pending_name, "".join(fasta_seq)
            pending_name = line[1:]
            fasta_seq = []
        elif pending_name is not None:
            fasta_seq.append(line)
    if pending_name is not None:
        yield pending_name, "".join(fasta_seq)


def load_reads(paths) -> List[Tuple[str, str]]:
    """Reads of FASTA/FASTQ files in order.  A plain file takes the native
    threaded parser (io/native.parse_fastx); gzipped files and stdin take
    the line parser above, which is also the oracle when
    `native.available()` is false."""
    import os

    from . import native

    reads: List[Tuple[str, str]] = []
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        if p != "-" and os.path.isfile(p) and native.available():
            with open(p, "rb") as probe:
                gz = probe.read(2) == b"\x1f\x8b"
            if not gz:
                parsed = native.parse_fastx(p)
                if parsed is not None:
                    reads.extend(parsed)
                    continue
        reads.extend(iter_reads(p))
    return reads
