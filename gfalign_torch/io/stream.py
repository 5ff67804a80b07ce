"""Input/output stream abstraction.

Mirrors gfalibs StreamObj/OutputStream behavior as observed through the
reference's goldens:

  * inputs may be plain files, gzip files, or '-' (stdin pipe);
  * `-o <token>`: if <token> is a known *sequence* extension the stream is
    stdout; otherwise <token> is a literal file path.  Crucially 'gaf' is NOT
    in gfalibs' known-extension set, so `filter -o gaf` writes a literal file
    named 'gaf' while the summary stats go to stdout — that is exactly what
    validateFiles/test.7.tst + the stray 3-record 'gaf' file at the reference
    repo root record.
  * constructing an OutputStream flips std::cout into fixed-2-decimal mode
    (observable in test.7's '18.67'/'100.00%' vs test.0's '37.5'/'100%').
"""

from __future__ import annotations

import gzip
import io
import sys
from typing import IO, Iterator

from ..utils.fmt import cout

# Extensions gfalibs' OutputStream recognizes as "write this format to
# stdout".  'gaf' is deliberately absent (see module docstring).
STDOUT_EXTS = {
    "fasta", "fa", "fsa", "fastq", "fq", "gfa", "gfa2", "bed", "agp", "sak", "vcf",
    "fasta.gz", "fa.gz", "fsa.gz", "fastq.gz", "fq.gz", "gfa.gz", "gfa2.gz",
}


def open_input(path: str) -> IO[str]:
    """Open a text input: file, .gz file, or '-' for stdin."""
    if path == "-":
        return sys.stdin
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_lines(path: str) -> Iterator[str]:
    stream = open_input(path)
    try:
        for line in stream:
            yield line.rstrip("\n")
    finally:
        if stream is not sys.stdin:
            stream.close()


class OutputStream:
    def __init__(self, file: str) -> None:
        self.file = file
        self.out_file = file not in STDOUT_EXTS  # True => real file on disk
        cout.set_fixed2()
        if self.out_file:
            self.stream: IO[str] = open(file, "w")
            ext = file.rsplit(".", 1)[-1] if "." in file else file
            self.ext = ext
        else:
            self.stream = sys.stdout
            self.ext = file

    def write(self, text: str) -> None:
        self.stream.write(text)

    def close(self) -> None:
        if self.out_file:
            self.stream.close()
