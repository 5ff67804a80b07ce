"""align mode entry point: in-house sequence-to-graph aligner producing GAF.

The reference outsources this to GraphAligner via std::system
(src/main.cpp:167-169); here it is the framework's flagship component.
The full pipeline lives in engine/graph_align.py (seed on host via
engine/seeding.py, batch-extend on the device with the banded seqalign
kernels in ops/seqalign*.py, emit GraphAligner-compatible GAF records);
this module is the CLI-facing dispatch kept separate so `gfalign align`
imports stay lazy.
"""

from __future__ import annotations


def align_mode(graph, read_files, out_file: str, preset: str = "hifi",
               overrides=None, echo: bool = False, out=None,
               shard=None, device="cuda") -> None:
    from .graph_align import run_graph_aligner
    run_graph_aligner(graph, read_files, out_file, preset,
                      overrides=overrides, echo=echo, out=out, shard=shard,
                      device=device)
