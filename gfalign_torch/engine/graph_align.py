"""In-house sequence-to-graph aligner (the align mode).

The reference shells out to GraphAligner (src/main.cpp:167-169); this engine
is the framework's own pipeline with GraphAligner-compatible GAF output
(column contract + NM/AS/dv/id/cg tags).  PyTorch port of
gfalign_tpu/engine/graph_align.py: scoring runs on `device` (the CUDA
kernels of ops/seqalign_cuda.py, or their plain versions on the CPU).
The seeded engine has two scoring ladders and the device picks one
(`align_engine`): on CUDA the device ladder (K3, K4), on the CPU the
native host ladder of the JAX package's default engine.

This module is the align mode (presets, `align_reads`, the exhaustive
engine, GAF output); engine/seeded.py is the seeded engine, engine/paths.py
what both build on (oriented paths, GAF hits, the accept step).

Pipeline:
  1. enumerate oriented simple paths through the graph (both orientations;
     maximal per start state), building merged path sequences with edge
     overlaps dropped from the incoming segment (pLen of '>11<12>13' with
     6M/5M overlaps = 180-11 = 169, matching random2.gaf);
  2. score every (read x path-sequence) pair on device with the batched
     local-alignment kernel (ops/seqalign.py);
  3. select placements per read greedily by score over disjoint query
     regions (supplementary split, e.g. random1's rd1 -> ctg2 + ctg1);
  4. traceback only selected placements, in waves of one walk a read (on
     CUDA a wave's banded walks are one kernel launch), trim the path to
     the minimal covering subpath, and emit GAF.

Records are emitted in read input order; a read's placements in descending
score order ('best first', as the fixtures show for split reads).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.model import Graph
from ..io.fastq import encode_seq, load_reads
from ..io.stream import OutputStream
from ..ops import seqalign
from ..utils import profiling
from ..utils.log import lg
from ..utils.profiling import span
# the building blocks and the seeded engine; the names that only the tests
# and the benchmark use here (DevicePools, _SegCodes, build_oriented_*)
# are re-exported as they are
from .paths import (CapAudit, GafHit, OrientedPath,  # noqa: F401
                    _longest_uncovered, _mapq, _reject_ending_inside,
                    _SegCodes, accept, build_oriented_codes,
                    build_oriented_struct, enumerate_paths, finish, overlap_table)
from .seeded import DevicePools, SeededAlign  # noqa: F401

MIN_SCORE = 20          # reject spurious local hits (hifi preset)

# Host wall seconds per stage of the seeded aligner, summed over the calls
# since a caller last zeroed them: seeding (index, anchors, candidates),
# scoring (inside SeededAlign.score: dispatch and the fetch that waits for
# the device) and traceback: the registry's spans align.<stage>.
PHASE_SECONDS = profiling.view(profiling.SECONDS, "align.",
                               ("seeding", "scoring", "traceback"), 0.0)

# The host ladder's native calls since a caller last zeroed them: rungs
# (seq_banded_pairs calls), pairs scored and banded DP cells (read length
# times band width, summed over the pairs of every rung).  The registry's
# counters align.host_ladder.<key>.
HOST_LADDER = profiling.view(profiling.COUNTS, "align.host_ladder.",
                             ("rungs", "pairs", "cells"))


@dataclass
class AlignParams:
    """Tunable surface of the in-house aligner — the equivalents of the
    reference's GraphAligner preset knobs (src/main.cpp:177-182):

      * min_score       ~ --min-alignment-score: reject weaker placements;
      * seed_k          ~ --seeds-mxm-length (inverted sense): anchor
                          k-mer length — SHORTER seeds survive higher
                          error rates (p_clean ≈ (1-e)^k per position);
      * max_anchors / max_paths_per_anchor: seed-count budget per read;
      * band / wide_band ~ --precise-clipping stringency: the banded DP
                          width around the anchor diagonal — wider bands
                          tolerate the larger indel drift of noisy reads
                          before the full-DP safety net fires.
      * seed_sample     : keep 1/N of index k-mers (0 = auto by graph
                          size, 1 = keep every k-mer; --seed-sample).

    band/wide_band are kept multiples of 8 (run_graph_aligner rounds
    overrides up)."""

    min_score: int = MIN_SCORE
    seed_k: int = 15
    max_anchors: int = 12
    max_paths_per_anchor: int = 16
    band: int = 128
    wide_band: int = 512
    seed_sample: int = 0


# Reference preset table (src/main.cpp:178-182): hifi = GraphAligner
# '-x vg'; CLR adds '--seeds-mxm-length 1000 --min-alignment-score 1000
# --precise-clipping 0.75' for ~10-15%-error reads.  The in-house CLR
# mapping: shorter anchors (13-mers keep ~20% clean-seed odds per
# position at 12% error vs ~4% for 15-mers over both error flanks), more
# of them, a 4x-wider starting band for indel drift, and a higher score
# floor (tests/test_align_clr.py validates placement at 5% and 12%
# error).
PRESETS = {
    "hifi": AlignParams(),
    "CLR": AlignParams(min_score=50, seed_k=13, max_anchors=16,
                       max_paths_per_anchor=16, band=512, wide_band=1024),
}


def _fmt_g(value: float) -> str:
    """C++ %g-style float (GraphAligner tag formatting): 6 significant
    digits, no trailing zeros."""
    return f"{value:g}"


SEED_THRESHOLD = 48   # above this many segments, switch to k-mer seeding


def align_engine(device) -> str:
    """The seeded engine's scoring ladder on `device`: "device" on CUDA
    (K3 banded, K4 full DP), "host" on the CPU, where the native host
    ladder (`seq_banded_pairs`, the JAX package's default engine) is far
    faster than the kernels' plain versions and prints that engine's
    bytes where the two ladders disagree."""
    return "device" if torch.device(device).type == "cuda" else "host"


def align_reads(graph: Graph, reads: Sequence[Tuple[str, str]],
                min_score: int = MIN_SCORE,
                params: Optional[AlignParams] = None,
                device="cuda") -> List[Tuple[str, int, List[GafHit]]]:
    """Returns [(read name, read length, hits sorted by descending score)].

    Small graphs use exact exhaustive path enumeration; larger graphs use
    k-mer seed-and-extend candidate generation (engine/seeding.py).
    `params` carries the preset-tunable surface (AlignParams); when given
    it supersedes `min_score`.  Scoring runs on `device`, whose type
    picks the seeded engine's ladder (align_engine)."""
    device = torch.device(device)
    engine = align_engine(device)
    if params is None:
        params = AlignParams(min_score=min_score)
    if graph.n_segments > SEED_THRESHOLD:
        return _align_seeded(graph, reads, params, device, engine)
    audit = CapAudit()
    paths = enumerate_paths(graph, audit=audit)
    audit.report("align(exhaustive)")
    return _align_with_paths(graph, reads, paths, params.min_score, device)


def _align_seeded(graph: Graph, reads, params: AlignParams, device, engine: str):
    """The seeded engine (engine/seeded.py); `engine`: align_engine's."""
    return SeededAlign(graph, reads, params, device, engine).run()


def _align_with_paths(graph: Graph, reads: Sequence[Tuple[str, str]],
                      paths: List[OrientedPath],
                      min_score: int = MIN_SCORE,
                      device="cuda") -> List[Tuple[str, int, List[GafHit]]]:
    if not paths or not reads:
        return [(name, len(seq), []) for name, seq in reads]

    # pow2 shape buckets, as the JAX package pads them
    from ..ops.nw_path import pad_pow2
    max_lr = pad_pow2(max(len(seq) for _, seq in reads), floor=16)
    max_lp = pad_pow2(max(len(p.seq) for p in paths), floor=16)
    R, P = len(reads), len(paths)
    P_pad = pad_pow2(P, floor=1)  # bucket the path dim too (all-PAD dummies
    # never reach min_score, so they are inert)
    read_codes = np.full((R, max_lr), seqalign.PAD, dtype=np.int8)
    for i, (_, seq) in enumerate(reads):
        read_codes[i, :len(seq)] = encode_seq(seq)
    path_codes = np.full((P_pad, max_lp), seqalign.PAD, dtype=np.int8)
    for i, p in enumerate(paths):
        path_codes[i, :len(p.seq)] = encode_seq(p.seq)

    path_dev = torch.from_numpy(path_codes).to(device)

    all_hits: List[List[GafHit]] = [[] for _ in reads]
    accepted: List[List[Tuple[int, int]]] = [[] for _ in reads]
    active = list(range(R))
    work_codes = read_codes.copy()
    # iterative placement: a read's best placement can shadow a lower-scoring
    # supplementary placement on the SAME path, so mask accepted query
    # regions and re-score until nothing new qualifies (random2's read8 finds
    # '<11' only after its '<13' region is masked)
    for _round in range(4):
        if not active:
            break
        # pad the active batch to a power-of-2 bucket (all-PAD rows score 0)
        bucket = max(8, 1 << (len(active) - 1).bit_length())
        batch = np.full((bucket, max_lr), seqalign.PAD, dtype=np.int8)
        batch[:len(active)] = work_codes[active]
        best, bi, bj = (x.cpu().numpy() for x in
                        seqalign.batched_local_scores(
                            torch.from_numpy(batch).to(device), path_dev))
        best, bi, bj = best[:len(active)], bi[:len(active)], bj[:len(active)]
        next_active = []
        for ai, r in enumerate(active):
            name, seq = reads[r]
            rcodes = work_codes[r, :len(seq)]
            order = np.argsort(-best[ai], kind="stable")
            placed = False
            for pi in order:
                if best[ai, pi] < min_score or pi >= P:
                    break
                pcodes = path_codes[pi, :len(paths[pi].seq)]
                if _reject_ending_inside(graph, paths[pi], int(best[ai, pi]),
                                         int(bi[ai, pi]), int(bj[ai, pi]),
                                         accepted[r], all_hits[r]):
                    continue
                pl = seqalign.traceback(rcodes, pcodes,
                                        int(bi[ai, pi]), int(bj[ai, pi]),
                                        device)
                placed = accept(graph, paths[pi], pl, accepted[r],
                                all_hits[r], min_score) or placed
            if placed:
                for a, b in accepted[r]:
                    work_codes[r, a:b] = seqalign.PAD
                uncovered = _longest_uncovered(len(seq), accepted[r])
                if uncovered >= min_score:
                    next_active.append(r)
        active = next_active

    return finish(reads, all_hits)


def emit_gaf(results, write) -> None:
    for name, qlen, hits in results:
        for h in hits:
            as_score = h.blocklen - 2.94 * h.nm
            dv = h.nm / h.blocklen if h.blocklen else 0.0
            ident = h.matches / h.blocklen if h.blocklen else 0.0
            write("\t".join([
                name, str(qlen), str(h.qstart), str(h.qend), "+",
                h.path_str, str(h.plen), str(h.pstart), str(h.pend),
                str(h.matches), str(h.blocklen), str(h.mapq),
                f"NM:i:{h.nm}", f"AS:f:{_fmt_g(as_score)}", f"dv:f:{_fmt_g(dv)}",
                f"id:f:{_fmt_g(ident)}", f"cg:Z:{h.cigar}",
            ]) + "\n")


def align_reads_distributed(graph: Graph, reads, params: AlignParams,
                            shard, device="cuda") -> Optional[str]:
    """Read-sharded multi-process align: reads are independent, so each
    process aligns reads[pid::count] on its own device, serializes its
    per-read GAF blocks (length-prefixed, so a read without records is an
    empty block), and one allgather reassembles the exact input order on
    rank 0, returned as the whole GAF text; other ranks return None and
    write nothing.  Byte-identical to a single-process run, since per-read
    results do not depend on batch composition.

    Unless -j set a thread cap, each process caps the native thread pool
    at this host's cores over its co-located processes for the run, and
    restores the default afterwards."""
    import io as _io
    import os
    import struct

    from ..io import native
    from ..parallel.dist import allgather_bytes, local_process_count, process_info

    pid, count = shard
    if process_info() != (pid, count):
        raise RuntimeError(f"align shard {shard} is not this process's place in "
                           f"the process group {process_info()}")
    capped = native.user_threads() == 0
    if capped:
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
            else (os.cpu_count() or 1)
        native.set_threads(max(1, cores // local_process_count()))
    try:
        local = [reads[i] for i in range(pid, len(reads), count)]
        results = align_reads(graph, local, params=params, device=device)
    finally:
        if capped:
            native.set_threads(0)
    blocks: List[bytes] = []
    for res in results:
        buf = _io.StringIO()
        emit_gaf([res], buf.write)
        blocks.append(buf.getvalue().encode())
    payload = b"".join(struct.pack("<I", len(b)) + b for b in blocks)
    gathered = allgather_bytes(payload)
    if pid != 0:
        return None
    per_rank: List[List[bytes]] = []
    for blob in gathered:
        off, lst = 0, []
        while off < len(blob):
            (n,) = struct.unpack_from("<I", blob, off)
            off += 4
            lst.append(blob[off:off + n])
            off += n
        per_rank.append(lst)
    return b"".join(per_rank[i % count][i // count]
                    for i in range(len(reads))).decode()


def run_graph_aligner(graph: Graph, read_files, out_file: str,
                      preset: str = "hifi", overrides=None,
                      echo: bool = False, out=None, shard=None,
                      device="cuda") -> None:
    if graph is None:
        print("align: missing input graph (-f)", file=sys.stderr)
        raise SystemExit(1)
    with span("align.read_fastq"):
        reads = load_reads(read_files)
    params = PRESETS.get(preset)
    if params is None:
        # reference parity: unknown preset names abort (src/main.cpp:185-188)
        print(f"Could not find preset: {preset}")
        raise SystemExit(1)
    if overrides:
        import dataclasses

        params = dataclasses.replace(params, **overrides)
        # band widths are kept multiples of 8, as the JAX package rounds
        # them: the rounded values are echoed and used
        params = dataclasses.replace(
            params, band=-(-params.band // 8) * 8,
            wide_band=-(-max(params.wide_band, params.band) // 8) * 8)
    if echo and (shard is None or shard[0] == 0):
        # analogue of the reference's `Invoking: <GraphAligner cmd>` echo
        # (src/main.cpp:167-168): print the fully resolved in-house
        # invocation so runs are reproducible from the log.  When the GAF
        # itself streams to stdout (no -o / stdout-extension dispatch),
        # the echo moves to stderr so the record stream stays pure.
        from ..io.stream import STDOUT_EXTS

        to_stdout = (not out_file) or out_file in STDOUT_EXTS
        echo_out = sys.stderr if to_stdout else (out or sys.stdout)
        echo_out.write(
            f"Invoking: gfalign-tpu-align -p {preset}"
            f" --seed-k {params.seed_k} --min-score {params.min_score}"
            f" --max-anchors {params.max_anchors}"
            f" --max-paths-per-anchor {params.max_paths_per_anchor}"
            f" --band {params.band} --wide-band {params.wide_band}\n")
    if shard is not None and shard[1] > 1:
        text = align_reads_distributed(graph, reads, params, shard, device)
        if text is None:
            return  # non-zero rank: rank 0 writes the gathered GAF
        lg.verbose(f"Aligned {len(reads)} reads (distributed x{shard[1]}): "
                   f"{text.count(chr(10))} records")
        if out_file:
            stream = OutputStream(out_file)
            stream.write(text)
            stream.close()
        else:
            sys.stdout.write(text)
        return
    results = align_reads(graph, reads, params=params, device=device)
    n_hits = sum(len(h) for _, _, h in results)
    lg.verbose(f"Aligned {len(reads)} reads: {n_hits} records")
    with span("align.emit"):
        if out_file:
            stream = OutputStream(out_file)
            emit_gaf(results, stream.write)
            stream.close()
        else:
            emit_gaf(results, sys.stdout.write)
