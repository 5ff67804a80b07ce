#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (gfalign_torch) runs on an
NVIDIA H100.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build csrc/nw_path.cu (kernels K1 and K2) and csrc/seqalign.cu (K3,
     K4, K5) with nvcc, both compilers started together, and meanwhile the
     native host runtime (native/gfalign_host.cpp: parsers, tracebacks,
     seeding, the C++ search driver) with g++, each timed; then the
     machine instructions per DP cell of every K1, K2, K3 and K4 row loop,
     counted in cuobjdump's disassembly of the built libraries;
  3. K1 against its plain PyTorch version on the card, bit-exact, at the
     shapes of bench.py (C=128, R=16,384 fw+rc, N=M=64) and on ragged
     batches with empty rows (search-like short reads in every length
     bucket, a candidate count that is no multiple of the chunk, reads of
     33 and 64 steps that sweep strips); timed with CUDA events;
  4. K2 against its plain version at n + m >= 8192: a ragged batch of 512
     pairs, then 1, 3 and 200 pairs, and a read wider than one block;
  5. the slice end to end at full scale (synth.make_workload(seed=0):
     1,000 segments, 10,000 reads): `search` and `evalPath` through
     gfalign_torch.cli.main.main on CUDA, byte-equal to the goldens in
     tests/data/, then long-path scoring (batched_best_scores, which takes
     K2); launch counters are zeroed before and read after each of these
     three runs, and each run must have launched its kernel;
 5b. a curator's post-filter search: the truth GAF through `filter` with
     the tangle's node list (golden md5), then the same search on that
     read set (R = 249) with the Python driver scoring through K1 on the
     card and with the C++ driver (`use_native=True`, scoring on the
     host), in turns (Python, C++, C++, Python): each output byte-equal to
     the golden, walls printed; the Python driver must launch K1 and the
     C++ driver must not;
  6. K1 and K2 timed against their plain versions at the main path's own
     shapes (the largest search frontier; the long-path batch); phases 3,
     4 and 6 print the time recorded for the thread-per-pair layout that
     these kernels replaced (OLD_LAYOUT_MS) beside the new one;
  7. the search once more, its first PROFILE_FRONTIERS frontier calls under
     torch.profiler (device activity only): device time by kernel and the
     device's idle share of that window's wall, beside the same window's
     unprofiled wall from phase 5;
  8. K3, K4 and K5 against their plain PyTorch versions, bit-exact on every
     output, on ragged random batches (PAD-masked read stretches, off-band
     deltas, N codes, all-PAD rows, multi-step paths), K3 at ont_r10.align's
     shape (a pool padded to 262,144, reads of up to 201.6 kb, bands 1,024
     and 2,048), then at phase 10's shapes synthesised without an align run
     (bench_seqalign), timed with the first design's recorded times beside;
 8b. the exact full-matrix walk (sa_walk) against the native host walk,
     bit-exact, one walk launch a walk: every small case of
     bench_seqalign.WALK_CASES and three CLR-sized pairs (WALK_CLR: 20-30 kb
     reads at 87% against 40-60 kb paths, one with a PAD stretch, each
     ending at K4's best cell), and its walk codes against the plain
     version's on the largest pair's first 1,000 rows (the differences
     counted and printed); at those sizes the kernel's time (CUDA
     events; the forward pass and the walk apart, by torch.profiler), the
     walk as the align mode calls it (upload, launch, copy back; host
     clock), the host walk's time, the bound and the plain version (its
     first rows, scaled), and each pair walked as one tile beside the
     default budget's row blocks; then a walk of 300 k x 600 k cells (a
     read at 99% whose alignment ends at the path's end, no cut), whose
     score must equal K4's best at its end cell and whose peak device
     memory must stay within 1 GiB;
 8c. the banded walk kernel (sa_bandtrace, through
     ops/seqalign_cuda.banded_walks_cuda) against the native host walk,
     bit-exact, at clr.align's walk shapes (waves of 1, 16 and 144
     CLR-sized walks at band 512, 16 at band 1,024) and ont_r10.align's
     (the reads of 3-201.6 kb of bench_seqalign.ultra_long_band_walks in
     one wave at bands 1,024 and 2,048, and the 201.6 kb walk alone): the
     wave as the align mode calls it (one upload, the launches, one copy
     back; host clock), its kernels' device time (torch.profiler), the
     bound (8 int32 operations a band cell), the plain version (the first
     rows of the longest walk, scaled: its codes there must equal the
     kernel's, and its walk of the first CLR walk the kernel's) and the
     host walks' time;
  9. `align` end to end through gfalign_torch.cli.main.main on CUDA, three
     runs, each GAF equal to its golden in tests/data/ (md5 and record
     count) with the launch counters zeroed before and read after: the
     seeded engine at full scale (the 1,142-segment graph of
     make_workload(seed=0) and all 10,000 of its reads, 2-8 kb, hifi;
     must launch K3), a small seeded run whose hand-made reads end on the
     band edge at both band widths (must launch K4), and the exhaustive
     engine on a 34-segment graph (must launch K5); every banded traceback
     of every run must go through the banded walk kernel (banded_cuda ==
     banded_walks, native == 0) and every full-matrix one through the walk
     kernel (ops/seqalign's TRACEBACK_CALLS: no Python traceback);
 10. K3, K4 and K5 timed against their plain versions at those runs' own
     shapes: K3 at the seeded run's largest chunk at widths 128 and 512, K4
     at the largest bucket launched, K5 at the exhaustive run's first call;
     K3 and K4 with the first design's recorded times beside;
 11. distribution: two rank processes on the one card, launched as
     torchrun would (127.0.0.1, a free port, gloo, /dev/shm), each
     checking that it scores on CUDA: (a) the full-scale search with the
     reads sharded by qname, Python driver + K1 (golden-equal, K1 launched
     on each rank); (b) the post-filter search (R = 249) with the frontier
     sharded, by the Python driver + K1 and by the C++ driver over the
     /dev/shm ring (golden md5); (c) the seeded align of all 10,000 reads,
     reads sharded by index, rank 0 writing the GAF (golden md5, K3
     launched on each rank, every banded traceback on the card), its wall beside
     phase 9's; (d) evalGFA statistics with duplicate marking on the truth
     GAF, equal to the one-process run's bytes; (e) `python -m
     gfalign_torch search` with GFALIGN_TORCH_DISTRIBUTED=1 on the
     post-filter reads (golden md5, K1 launched on each rank: the CLI's
     default driver on CUDA).  A rank that exits non-zero or differs fails the
     script; past the deadline every rank is killed and the script fails.
 12. the host ladder: `align -p hifi` on the CPU device, whose ladder is
     the native host scoring ladder (the JAX package's default engine), on
     phase 9's seeded run (all 10,000 reads) and band-edge run, each GAF
     equal to tests/data/torch_slice_align_host_seed0.md5 (made by that
     engine), no kernel launched; its scoring seconds, rungs, pairs and banded
     cells beside phase 9's device ladder on the same reads, with both
     runs' stage seconds and traceback counts;
 13. the trace: the CLI `search` on the post-filter reads (R = 249) without
     and with GFALIGN_TORCH_TRACE (torch.profiler, CPU and CUDA activity):
     both outputs golden-equal, the Chrome trace parses, and its
     nw_fwd_packed kernel events equal the K1 launches counted over the
     traced run; walls with and without the trace;
 14. the dry run: gfalign_torch.dryrun.dryrun_multichip(4) with every rank
     on cuda:0: the two-axis scoring step on the (2, 2) grid (the example
     batch and the full-scale search's largest frontier) equal to
     local_step, the full-scale search frontier-sharded on four ranks and
     the align of all 10,000 reads on four ranks, each byte-equal to one
     process; every rank must launch K1, and every align rank K3.

A kernel's bound is its useful DP cells times its integer-ALU operations
per cell (OPS_PER_CELL) over the card's int32 ALU rate, or its bytes over
HBM bandwidth if larger.  For K3-K5 the cells are those of the rows up to
each read's last non-PAD char (the kernels skip the rest).

`python3 chip_smoke.py --dist` runs phases 1, 2 and 11 only (no result
line), and `--host-ladder`, `--trace` and `--dryrun` phases 1, 2 and 12,
13 or 14 alone (no result line either); `python3 chip_smoke.py --nw` stops after phase 4 (build, K1 and K2 against
their plain versions: under a minute) and prints no result line;
`python3 chip_smoke.py --sa` runs phases 1, 2, 8, 8b and 8c only (build,
K3-K5 against their plain versions and at the synthesised phase-10 shapes,
the walk, the banded walk: a few minutes), no result line either.

The line before the last is the kernel table as JSON, the last line
{"ok": true, "device": {...}}.  Details also go to chiprun_out/chip_smoke.json.
It needs a CUDA device and this repository; it imports neither jax nor
gfalign_tpu.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 at
# 3.35 TB/s; 132 SMs at the 1.98 GHz boost clock (132 x 128 float32 lanes
# x 2 x 1.98 GHz is the data sheet's 67 TFLOP/s float32), each SM retiring
# 64 int32 results of its integer ALU pipe per clock (16 per sub-partition):
# 16.7 T int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_ALU_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per DP cell that only the integer ALU pipe executes,
# counted from the row loops of csrc/nw_path.cu, one count per kernel
# whatever the strip width.  K1: the key compare, the select of the
# diagonal delta, two maxes and the priority mask.  K2: the key compare,
# the select of the diagonal delta, two maxes, the two move compares
# (q == dg, up >= left) and the two selects of E.  The three adds per cell
# are left out: Hopper fuses an add into a max (VIADDMNMX) or issues it as
# IMAD on the FMA pipe.  Issue (128 instructions per SM and clock) binds
# later: 8/128 and 11/128 instructions per cell against 5/64 and 8/64.
#
# From the row loops of csrc/seqalign.cu, by the same rule.  K3 (the group
# kernel, which serves the seeded run's widths 128 and 512): the byte
# extract of the path char, the match compare, the select of the
# substitution, the add-then-max with 0 of the cell, the chain's
# add-then-max, the carry's add-then-max and the key's max = 7.  K4: the
# match compare, the select, the cell's add-then-max with 0, the chain's
# add-then-max and the key's max = 5.  K5: the PAD compare, the match
# compare, the two selects, two maxes, the scan's max, the carry's max and
# the key's max = 9.  Left out: the adds (fused or IMAD), the key's
# multiply (IMAD), the shuffles of K3's scan and K4's hand-over, which a
# thread pays once per row for its 16 or 8 cells, and the PAD test, which
# only rows that can see a PAD inside the path pay.  The first designs of
# K3 and K4 (one block a pair) spent 16 and 9, and the bounds recorded
# beside OLD_LAYOUT_MS's times were stated with those counts; the
# block-per-pair K3, which still serves bands over 512 lanes and those
# that are not multiples of 16, spends 16.
OPS_PER_CELL = {"packed": 5, "split": 8, "banded": 7, "pairs": 5, "cross": 9}
# The walk's bound counts 8 int32 operations a cell, as the benchmark's
# roofline counts a DP cell (benchmark/roofline.py); its row loop spends about
# twice that, the recurrence (K4's 4 without the key) and the walk code (three
# compares, three selects, the floor's select, the shift and the or).
WALK_OPS_PER_CELL = 8
# K1 and K2 as first ported (one thread per pair, a block per candidate x 128
# reads), timed by this script at the same shapes on an NVIDIA H100 80GB HBM3
# at 700.00 W (PERF.md section 6 keeps the record), then with the host's
# launch overhead inside the events, which adds some 0.05 ms to the shortest;
# K3 and K4 as first ported (one block a pair), timed device-only by this
# script's phase 10 before their redesign, same card and limit: printed
# beside the times of the present design, never compared by the script.
# gfalign_torch/bench_nw.py and bench_seqalign.py time old and new in one way.
OLD_LAYOUT_MS = {"k1_bench": 7.331, "k1_main": 0.313, "k2_check": 13.78,
                 "k2_main": 176.2, "k3_128": 7.027, "k3_512": 14.883,
                 "k4": 2.969}
ALIGN_MAX_SECONDS = 400  # the seeded align phase's share of the script's limit
PROFILE_FRONTIERS = 300  # frontier calls of the search under the profiler
KERNELS = {
    "packed": dict(name="nw_fwd_packed (K1)",
                   replaces="gfalign_tpu/ops/nw_pallas.py:159"),
    "split": dict(name="nw_fwd_split (K2)",
                  replaces="gfalign_tpu/ops/nw_pallas.py:59"),
    "banded": dict(name="sa_banded_fwd (K3)",
                   replaces="gfalign_tpu/ops/seqalign_pallas.py:257"),
    "pairs": dict(name="sa_pairs_fwd (K4)",
                  replaces="gfalign_tpu/ops/seqalign_pallas.py:57 via :445"),
    "cross": dict(name="sa_local_fwd cross product (K5)",
                  replaces="gfalign_tpu/ops/seqalign_pallas.py:57 via :176"),
    "walk": dict(name="sa_walk (the exact full-matrix traceback)",
                 replaces="none (the JAX package walks on the host)"),
    "bandtrace": dict(name="sa_bandtrace (the banded tracebacks of a wave)",
                      replaces="none (the JAX package walks on the host)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median time of fn() on the card, by CUDA events.  The card is kept
    busy (a spin of about a millisecond) while the host enqueues fn's work,
    so that the events bracket the device's time for it and not the host's
    time to launch it, which for a kernel of 0.1 ms is the larger."""
    import torch

    for _ in range(warmup):
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


def bound(a_keys, a_len, b_keys, b_len, kind):
    """(least ms, 'bytes' or 'operations', useful cells) for the best-of-both
    scores of these inputs: the useful cells (sum over pairs of a_len x
    b_len, both orientations) times the kernel's ALU operations per cell
    over the int32 ALU rate, against each input read once (the read keys in
    both orientations) and the output written once over HBM bandwidth."""
    cells = int(a_len.sum()) * 2 * int(b_len.sum())
    ops_s = cells * OPS_PER_CELL[kind] / INT32_ALU_OPS_PER_S
    nbytes = 4 * (a_keys.numel() + a_len.numel() + 2 * b_keys.numel()
                  + 2 * b_len.numel() + a_len.numel() * b_len.numel())
    bytes_s = nbytes / HBM_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations", cells
    return bytes_s * 1e3, "bytes", cells


def compare(kind, a_keys, a_len, b_keys, b_len, reps=5, operand=None):
    """Kernel vs plain version on the same CUDA inputs: max(forward,
    reverse-complement) scores of every candidate against every read,
    exact equality, times, and the bound.  The kernel is timed as the main
    path launches it, on a read operand prepared beforehand (`operand`, or
    one made here from b_keys and b_len); the plain version scores the
    stacked forward and reverse-complement rows.  Launches made here are
    comparison launches."""
    import torch

    from gfalign_torch.ops import nw_cuda
    from gfalign_torch.ops.nw_path import nw_best_scores_ref

    if operand is None:
        operand = nw_cuda.ReadOperand(b_keys, b_len)
    R = b_keys.shape[0]
    before = nw_cuda.LAUNCHES[kind]
    got = operand.to_caller_order(nw_cuda.scores_prepared(a_keys, a_len, operand))[:, :R]
    torch.cuda.synchronize()
    if nw_cuda.LAUNCHES[kind] <= before:
        raise RuntimeError(f"{kind}: the wrapper did not launch its kernel")
    want = nw_best_scores_ref(a_keys, a_len, b_keys, b_len)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        raise RuntimeError(f"{kind}: kernel differs from its plain version "
                           f"(max abs err {err})")
    ms = time_ms(lambda: nw_cuda.scores_prepared(a_keys, a_len, operand), reps=reps)
    plain_ms = time_ms(lambda: nw_best_scores_ref(a_keys, a_len, b_keys, b_len),
                       warmup=0, reps=max(1, reps // 2))
    bound_ms, bound_by, cells = bound(a_keys, a_len, b_keys, b_len, kind)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, cells=cells,
                shape=dict(C=a_keys.shape[0], n=a_keys.shape[1],
                           rows=2 * R, m=b_keys.shape[1]))


def random_keys(gen, C, n, R, m, nodes, ragged, max_read=None):
    """Candidate and read key batches on the card (pads -1 / -2); ragged
    batches draw lengths in [0, width] (reads in [0, max_read] when given)
    and force some empty rows."""
    import torch

    def keys(rows, width, pad, orients, longest):
        k = (torch.randint(0, nodes, (rows, width), generator=gen) * 4
             + torch.randint(0, orients, (rows, width), generator=gen))
        if ragged:
            lens = torch.randint(0, longest + 1, (rows,), generator=gen)
            lens[::17] = 0
        else:
            lens = torch.full((rows,), width)
        k = torch.where(torch.arange(width)[None, :] < lens[:, None], k, pad)
        return k.int().cuda(), lens.int().cuda()

    a_keys, a_len = keys(C, n, -1, 3, n)
    b_keys, b_len = keys(R, m, -2, 2, m if max_read is None else max_read)
    return a_keys, a_len, b_keys, b_len


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 card: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return smi, name


def phase_build():
    from gfalign_torch.io import native
    from gfalign_torch.ops import cuda_build

    t0 = time.time()
    stems = ("nw_path", "seqalign")
    started = {stem: cuda_build.start_build(stem) for stem in stems}  # side by side
    native_s = native.build()            # g++ while nvcc runs; raises on failure
    if not native.available():
        raise RuntimeError("the native host runtime did not load")
    log(f"phase 2 build: native/gfalign_host.cpp (native host runtime) with g++ "
        f"in {native_s:.1f} s, {native.LIB_PATH.relative_to(ROOT)}")
    for stem in stems:
        report = cuda_build.finish_build(stem, started[stem])
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: " + line.strip())
    secs = time.time() - t0
    log(f"phase 2 build: csrc/nw_path.cu and csrc/seqalign.cu in {secs:.1f} s")
    return dict(cuda_s=secs, native_s=native_s), sass_per_cell(cuda_build)


def sass_per_cell(cuda_build):
    """Machine instructions per DP cell of every K1, K2, K3, K4 and walk row loop,
    read off the built libraries.  K1 and K2 spend two max-type
    instructions on a cell (K1 two add-then-max; K2 a max and an
    add-then-max), so an innermost loop's count of them gives its cells.
    A K3 group kernel's row is 2 + log2(G) shuffles over L cells a thread,
    and a K4 or walk wavefront step one shuffle over K cells (L, G and K from the
    kernel's template arguments), so there the loop's shuffles give its
    cells.  'alu' leaves out loads, stores, branches, barriers and
    shuffles."""
    from gfalign_torch.ops.seqalign_cuda import WALK_K

    not_alu = ("LD", "ST", "BRA", "BAR", "SHFL", "BSSY", "BSYNC", "NOP", "WARPSYNC",
               "EXIT", "CALL", "RET", "ATOM", "RED")
    out = []
    for stem in ("nw_path", "seqalign"):
        try:
            loops = cuda_build.sass_inner_loops(stem)
        except (RuntimeError, OSError, subprocess.CalledProcessError) as exc:
            log(f"  sass {stem}: not measured ({exc})")
            continue
        for loop in loops:
            ops, fn = loop["opcodes"], loop["function"]
            shfl = ops.get("SHFL", 0)
            group = re.search(r"banded_group_kernelILi(\d+)ELi(\d+)E", fn)
            pairs = re.search(r"pairs_fwd_kernelILi(\d+)E", fn)
            if "nw_fwd_" in fn:
                cells = sum(v for k, v in ops.items() if "MNMX" in k) // 2
                kernel = re.search(r"nw_fwd_\w+?(?=I|ILi|Pv|PK)", fn)
                kernel = kernel.group(0) if kernel else fn
            elif group:
                L, G = int(group.group(1)), int(group.group(2))
                cells = shfl // (2 + G.bit_length() - 1) * L
                kernel = f"banded_group<L={L},G={G}>"
            elif pairs:
                cells = shfl * int(pairs.group(1))
                kernel = f"pairs_fwd<K={pairs.group(1)}>"
            elif "walk_fwd_kernel" in fn:
                cells = shfl * WALK_K
                kernel = f"walk_fwd<K={WALK_K}>"
            else:
                continue
            if cells < 2:
                continue
            kernel += "<int64 keys>" if "ExEE" in fn or "xEEv" in fn else ""
            alu = sum(v for k, v in ops.items() if not k.startswith(not_alu))
            row = dict(kernel=kernel, cells=cells, instructions=loop["instructions"],
                       alu=alu, per_cell=loop["instructions"] / cells,
                       alu_per_cell=alu / cells, opcodes=ops)
            out.append(row)
            log(f"  sass {row['kernel']}: row loop of {cells:g} cells, "
                f"{row['instructions']} instructions ({row['per_cell']:.2f} a cell), "
                f"{alu} ALU ({row['alu_per_cell']:.2f} a cell)")
    if not out:
        log("  sass: no row loop recognised in the disassembly")
    return out


def phase_k1_bench(gen):
    C, R, N, M = 128, 16384, 64, 64
    res = compare("packed", *random_keys(gen, C, N, R, M, 40, False), reps=3)
    records_per_s = C * R / (res["ms"] / 1e3)
    gcells = res["cells"] / (res["ms"] / 1e3) / 1e9
    log(f"phase 3 K1 bench shape C={C} R={R} (fw + rc: 2R rows) N=M={N}: exact; "
        f"{res['ms']:.3f} ms (thread-per-pair layout, recorded: "
        f"{OLD_LAYOUT_MS['k1_bench']} ms), plain {res['plain_ms']:.3f} ms, "
        f"{records_per_s:.4g} records/s, {gcells:.4g} useful Gcell/s, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    ragged = {}
    # (C, n, R, m, nodes, longest read): search-like with every length bucket
    # and a ragged candidate chunk; one strip plus one column; two strips
    for name, shape in (("search_like", (37, 8, 5000, 16, 6, 15)),
                        ("m33", (9, 24, 1000, 33, 5, 33)),
                        ("m64", (64, 64, 2048, 64, 6, 64))):
        r = compare("packed", *random_keys(gen, *shape[:5], True, shape[5]), reps=3)
        ragged[name] = r
        log(f"phase 3 K1 ragged batch with empty rows {name} C={shape[0]} "
            f"R={shape[2]} n={shape[1]} m={shape[3]}: exact; {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms")
    return dict(bench=res, records_per_s=records_per_s, gcell_per_s=gcells,
                ragged=ragged)


def phase_k2(gen):
    from gfalign_torch.ops import nw_cuda

    res = compare("split", *random_keys(gen, 2, 6144, 128, 2048, 50, True), reps=3)
    log(f"phase 4 K2 C=2 R=128 (256 rows) n=6144 m=2048: exact; {res['ms']:.3f} ms "
        f"(thread-per-pair layout, recorded: {OLD_LAYOUT_MS['k2_check']} ms), "
        f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms")
    few = {}
    # (C, n, R, m, longest read): 1, 3 and 200 (candidate, read) pairs at
    # n + m >= 8192, and a read wider than one block's columns (super-strips)
    for name, shape in (("1_pair", (1, 8190, 1, 64, False)),
                        ("3_pairs", (3, 8000, 1, 600, False)),
                        ("200_pairs", (2, 8190, 100, 8, True)),
                        ("wide_read", (1, 300, 2, 9000, False))):
        C, n, R, m, ragged = shape
        keys = random_keys(gen, C, n, R, m, 30, ragged)
        r = compare("split", *keys, reps=1)
        few[name] = r
        live = int((keys[3] > 0).sum())
        log(f"phase 4 K2 {name} C={C} R={R} n={n} m={m} (K, T) = "
            f"{nw_cuda.split_layout(int(keys[3].max()), 2 * C * live)}: exact; "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    return dict(res, few=few)


def read_goldens(name="torch_slice_evalpath_seed0.md5"):
    golden = {}
    for line in (ROOT / "tests/data" / name).read_text().splitlines():
        md5, lines, name = line.split()
        golden[name] = (md5, int(lines))
    return golden


def digest(data: bytes):
    return hashlib.md5(data).hexdigest(), data.count(b"\n")


def run_main(argv):
    """stdout, seconds and per-kernel launches of one CLI run on CUDA."""
    from gfalign_torch.cli.main import main
    from gfalign_torch.ops import nw_cuda

    for k in nw_cuda.LAUNCHES:
        nw_cuda.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    secs = time.time() - t0
    launches = dict(nw_cuda.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return buf.getvalue().encode(), secs, launches


def write_inputs(workdir, wl, phase="5"):
    """The full-scale workload's graph, truth GAF and search node list,
    written into workdir and md5-checked against the recorded inputs."""
    from gfalign_torch import synth
    from gfalign_torch.io.writers import write_gfa1

    t0 = time.time()
    work = pathlib.Path(workdir)
    paths = {"gfa": str(work / "graph.gfa"), "gaf": str(work / "truth.gaf"),
             "search_nodelist": str(work / "search_nodelist.tsv")}
    with open(paths["gfa"], "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, paths["gaf"])
    pathlib.Path(paths["search_nodelist"]).write_text(
        "".join(row + "\n" for row in wl.search_nodelist))
    golden = read_goldens()
    for key, name in (("gfa", "graph.gfa"), ("gaf", "truth.gaf")):
        if digest(pathlib.Path(paths[key]).read_bytes()) != golden[name]:
            raise RuntimeError(f"{name} differs from the recorded input")
    log(f"phase {phase} inputs: make_workload(seed=0) written and md5-checked in "
        f"{time.time() - t0:.1f} s")
    return paths


def phase_end_to_end(workdir, wl):
    import gfalign_torch.engine.search as search_mod

    paths = write_inputs(workdir, wl)
    golden = read_goldens()

    frontiers = []
    score_s = [0.0]
    window = {}
    evaluate = search_mod.evaluate_candidates

    def counting(candidates, read_batch, filter_alignments=True):
        frontiers.append((len(candidates), candidates, read_batch))
        t = time.perf_counter()
        window.setdefault("t0", t)
        try:
            return evaluate(candidates, read_batch, filter_alignments)
        finally:
            score_s[0] += time.perf_counter() - t
            if len(frontiers) == PROFILE_FRONTIERS:
                window["wall"] = time.perf_counter() - window["t0"]

    search_argv = ["search", "-f", paths["gfa"], "-g", paths["gaf"], "-n",
                   paths["search_nodelist"], "-s", "498", "-d", "503"]
    search_mod.evaluate_candidates = counting
    try:
        out, secs, launches = run_main(search_argv)
    finally:
        search_mod.evaluate_candidates = evaluate
    if launches["packed"] == 0:
        raise RuntimeError("search did not launch K1")
    if out != (ROOT / "tests/data/torch_slice_search_seed0.out").read_bytes():
        raise RuntimeError("search output differs from the golden:\n" + out.decode())
    search = dict(seconds=secs, scoring_seconds=score_s[0], frontiers=len(frontiers),
                  candidates=sum(f[0] for f in frontiers), launches=launches,
                  window_s=window["wall"])
    log(f"phase 5 search: golden-equal, {secs:.2f} s ({score_s[0]:.2f} s inside "
        f"evaluate_candidates), {len(frontiers)} frontiers, "
        f"{search['candidates']} candidates, launches {launches}")

    out, secs, launches = run_main(
        ["evalPath", "-f", paths["gfa"], "-g", paths["gaf"], "-p",
         "498+,499+,500+,501+,502+,503+"])
    if launches["packed"] == 0:
        raise RuntimeError("evalPath did not launch K1")
    if digest(out) != golden["evalpath.out"]:
        raise RuntimeError(f"evalPath output {digest(out)} differs from the "
                           f"golden {golden['evalpath.out']}")
    evalpath = dict(seconds=secs, launches=launches)
    log(f"phase 5 evalPath: golden md5 and line count, {secs:.2f} s, "
        f"launches {launches}")
    largest = max(frontiers, key=lambda f: f[0])
    return search, evalpath, largest, search_argv, paths


def write_filtered(work, wl, paths):
    """`filter` of the truth GAF with the tangle's node list (golden md5):
    the post-filter read set; returns (its path, the filter's seconds)."""
    nodes = pathlib.Path(work) / "filter_nodelist.ls"
    nodes.write_text("".join(n + "\n" for n in wl.filter_nodelist))
    filtered = str(pathlib.Path(work) / "filtered.gaf")
    _, filter_s, _ = run_main(["filter", "-g", paths["gaf"], "-n", str(nodes),
                               "-o", filtered])
    if digest(pathlib.Path(filtered).read_bytes()) != read_goldens()["filtered.gaf"]:
        raise RuntimeError("filter output differs from the golden filtered.gaf")
    return filtered, filter_s


def phase_filtered_search(work, wl, paths):
    """A curator's post-filter search (phase 5b): `filter` with the
    tangle's node list, then the search of phase 5 on the filtered read set
    through gfalign_torch.engine.search.search, by the Python driver (K1
    on the card) and by the C++ driver (use_native=True), in turns."""
    import torch

    from gfalign_torch.engine.alignments import AlignmentSet
    from gfalign_torch.engine.search import search
    from gfalign_torch.io import native
    from gfalign_torch.io.gfa import read_gfa
    from gfalign_torch.ops import nw_cuda

    golden = read_goldens()
    filtered, filter_s = write_filtered(work, wl, paths)
    graph = read_gfa(paths["gfa"])
    aln = AlignmentSet()
    aln.load(filtered)
    runs = []
    for use_native in (False, True, True, False):
        for k in nw_cuda.LAUNCHES:
            nw_cuda.LAUNCHES[k] = 0
        native.search_profile()                      # zero the driver's counters
        buf = io.StringIO()
        t0 = time.perf_counter()
        search(graph, aln, paths["search_nodelist"], "498", "503", out=buf,
               device="cuda", use_native=use_native)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total_s, eval_s, _, _ = native.search_profile()
        name = "native" if use_native else "python"
        if digest(buf.getvalue().encode()) != golden["search_filtered.out"]:
            raise RuntimeError(f"post-filter search ({name} driver) differs from "
                               f"the golden:\n{buf.getvalue()}")
        k1 = nw_cuda.LAUNCHES["packed"]
        if (k1 > 0) == use_native:
            raise RuntimeError(f"post-filter search ({name} driver) launched K1 "
                               f"{k1} times")
        runs.append(dict(driver=name, wall_s=wall, k1_launches=k1,
                         native_total_s=total_s, native_eval_s=eval_s))
    walls = {d: [r["wall_s"] for r in runs if r["driver"] == d] for d in ("python", "native")}
    log(f"phase 5b post-filter search: filter {filter_s:.2f} s, R={aln.count} reads; "
        f"golden-equal on both drivers; walls (Python driver + K1, C++ driver, "
        f"C++, Python) " + ", ".join(f"{r['wall_s']:.4f}" for r in runs) + " s; "
        f"C++ driver's own split: total {runs[1]['native_total_s']:.4f} s, "
        f"scoring {runs[1]['native_eval_s']:.4f} s; K1 launches of the Python "
        f"driver {runs[0]['k1_launches']}")
    return dict(reads=aln.count, filter_s=filter_s, runs=runs, walls=walls)


def phase_profile(search_argv, unprofiled_window_s):
    """The full-scale search once more, its first PROFILE_FRONTIERS frontier
    calls under torch.profiler with device activity only: device time by
    kernel, and the device's idle share of that window's wall in the same
    run.  The window's unprofiled wall (phase 5) shows what the profiler
    costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import gfalign_torch.engine.search as search_mod

    prof = profile(activities=[ProfilerActivity.CUDA])
    calls = [0]
    window = {}
    evaluate = search_mod.evaluate_candidates

    def windowed(candidates, read_batch, filter_alignments=True):
        if calls[0] == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        res = evaluate(candidates, read_batch, filter_alignments)
        calls[0] += 1
        if calls[0] == PROFILE_FRONTIERS:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
        return res

    search_mod.evaluate_candidates = windowed
    try:
        out, _, _ = run_main(search_argv)
    finally:
        search_mod.evaluate_candidates = evaluate
    if out != (ROOT / "tests/data/torch_slice_search_seed0.out").read_bytes():
        raise RuntimeError("profiled search output differs from the golden")
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    device_ms = sum(kernels.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler saw no device time")
    k1_ms = sum(v for k, v in kernels.items() if "nw_fwd_packed" in k)
    wall_ms = window["wall"] * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:14]
    res = dict(frontiers=PROFILE_FRONTIERS, device_ms=device_ms, k1_ms=k1_ms,
               wall_ms=wall_ms, unprofiled_wall_ms=unprofiled_window_s * 1e3,
               idle_share=1 - device_ms / wall_ms,
               top=[(k[:60], v) for k, v in top])
    log(f"phase 7 profile of search frontiers 0-{PROFILE_FRONTIERS - 1}: device "
        f"busy {device_ms:.1f} ms of {wall_ms:.1f} ms wall (idle share "
        f"{res['idle_share']:.3f}; unprofiled wall {res['unprofiled_wall_ms']:.1f}"
        f" ms); K1 {k1_ms:.1f} ms")
    for k, v in res["top"]:
        log(f"  {v:9.2f} ms  {k}")
    return res


def phase_long_paths():
    """Long-path scoring through batched_best_scores (the K2 path)."""
    import numpy as np
    import torch

    from gfalign_torch.ops import nw_cuda
    from gfalign_torch.ops.nw_path import (Step, batched_best_scores,
                                           encode_path_batch, nw_best_scores_ref,
                                           pad_pow2)

    rng = np.random.default_rng(0)
    cands = [[Step(int(v), "+") for v in rng.integers(0, 50, 6000)]
             for _ in range(2)]
    reads = []
    for i in range(32):
        src = cands[i % 2]
        start = int(rng.integers(0, 4000))
        piece = src[start:start + int(rng.integers(500, 2000))]
        reads.append([s for s in piece if rng.random() > 0.02])
    for k in nw_cuda.LAUNCHES:
        nw_cuda.LAUNCHES[k] = 0
    t0 = time.time()
    got = batched_best_scores(cands, reads, device="cuda")
    secs = time.time() - t0
    launches = dict(nw_cuda.LAUNCHES)
    if launches["split"] == 0:
        raise RuntimeError("long-path scoring did not launch K2")
    ak, al = encode_path_batch(cands, pad_pow2(6000), pad_key=-1)
    bk, bl = encode_path_batch(reads, pad_pow2(max(map(len, reads))), pad_key=-2)
    tensors = [torch.from_numpy(x).cuda() for x in (ak, al, bk, bl)]
    want = nw_best_scores_ref(*tensors).cpu().numpy()
    if not np.array_equal(got, want):
        raise RuntimeError("long-path scores differ from the plain version")
    log(f"phase 5 long paths: 2 candidates x 32 reads, n={ak.shape[1]} "
        f"m={bk.shape[1]}, equal to the plain version, {secs:.2f} s, "
        f"launches {launches}")
    return dict(seconds=secs, launches=launches), tensors


def phase_main_shapes(largest, long_tensors):
    """K1 at the largest search frontier's shape, on the search's own
    prepared read operand; K2 at the long-path batch's shape."""
    import torch

    from gfalign_torch.engine.evaluate import encode_frontier

    C, candidates, read_batch = largest
    a_keys, a_len = (torch.from_numpy(x).cuda() for x in encode_frontier(candidates))
    operand = read_batch.prepared().operand
    b_keys, b_len = read_batch.device_keys()
    k1 = compare("packed", a_keys, a_len, b_keys, b_len, operand=operand)
    k1["frontier_candidates"] = C
    k1["block_widths"] = {w: operand.block_w.count(w) for w in sorted(set(operand.block_w))}
    log(f"phase 6 K1 at the largest frontier C={C} (padded {a_keys.shape[0]}), "
        f"rows={k1['shape']['rows']}, n={k1['shape']['n']}, m={k1['shape']['m']}, "
        f"blocks by strip width {k1['block_widths']}: exact; {k1['ms']:.3f} ms "
        f"(thread-per-pair layout, recorded: {OLD_LAYOUT_MS['k1_main']} ms), "
        f"plain {k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']})")
    k2 = compare("split", *long_tensors, reps=3)
    log(f"phase 6 K2 at the long-path batch: exact; {k2['ms']:.3f} ms "
        f"(thread-per-pair layout, recorded: {OLD_LAYOUT_MS['k2_main']} ms), "
        f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.4f} ms "
        f"({k2['bound_by']})")
    return k1, k2


# ---------------------------------------------------------------------------
# align: K3, K4, K5
# ---------------------------------------------------------------------------


def live_rows(read_codes):
    """Per row, the rows the kernels sweep: up to the last non-PAD char."""
    import torch

    from gfalign_torch.ops.seqalign import PAD

    idx = torch.arange(1, read_codes.shape[1] + 1, device=read_codes.device)
    return torch.where(read_codes != PAD, idx, 0).amax(dim=1)


def sa_bound(kind, cells, nbytes):
    ops_s = cells * OPS_PER_CELL[kind] / INT32_ALU_OPS_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def compare_seqalign(kind, args, width=None, plain_cut=None, reps=3):
    """One of K3/K4/K5 against its plain version on the same CUDA inputs:
    exact equality of every output, times, and the bound.  `args` are the
    entry point's tensors: K3 (arena, cum_off, base_ptr, plen, read_pool,
    read_idx, path_idx, deltas), K4/K5 (read_codes, path_codes).  With
    plain_cut the plain version runs (and is compared) on the first
    plain_cut pairs or reads only and its time is scaled up."""
    import torch

    from gfalign_torch.ops import seqalign, seqalign_cuda

    if kind == "banded":
        def kernel(a=args):
            return seqalign.banded_arena_scores(*a, width=width, materialize=False)

        def cut(n):
            return args[:5] + tuple(x[:n] for x in args[5:])

        def plain(a):
            return seqalign.banded_arena_scores_ref(*a, width)
        n_all = args[5].shape[0]
        rows = live_rows(args[4][args[5].long().clamp(0, args[4].shape[0] - 1)])
        cells = int(rows.sum()) * width
        # each pair's read row and strip read once, indices in, 4 words out
        nbytes = int(rows.sum()) * 2 + n_all * (width + 3 * 4 + 4 * 4)
        shape = dict(N=n_all, lr=args[4].shape[1], width=width,
                     S=args[1].shape[1], live_rows=int(rows.sum()))
    else:
        pairwise = kind == "pairs"
        fn = seqalign.batched_pair_scores if pairwise else seqalign.batched_local_scores
        ref = seqalign.local_forward_pairs_ref if pairwise else seqalign.local_forward_ref

        def kernel(a=args):
            return fn(*a)

        def cut(n):
            return (args[0][:n], args[1][:n] if pairwise else args[1])

        def plain(a):
            return ref(*a)
        n_all = args[0].shape[0]
        rows = live_rows(args[0])
        n_paths = 1 if pairwise else args[1].shape[0]
        cells = int(rows.sum()) * n_paths * args[1].shape[1]
        nbytes = args[0].numel() + args[1].numel() + 12 * n_all * n_paths
        shape = dict(R=n_all, P=args[1].shape[0], lr=args[0].shape[1],
                     lp=args[1].shape[1], live_rows=int(rows.sum()))
    before = seqalign_cuda.LAUNCHES[kind]
    got = kernel()
    torch.cuda.synchronize()
    if seqalign_cuda.LAUNCHES[kind] <= before:
        raise RuntimeError(f"{kind}: the wrapper did not launch its kernel")
    n_plain = min(n_all, plain_cut or n_all)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(cut(n_plain))
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1) * (n_all / n_plain)
    err = 0
    for g, w in zip(got, want):
        g = g[:n_plain]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{kind}: output {tuple(g.shape)} {g.dtype} against "
                               f"plain {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err != 0:
        raise RuntimeError(f"{kind}: kernel differs from its plain version "
                           f"(max abs err {err}, {shape})")
    ms = time_ms(kernel, reps=reps)
    bound_ms, bound_by = sa_bound(kind, cells, nbytes)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_pairs=n_plain,
                bound_ms=bound_ms, bound_by=bound_by, cells=cells, shape=shape)


def ragged_codes(gen, rows, width):
    """int8 codes 0-4 (4 = N) on the card with PAD tails, PAD-masked
    stretches inside every third row and some all-PAD rows."""
    import torch

    from gfalign_torch.ops.seqalign import PAD

    codes = torch.randint(0, 5, (rows, width), generator=gen)
    col = torch.arange(width)[None, :]
    lens = torch.randint(0, width + 1, (rows,), generator=gen)
    codes = torch.where(col < lens[:, None], codes, PAD)
    lo = torch.randint(0, width, (rows,), generator=gen)
    hi = lo + torch.randint(0, width // 2 + 1, (rows,), generator=gen)
    masked = (col >= lo[:, None]) & (col < hi[:, None]) & (torch.arange(rows)[:, None] % 3 == 0)
    codes = torch.where(masked, PAD, codes)
    codes[::17] = PAD
    return codes.to(torch.int8).cuda()


def phase_seqalign_ragged(gen):
    import torch

    # K3 through the arena: random oriented "segments", paths of 1-6 steps
    # with overlap drops, tables padded with INT32_MAX as DevicePools pads
    n_paths, s_cap, lr, n_pairs = 96, 8, 256, 512
    arena = torch.randint(0, 5, (20000,), generator=gen).to(torch.int8)
    cum_off = torch.full((n_paths, s_cap), (1 << 31) - 1, dtype=torch.int32)
    base_ptr = torch.zeros((n_paths, s_cap), dtype=torch.int32)
    plen = torch.zeros((n_paths,), dtype=torch.int32)
    for p in range(n_paths):
        pos = 0
        for k in range(int(torch.randint(1, 7, (1,), generator=gen))):
            seg_len = int(torch.randint(20, 120, (1,), generator=gen))
            start = int(torch.randint(0, 20000 - 200, (1,), generator=gen))
            drop = int(torch.randint(0, 6, (1,), generator=gen)) if k else 0
            cum_off[p, k] = pos
            base_ptr[p, k] = start + drop - pos
            pos += seg_len - drop
        plen[p] = pos
    reads = ragged_codes(gen, 200, lr)
    pools = tuple(x.cuda() for x in (arena, cum_off, base_ptr, plen)) + (reads,)
    ridx = torch.randint(0, 200, (n_pairs,), generator=gen).int().cuda()
    pidx = torch.randint(0, n_paths, (n_pairs,), generator=gen).int().cuda()
    deltas = torch.randint(-40, lr, (n_pairs,), generator=gen).int().cuda()
    out = {}
    for width in (8, 16, 128, 512, 520, 1024, 2048):
        res = compare_seqalign("banded", pools + (ridx, pidx, deltas), width=width)
        out[f"banded_{width}"] = res
        log(f"phase 8 K3 ragged N={n_pairs} lr={lr} width={width} paths of 1-6 "
            f"steps: exact; {res['ms']:.3f} ms, plain {res['plain_ms']:.1f} ms")
    res = compare_seqalign("pairs", (ragged_codes(gen, 64, 300), ragged_codes(gen, 64, 700)))
    out["pairs"] = res
    log(f"phase 8 K4 ragged N=64 lr=300 lp=700: exact; {res['ms']:.3f} ms, "
        f"plain {res['plain_ms']:.1f} ms")
    res = compare_seqalign("pairs", (ragged_codes(gen, 3, 200), ragged_codes(gen, 3, 9000)))
    out["pairs_strips"] = res
    log(f"phase 8 K4 ragged N=3 lr=200 lp=9000 (a path over several blocks): exact; "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.1f} ms")
    res = compare_seqalign("cross", (ragged_codes(gen, 40, 200), ragged_codes(gen, 24, 300)))
    out["cross"] = res
    log(f"phase 8 K5 ragged R=40 P=24 lr=200 lp=300: exact; {res['ms']:.3f} ms, "
        f"plain {res['plain_ms']:.1f} ms")
    return out


def phase_seqalign_ultra_long():
    """Phase 8's K3 at ont_r10.align's shape (bench_seqalign
    K3_ULTRA_LONG_*): a read pool padded to 262,144 columns, reads of
    3-201.6 kb (three over 131,072 live rows: int64 keys, and the block
    kernel's strip sized by the launch's longest read), at bands 1,024 and
    2,048, bit-exact against the plain version on the same inputs, timed
    beside the bound."""
    from gfalign_torch.bench_seqalign import (K3_ULTRA_LONG_LR, K3_ULTRA_LONG_READS,
                                              ultra_long_banded_inputs)

    args = tuple(x.cuda() for x in ultra_long_banded_inputs())
    out = {}
    for width in (1024, 2048):
        res = compare_seqalign("banded", args, width=width)
        out[f"banded_{width}"] = res
        log(f"phase 8 K3 ultra-long N={res['shape']['N']} lr={K3_ULTRA_LONG_LR} "
            f"width={width} reads of {min(K3_ULTRA_LONG_READS)}-{max(K3_ULTRA_LONG_READS)} "
            f"bases: exact; {res['ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}), plain {res['plain_ms']:.0f} ms")
    return out


def phase_seqalign_synthetic():
    """K3, K4 and K5 at phase 10's shapes, synthesised without an align run
    (gfalign_torch/bench_seqalign.py): bit-exact on the first pairs, timed,
    with the first design's recorded times beside."""
    from gfalign_torch.bench_seqalign import K3_PAIRS, synthetic_shapes

    t0 = time.time()
    shapes = synthetic_shapes()
    log(f"phase 8 synthetic phase-10 shapes made in {time.time() - t0:.1f} s")
    out = {}
    k3 = tuple(x.cuda() for x in shapes["banded"])
    for width, n in K3_PAIRS.items():
        args = k3[:5] + tuple(x[:n].contiguous() for x in k3[5:])
        res = compare_seqalign("banded", args, width=width, plain_cut=48)
        out[f"banded_{width}"] = res
        log(f"phase 8 K3 synthetic width {width}: {res['shape']}; exact on the "
            f"first {res['plain_pairs']} pairs; {res['ms']:.3f} ms (one block a "
            f"pair, recorded: {OLD_LAYOUT_MS[f'k3_{width}']} ms), bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    res = compare_seqalign("pairs", tuple(x.cuda() for x in shapes["pairs"]))
    out["pairs"] = res
    log(f"phase 8 K4 synthetic: {res['shape']}; exact; {res['ms']:.3f} ms (one "
        f"block a pair, recorded: {OLD_LAYOUT_MS['k4']} ms), bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    res = compare_seqalign("cross", tuple(x.cuda() for x in shapes["cross"]),
                           plain_cut=64)
    out["cross"] = res
    log(f"phase 8 K5 synthetic: {res['shape']}; exact on the first "
        f"{res['plain_pairs']} reads; {res['ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return out


def phase_walk():
    """Phase 8b: the walk kernel (sa_walk, through seqalign.traceback on
    CUDA) against the native host walk (the same call on the CPU), on the
    small cases and the CLR-sized pairs of bench_seqalign, and its walk
    codes against the plain version's on the largest pair's first rows;
    timed at the CLR sizes.  Returns each CLR pair's readings and, under
    "faults", what differed: the largest difference of score, qstart,
    pstart, matches and nm, the ops that differ (the longer string's extra
    ops included) and the codes that differ (all 0, or the phase raises)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gfalign_torch.bench_seqalign import WALK_CASES, WALK_CLR, clr_pair, walk_case
    from gfalign_torch.ops import seqalign, seqalign_cuda

    dev = torch.device("cuda")
    faults = dict(max_abs_err=0, ops_differ=0, codes_differ=0, walks=0)

    def walk(read, path, ei, ej):
        """(placement, wall s on CUDA, wall s of the host walk); their
        differences go into `faults`."""
        before = dict(seqalign_cuda.LAUNCHES), dict(seqalign.TRACEBACK_CALLS)
        t0 = time.time()
        got = seqalign.traceback(read, path, ei, ej, dev)
        wall = time.time() - t0
        if (seqalign_cuda.LAUNCHES["walk"] != before[0]["walk"] + 1
                or seqalign.TRACEBACK_CALLS["cuda"] != before[1]["cuda"] + 1):
            raise RuntimeError("walk: not one walk launch for one walk on CUDA")
        t0 = time.time()
        want = seqalign.traceback(read, path, ei, ej)
        host = time.time() - t0
        fields = ("score", "qstart", "qend", "pstart", "pend", "matches", "nm")
        err = max(abs(getattr(got, f) - getattr(want, f)) for f in fields)
        ops = ["".join(op * n for n, op in pl.cigar) for pl in (got, want)]
        differ = (sum(a != b for a, b in zip(*ops))
                  + abs(len(ops[0]) - len(ops[1])))
        faults["max_abs_err"] = max(faults["max_abs_err"], err)
        faults["ops_differ"] += differ
        faults["walks"] += 1
        return got, wall, host

    t0 = time.time()
    for case in WALK_CASES:
        walk(*walk_case(case))
    log(f"phase 8b walk: {len(WALK_CASES)} small cases against the host walk in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(13)
    out = {}
    for name, (lr, lp, pad) in WALK_CLR.items():
        read, path = clr_pair(rng, lr, lp, pad)
        _, bi, bj = seqalign.batched_pair_scores(
            torch.from_numpy(read[None]).to(dev), torch.from_numpy(path[None]).to(dev))
        ei, ej = int(bi[0]), int(bj[0])
        pl, wall, host = walk(read, path, ei, ej)
        walls = [wall]
        for _ in range(2):
            t0 = time.time()
            seqalign.traceback(read, path, ei, ej, dev)
            walls.append(time.time() - t0)
        walls.sort()
        r_d = torch.from_numpy(read[:ei].copy()).to(dev)
        p_d = torch.from_numpy(path[:ej].copy()).to(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        run = lambda: seqalign_cuda._launch_walk(seqalign_cuda._lib(), r_d, p_d, stream)
        whole = lambda: seqalign_cuda._launch_walk(
            seqalign_cuda._lib(), r_d, p_d, stream, 1 << 40)
        ms = time_ms(run, reps=3)
        whole_ms = time_ms(whole, reps=3)
        if (seqalign_cuda.walk_result(whole()[0].cpu(), ei, ej)
                != seqalign_cuda.walk_result(run()[0].cpu(), ei, ej)):
            raise RuntimeError(f"walk {name}: one tile and row blocks differ")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by_kernel = {re.search(r"walk_\w+", e.key).group(0):
                     e.device_time_total / 1e3 / e.count
                     for e in prof.key_averages() if "walk_" in e.key}
        cells = ei * ej
        res = dict(rows=ei, cols=ej, cells=cells, score=pl.score,
                   qstart=pl.qstart, pstart=pl.pstart, ops=sum(n for n, _ in pl.cigar),
                   ms=ms, whole_ms=whole_ms, plan=seqalign_cuda.walk_plan(ei, ej)._asdict(),
                   kernels_ms=by_kernel, walk_ms=walls[1] * 1e3,
                   host_ms=host * 1e3, code_bytes=cells // 4,
                   bound_ms=cells * WALK_OPS_PER_CELL / INT32_ALU_OPS_PER_S * 1e3,
                   bound_by="operations",
                   layout=seqalign_cuda.walk_layout(ej))
        out[name] = res
        log(f"phase 8b walk {name}: {ei} x {ej} = {cells / 1e9:.3f} G cells, "
            f"score {pl.score}, {res['ops']} ops from ({pl.qstart}, {pl.pstart}); "
            f"kernel {ms:.3f} ms "
            f"({', '.join(f'{k} {v:.3f}' for k, v in by_kernel.items())}; "
            f"one tile {whole_ms:.3f} ms; recorded for one tile: 11.2 / 14.1 / 16.8 ms "
            f"at WALK_CLR), plan {res['plan']}, "
            f"as the align mode calls it {res['walk_ms']:.2f} ms, host walk "
            f"{res['host_ms']:.0f} ms, bound {res['bound_ms']:.4f} ms "
            f"({WALK_OPS_PER_CELL} ops a cell); (threads, blocks) {res['layout']}")
    # the plain version on the last (largest) pair's first rows, timed and
    # scaled, and its codes against the kernel's on those rows
    cut, last = 1000, out[name]
    t0 = time.time()
    _, plain = seqalign.walk_codes_ref(torch.from_numpy(read[:cut].copy()),
                                       torch.from_numpy(path[:last["cols"]].copy()))
    last["plain_ms"] = (time.time() - t0) * 1e3 * last["rows"] / cut
    _, codes = whole()
    band = codes.view(-1, last["rows"])[:, :cut].contiguous().cpu()
    got = seqalign_cuda.walk_codes(band, cut, last["cols"])
    faults["codes_differ"] = int((got != plain.numpy()[1:, 1:]).sum())
    faults["codes_compared"] = got.size
    log(f"phase 8b walk plain version: {last['plain_ms']:.0f} ms at {name} "
        f"(its first {cut} rows, scaled); its codes on those rows against the "
        f"kernel's: {faults['codes_differ']} of {got.size} differ")
    log(f"phase 8b walk against the host walk: {faults['walks']} walks, largest "
        f"difference of score, ends, matches and nm {faults['max_abs_err']}, "
        f"{faults['ops_differ']} ops differ")
    if faults["max_abs_err"] or faults["ops_differ"] or faults["codes_differ"]:
        raise RuntimeError(f"walk: the kernel differs from the host walk or the "
                           f"plain version: {faults}")
    out["faults"] = faults
    out["ultra_long"] = phase_walk_ultra_long()
    return out


def phase_walk_ultra_long(rows=300_000, cols=600_000):
    """Phase 8b's largest walk: a read of `rows` bases at 99% (sub 0.3%,
    ins 0.2%, del 0.5%) from the last `rows` bases of a path of `cols`, so
    that K4's best cell lies near the corner; the walk of that rectangle
    without a cut, its score against K4's best and its peak device memory
    above the inputs' (at most 1 GiB), timed on the host clock."""
    import numpy as np
    import torch

    from gfalign_torch.bench_seqalign import _mutated_indels
    from gfalign_torch.ops import seqalign, seqalign_cuda
    from gfalign_torch.utils import profiling

    dev = torch.device("cuda")
    rng = np.random.default_rng(300)
    path = rng.integers(0, 4, cols).astype(np.int8)
    read = _mutated_indels(rng, path[cols - rows:], 0.003, 0.002, 0.005)
    read = read[:rows].astype(np.int8)
    r_d = torch.from_numpy(read).to(dev)
    p_d = torch.from_numpy(path).to(dev)
    t0 = time.time()
    best, bi, bj = (int(x[0]) for x in seqalign.batched_pair_scores(r_d[None], p_d[None]))
    k4_s = time.time() - t0
    r_w, p_w = r_d[:bi].contiguous(), p_d[:bj].contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = profiling.snapshot()
    t0 = time.time()
    score, qstart, pstart, matches, nm, ops = seqalign_cuda.full_walk_cuda(r_w, p_w)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = profiling.since(before)["counts"]
    res = dict(rows=bi, cols=bj, cells=bi * bj, k4_best=best, score=score,
               qstart=qstart, pstart=pstart, ops=len(ops), walk_s=wall, k4_s=k4_s,
               peak_bytes=peak, plan=seqalign_cuda.walk_plan(bi, bj)._asdict(),
               counts={k: v for k, v in counts.items() if "walk" in k})
    log(f"phase 8b walk {bi} x {bj} = {bi * bj / 1e9:.1f} G cells (no cut): score "
        f"{score} (K4's best {best}), {len(ops)} ops from ({qstart}, {pstart}), "
        f"{wall:.2f} s (K4 {k4_s:.2f} s), peak device memory {peak / 2 ** 20:.1f} MiB "
        f"above the inputs, plan {res['plan']}, counters {res['counts']}")
    if score != best or peak > 1 << 30:
        raise RuntimeError(f"walk 300 k x 600 k: score {score} against K4's {best}, "
                           f"peak {peak} bytes")
    return res


# The banded walk's bound counts 8 int32 operations a band cell (rows x
# width), as the walk's does (WALK_OPS_PER_CELL).
BANDTRACE_OPS_PER_CELL = 8


def phase_bandtrace():
    """Phase 8c: the banded walk kernel (sa_bandtrace, through
    seqalign_cuda.banded_walks_cuda) against the native host walk, at
    clr.align's and ont_r10.align's walk shapes (see the module's
    docstring), timed; the plain version on the first rows of the longest
    walk, timed and scaled, its codes there against the kernel's, and its
    walk of the first CLR walk against the kernel's.  Returns each shape's
    readings and, under "faults", what differed: the largest difference of
    score, qstart, pstart, matches and nm, the ops and the declines that
    differ (against the host walk and the plain walk) and the codes that
    differ (all 0, or the phase raises)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gfalign_torch.bench_seqalign import clr_band_walks, ultra_long_band_walks
    from gfalign_torch.io import native
    from gfalign_torch.ops import seqalign, seqalign_cuda

    dev = torch.device("cuda")
    sa = (seqalign.MATCH, seqalign.MISMATCH, seqalign.GAP, seqalign.PAD,
          seqalign._BLOCK)
    clr512 = clr_band_walks(144, 512, dev)
    ul = {width: ultra_long_band_walks(width, dev) for width in (1024, 2048)}
    shapes = {"clr w512 x1": clr512[:1], "clr w512 x16": clr512[:16],
              "clr w512 x144": clr512,
              "clr w1024 x16": clr_band_walks(16, 1024, dev, seed=16),
              "ont_r10 w1024 x6": ul[1024], "ont_r10 w2048 x6": ul[2048],
              "ont_r10 w2048 201.6 kb alone": ul[2048][:1]}
    faults = dict(max_abs_err=0, ops_differ=0, declines_differ=0, walks=0)

    def compare(got, want):
        """Count where the kernel's walks `got` differ from `want`."""
        for g, w in zip(got, want):
            faults["walks"] += 1
            if (g is None) != (w is None):
                faults["declines_differ"] += 1
            elif g is not None:
                faults["max_abs_err"] = max(faults["max_abs_err"],
                                            *(abs(a - b) for a, b in zip(g[:5], w[:5])))
                faults["ops_differ"] += (sum(a != b for a, b in zip(g[5], w[5]))
                                         + abs(len(g[5]) - len(w[5])))

    out = {}
    for name, walks in shapes.items():
        got = seqalign_cuda.banded_walks_cuda(walks, dev)     # warm
        walls = []
        for _ in range(3):
            before = seqalign_cuda.LAUNCHES["bandtrace"]
            t0 = time.time()
            seqalign_cuda.banded_walks_cuda(walks, dev)
            walls.append(time.time() - t0)
            launches = seqalign_cuda.LAUNCHES["bandtrace"] - before
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            seqalign_cuda.banded_walks_cuda(walks, dev)
            torch.cuda.synchronize()
        kernels = {re.search(r"bandtrace_\w+", e.key).group(0): e.device_time_total / 1e3
                   for e in prof.key_averages() if "bandtrace_" in e.key}
        # where the profiler shows no bandtrace kernel, the call's own device
        # time (upload, kernels, copy back) by CUDA events stands in for them
        events_ms = time_ms(lambda: seqalign_cuda.banded_walks_cuda(walks, dev),
                            warmup=0, reps=3)
        t0 = time.time()
        want = [native.banded_local_traceback(*w, *sa) for w in walks]
        host = time.time() - t0
        compare(got, want)
        cells = sum(w[2] * w[5] for w in walks)
        res = dict(walks=len(walks), launches=launches,
                   longest_rows=max(w[2] for w in walks), cells=cells,
                   declined=sum(g is None for g in got),
                   wall_ms=sorted(walls)[1] * 1e3, kernels_ms=kernels,
                   events_ms=events_ms, ms=sum(kernels.values()) if kernels else events_ms,
                   ms_by="profiler" if kernels else "cuda events", host_ms=host * 1e3,
                   bound_ms=cells * BANDTRACE_OPS_PER_CELL / INT32_ALU_OPS_PER_S * 1e3,
                   bound_by="operations")
        out[name] = res
        log(f"phase 8c bandtrace {name}: {res['walks']} walks ({res['declined']} "
            f"declined) in {launches} launch(es), rows up to {res['longest_rows']}, "
            f"{cells / 1e9:.3f} G band cells; kernels "
            f"{res['ms']:.2f} ms by {res['ms_by']} "
            f"({', '.join(f'{k} {v:.2f}' for k, v in kernels.items())}; the call by "
            f"CUDA events {events_ms:.2f} ms), "
            f"as the align mode calls it {res['wall_ms']:.2f} ms, host walks "
            f"{res['host_ms']:.0f} ms, bound {res['bound_ms']:.4f} ms "
            f"({BANDTRACE_OPS_PER_CELL} ops a band cell)")
    host_faults = dict(faults)
    # the plain version on the longest walk's first rows, timed and scaled,
    # and its codes on those rows against the kernel's
    walk = ul[2048][0]
    read, path, ei, ej, delta, width, _ = walk
    cut = 1000
    t0 = time.time()
    _, plain = seqalign.band_codes_ref(torch.from_numpy(read[:cut].copy()),
                                       torch.from_numpy(path[:ej].copy()), delta, width)
    out["plain_ms"] = (time.time() - t0) * 1e3 * ei / cut
    job = seqalign_cuda._BandJob(*walk, seqalign.band_end(len(read), len(path), ei, ej,
                                                          delta, width),
                                 *seqalign_cuda.bandtrace_layout(width))
    _, codes, first = seqalign_cuda._launch_bandtrace(
        seqalign_cuda._lib(), [job], dev, torch.cuda.current_stream(dev).cuda_stream)
    got = seqalign_cuda.band_codes(codes, int(first[0]), cut, width)
    faults["codes_differ"] = int((got != plain.numpy()[1:]).sum())
    faults["codes_compared"] = got.size
    del codes
    # the plain walk of the first CLR walk against the kernel's
    walks = shapes["clr w512 x1"]
    compare(seqalign_cuda.banded_walks_cuda(walks, dev),
            [seqalign.banded_walk_ref(*w) for w in walks])
    plain_faults = {k: faults[k] - host_faults[k] for k in ("ops_differ", "declines_differ")}
    log(f"phase 8c bandtrace plain version: {out['plain_ms']:.0f} ms at the "
        f"201.6 kb walk (its first {cut} rows, scaled); its codes on those rows "
        f"against the kernel's: {faults['codes_differ']} of {got.size} differ; "
        f"its walk of clr w512 x1 against the kernel's: ops differ "
        f"{plain_faults['ops_differ']}, declines differ {plain_faults['declines_differ']}")
    log(f"phase 8c bandtrace against the host and plain walks: {faults['walks']} walks, "
        f"largest difference of score, ends, matches and nm {faults['max_abs_err']}, "
        f"{faults['ops_differ']} ops and {faults['declines_differ']} declines differ")
    if (faults["max_abs_err"] or faults["ops_differ"] or faults["declines_differ"]
            or faults["codes_differ"]):
        raise RuntimeError(f"bandtrace: the kernel differs from the host walk or the "
                           f"plain version: {faults}")
    out["faults"] = faults
    return out


class AlignRecorder:
    """Wraps the align scorers' entry points for one run: keeps the inputs
    of the largest call of each kind (for phase 10) and CUDA events around
    every call, whose sum is the device's busy time in the scorers."""

    def __init__(self):
        self.largest = {}
        self.events = []
        self.calls = {"banded": 0, "pairs": 0, "cross": 0}

    def _wrap(self, kind, fn, size, key):
        import torch

        def wrapped(*args, **kw):
            n = size(args)
            slot = (kind, key(args, kw))
            if n > self.largest.get(slot, (0,))[0]:
                self.largest[slot] = (n, tuple(args))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            self.calls[kind] += 1
            return out
        return wrapped

    @contextlib.contextmanager
    def installed(self):
        from gfalign_torch.ops import seqalign

        saved = {name: getattr(seqalign, name) for name in
                 ("banded_arena_scores", "batched_pair_scores", "batched_local_scores")}
        seqalign.banded_arena_scores = self._wrap(
            "banded", saved["banded_arena_scores"], lambda a: len(a[5]),
            lambda a, kw: kw.get("width", 128))
        seqalign.batched_pair_scores = self._wrap(
            "pairs", saved["batched_pair_scores"],
            lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1], lambda a, kw: 0)
        seqalign.batched_local_scores = self._wrap(
            "cross", saved["batched_local_scores"],
            lambda a: a[0].shape[0] * a[1].shape[0], lambda a, kw: 0)
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(seqalign, name, fn)

    def device_ms(self):
        return sum(s.elapsed_time(e) for s, e in self.events)


def run_align(name, runs, golden, workdir, tag="device", device=None):
    """One `align` run through the CLI against its golden GAF, on CUDA (the
    device ladder) unless `device` is "cpu" (the host ladder); `tag` names
    the output."""
    import torch

    from gfalign_torch.cli.main import main
    from gfalign_torch.engine import graph_align
    from gfalign_torch.ops import seqalign, seqalign_cuda
    from gfalign_torch.utils import profiling

    gfa, reads, preset = runs[name]
    for path in (gfa, reads):
        key = pathlib.Path(path).name
        if digest(pathlib.Path(path).read_bytes()) != golden[key]:
            raise RuntimeError(f"{key} differs from the recorded input")
    out_gaf = pathlib.Path(workdir) / f"{name}.{tag}.gaf"
    for k in seqalign_cuda.LAUNCHES:
        seqalign_cuda.LAUNCHES[k] = 0
    for k in graph_align.PHASE_SECONDS:
        graph_align.PHASE_SECONDS[k] = 0.0
    for k in seqalign.TRACEBACK_CALLS:
        seqalign.TRACEBACK_CALLS[k] = 0
    walks = profiling.snapshot()
    rec = AlignRecorder()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with rec.installed(), contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(["align", "-f", gfa, "-r", reads, "-o", str(out_gaf), "-p", preset],
                  device=device)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(seqalign_cuda.LAUNCHES)
    tracebacks = dict(seqalign.TRACEBACK_CALLS)
    walks = profiling.since(walks)["counts"]
    if rc != 0:
        raise RuntimeError(f"align ({name}) exited {rc}: {err.getvalue()[-400:]}")
    # on the card banded walks on the banded walk kernel, in waves, and full
    # walks on the walk kernel (the exhaustive engine walks every placement
    # in full); on the CPU (the host ladder) banded walks native
    banded = walks.get("align.traceback.banded_walks", 0)
    full = walks.get("align.traceback.full_walks", 0)
    if device == "cpu":
        wrong = (tracebacks["native"] != banded or tracebacks["cuda"]
                 or tracebacks["banded_cuda"] or full or banded == 0)
    else:
        wrong = (tracebacks["native"] or tracebacks["banded_cuda"] != banded
                 or (launches["bandtrace"] > 0) != (banded > 0)
                 or tracebacks["cuda"] != launches["walk"]
                 or (name != "exhaustive" and tracebacks["cuda"] != full)
                 or tracebacks["banded_cuda"] + tracebacks["cuda"] == 0)
    if tracebacks["python"] or wrong:
        raise RuntimeError(f"align ({name}) tracebacks {tracebacks}, launches "
                           f"{launches}, banded {banded}, full {full}: banded walks "
                           f"must be on the banded walk kernel and full ones on "
                           f"the walk kernel (native on the CPU)")
    if not buf.getvalue().startswith(f"Invoking: gfalign-tpu-align -p {preset} "):
        raise RuntimeError(f"align ({name}) did not echo its invocation")
    got = digest(out_gaf.read_bytes())
    if got != golden[f"{name}.gaf"]:
        keep = ROOT / "chiprun_out"
        keep.mkdir(exist_ok=True)
        (keep / out_gaf.name).write_bytes(out_gaf.read_bytes())
        raise RuntimeError(f"align ({name}) GAF {got} differs from the golden "
                           f"{golden[name + '.gaf']} (kept in chiprun_out/)")
    n_reads = golden[pathlib.Path(reads).name][1] // 2
    res = dict(seconds=secs, reads=n_reads, records=got[1], launches=launches,
               reads_per_s=n_reads / secs, device_ms=rec.device_ms(),
               phase_seconds=dict(graph_align.PHASE_SECONDS), calls=rec.calls,
               tracebacks=tracebacks)
    return res, rec


def phase_align(workdir, wl):
    from tests.test_torch_goldens import ALIGN_SEEDED_READS, port_align_workloads

    t0 = time.time()
    golden = read_goldens("torch_slice_align_seed0.md5")
    runs = port_align_workloads(wl, pathlib.Path(workdir) / "align")
    log(f"phase 9 inputs: three align workloads written in {time.time() - t0:.1f} s")
    out, recs = {}, {}
    for name, kernel in (("seeded", "banded"), ("band_edge", "pairs"),
                         ("exhaustive", "cross")):
        res, rec = run_align(name, runs, golden, workdir)
        out[name], recs[name] = res, rec
        ph = res["phase_seconds"]
        other = res["seconds"] - sum(ph.values())
        log(f"phase 9 align {name}: golden md5 and {res['records']} records, "
            f"{res['reads']} reads in {res['seconds']:.2f} s "
            f"({res['reads_per_s']:.2f} reads/s); seeding + candidates "
            f"{ph['seeding']:.2f} s, scoring {ph['scoring']:.2f} s, tracebacks "
            f"{ph['traceback']:.2f} s, other {other:.2f} s; device busy in the "
            f"scorers {res['device_ms']:.1f} ms (idle share "
            f"{1 - res['device_ms'] / 1e3 / res['seconds']:.4f}); launches "
            f"{res['launches']}; tracebacks {res['tracebacks']}")
        if res["launches"][kernel] == 0:
            raise RuntimeError(f"align ({name}) did not launch {KERNELS[kernel]['name']}")
    if out["seeded"]["reads"] != ALIGN_SEEDED_READS:
        raise RuntimeError("the seeded run's read count differs from the golden's")
    if out["seeded"]["seconds"] > ALIGN_MAX_SECONDS:
        log(f"phase 9 WARNING: the seeded align took {out['seeded']['seconds']:.0f} s, "
            f"over its {ALIGN_MAX_SECONDS} s share of the script's limit: cut "
            f"ALIGN_SEEDED_READS (tests/test_torch_goldens.py) and remake the golden")
    return out, recs


def phase_seqalign_main_shapes(recs):
    """K3 at the seeded run's largest chunk per band width, K4 at the
    largest bucket launched in any run, K5 at the exhaustive run's call."""
    def largest(kind, key=None):
        best = None
        for rec in recs.values():
            for (k, kk), (n, args) in rec.largest.items():
                if k == kind and (key is None or kk == key) and (best is None or n > best[0]):
                    best = (n, args)
        if best is None:
            raise RuntimeError(f"no {kind} call was recorded (key {key})")
        return best[1]

    import torch

    out = {}
    for width in (128, 512):
        args = largest("banded", width)
        # the pools as the run left them; the chunk's indices as it sent them
        args = tuple(args[:5]) + tuple(torch.as_tensor(x).int().cuda()
                                       for x in args[5:8])
        res = compare_seqalign("banded", args, width=width, plain_cut=256)
        out[f"banded_{width}"] = res
        log(f"phase 10 K3 at the seeded run's largest chunk, width {width}: "
            f"{res['shape']}; exact on the first {res['plain_pairs']} pairs; "
            f"{res['ms']:.3f} ms (one block a pair, recorded: "
            f"{OLD_LAYOUT_MS[f'k3_{width}']} ms), plain {res['plain_ms']:.1f} ms (timed on "
            f"{res['plain_pairs']} pairs, scaled), bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']})")
    res = compare_seqalign("pairs", largest("pairs"))
    out["pairs"] = res
    log(f"phase 10 K4 at the largest bucket launched: {res['shape']}; exact; "
        f"{res['ms']:.3f} ms (one block a pair, recorded: {OLD_LAYOUT_MS['k4']} "
        f"ms), plain {res['plain_ms']:.1f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    res = compare_seqalign("cross", largest("cross"), plain_cut=64)
    out["cross"] = res
    log(f"phase 10 K5 at the exhaustive run's call: {res['shape']}; exact on the "
        f"first {res['plain_pairs']} reads; {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.1f} ms (timed on {res['plain_pairs']} reads, scaled), "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phases 12-14: the host ladder, the trace, the dry run
# ---------------------------------------------------------------------------

DRYRUN_RANKS = 4


def ensure_align_inputs(workdir, wl, phase):
    """The align workloads of phase 9, {name: (gfa, reads, preset)}: those
    phase 9 wrote, or written here when it did not run (run_align checks
    each input's md5)."""
    from tests.test_torch_goldens import port_align_workloads

    d = pathlib.Path(workdir) / "align"
    if (d / "seeded.fa").exists():
        return {name: (str(d / f"{name}.gfa"), str(d / f"{name}.fa"), "hifi")
                for name in ("seeded", "band_edge", "exhaustive")}
    t0 = time.time()
    runs = port_align_workloads(wl, d)
    log(f"phase {phase} inputs: align workloads written in {time.time() - t0:.1f} s")
    return runs


def phase_host_ladder(workdir, wl, device_runs=None):
    """Phase 12: `align -p hifi` on the CPU device, whose ladder is the
    native host ladder (the JAX package's default engine), over the seeded
    run's 10,000 reads and the band-edge run, each GAF against the host
    golden, beside phase 9's device ladder (K3) on the same reads."""
    from gfalign_torch.engine import graph_align
    from tests.test_torch_goldens import ALIGN_HOST_RUNS

    runs = ensure_align_inputs(workdir, wl, 12)
    golden = read_goldens("torch_slice_align_host_seed0.md5")
    out = {}
    for name in ALIGN_HOST_RUNS:
        for k in graph_align.HOST_LADDER:
            graph_align.HOST_LADDER[k] = 0
        res, _ = run_align(name, runs, golden, workdir, tag="host", device="cpu")
        res["host_ladder"] = dict(graph_align.HOST_LADDER)
        out[name] = res
        if any(res["launches"].values()) or not res["host_ladder"]["rungs"]:
            raise RuntimeError(f"host-ladder align ({name}) launched "
                               f"{res['launches']} over "
                               f"{res['host_ladder']['rungs']} host rungs")
    for name, res in out.items():
        ph, hl = res["phase_seconds"], res["host_ladder"]
        rate = hl["cells"] / ph["scoring"] / 1e9 if ph["scoring"] else 0.0
        log(f"phase 12 align {name}, host ladder: golden md5 and {res['records']} "
            f"records, {res['reads']} reads in {res['seconds']:.2f} s; seeding + "
            f"candidates {ph['seeding']:.2f} s, scoring {ph['scoring']:.2f} s "
            f"({hl['rungs']} rungs, {hl['pairs']} pairs, {hl['cells'] / 1e9:.2f} G banded "
            f"cells, {rate:.2f} Gcell/s), tracebacks {ph['traceback']:.2f} s; "
            f"launches {res['launches']}; tracebacks {res['tracebacks']}")
        dev = (device_runs or {}).get(name)
        if dev:
            dph = dev["phase_seconds"]
            log(f"phase 12 align {name}, device ladder (phase 9, same reads): "
                f"{dev['seconds']:.2f} s; seeding + candidates {dph['seeding']:.2f} s, "
                f"scoring {dph['scoring']:.2f} s (K3 launches {dev['launches']['banded']}, "
                f"K4 {dev['launches']['pairs']}), tracebacks {dph['traceback']:.2f} s; "
                f"tracebacks {dev['tracebacks']}")
    return out


def phase_trace(workdir, wl, paths=None):
    """Phase 13: the CLI search on the post-filter reads (R = 249) without
    and then with GFALIGN_TORCH_TRACE: both outputs golden-equal, the trace
    parses as JSON, and its nw_fwd_packed kernel events are exactly the K1
    launches the wrapper counted over the traced run."""
    import os

    work = pathlib.Path(workdir)
    if paths is None:
        paths = write_inputs(workdir, wl, phase="13")
    filtered = work / "filtered.gaf"
    if not filtered.exists():
        write_filtered(work, wl, paths)
    golden = read_goldens()["search_filtered.out"]
    argv = ["search", "-f", paths["gfa"], "-g", str(filtered), "-n",
            paths["search_nodelist"], "-s", "498", "-d", "503"]
    plain, plain_s, plain_launches = run_main(argv)
    trace_dir = work / "trace"
    os.environ["GFALIGN_TORCH_TRACE"] = str(trace_dir)
    try:
        traced, traced_s, launches = run_main(argv)
    finally:
        del os.environ["GFALIGN_TORCH_TRACE"]
    for what, out in (("untraced", plain), ("traced", traced)):
        if digest(out) != golden:
            raise RuntimeError(f"phase 13 {what} search differs from the golden")
    path = trace_dir / f"gfalign_torch.{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "nw_fwd_packed" in e.get("name", "")]
    if len(k1) != launches["packed"] or not k1:
        raise RuntimeError(f"phase 13: the trace holds {len(k1)} nw_fwd_packed events, "
                           f"the K1 counter {launches['packed']}")
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    res = dict(untraced_s=plain_s, traced_s=traced_s, k1_launches=launches["packed"],
               untraced_k1_launches=plain_launches["packed"], k1_events=len(k1),
               k1_ms=sum(e.get("dur", 0) for e in k1) / 1e3, kernel_events=len(kernels),
               kernel_ms=busy_ms, events=len(events), trace_mb=path.stat().st_size / 2**20)
    log(f"phase 13 traced CLI search on the post-filter reads: golden-equal with and "
        f"without the trace, {plain_s:.2f} s untraced, {traced_s:.2f} s traced; trace "
        f"{res['trace_mb']:.1f} MiB, {len(events)} events, {len(kernels)} kernels "
        f"({busy_ms:.1f} ms, idle share {1 - busy_ms / 1e3 / traced_s:.4f}); "
        f"nw_fwd_packed events {len(k1)} = K1 launches {launches['packed']} "
        f"({res['k1_ms']:.1f} ms)")
    return res


def phase_dryrun():
    """Phase 14: gfalign_torch.dryrun.dryrun_multichip(DRYRUN_RANKS) on the
    card: every rank on cuda:0, the two-axis step on the default grid, the
    frontier-sharded full-scale search on every rank and the align on
    min(DRYRUN_RANKS, 4) ranks, each against one process (the dry run
    raises on any difference, and on a rank that launched no K1, or no K3
    in the align)."""
    from gfalign_torch.dryrun import dryrun_multichip

    res = dryrun_multichip(DRYRUN_RANKS)
    log(f"phase 14 dryrun_multichip({DRYRUN_RANKS}) passed in {res['seconds']:.1f} s: "
        f"grid {res['grid']}, search ranks on "
        f"{sorted({r['device'] for r in res['search_ranks']})}, K1 launches "
        f"{[r['search_k1'] for r in res['search_ranks']]}, align K3 launches "
        f"{[r['align_launches']['banded'] for r in res['align_ranks']]}")
    return res


# ---------------------------------------------------------------------------
# phase 11: two ranks on the one card
# ---------------------------------------------------------------------------

DIST_RANKS = 2
DIST_SECONDS = 420      # deadline of the rank workers' spawn (all runs a-d)
DIST_CLI_SECONDS = 180  # deadline of the CLI's spawn (run e)

# Run e: `python -m gfalign_torch ...` itself (runpy, the arguments after
# -c), then the process's K1/K2 launch counts on a line of stderr.
CLI_COUNTING = """
import json, runpy, sys
from gfalign_torch.ops import nw_cuda
code = 0
try:
    runpy.run_module("gfalign_torch", run_name="__main__", alter_sys=True)
except SystemExit as exc:
    code = exc.code
sys.stdout.flush()
print("LAUNCHES " + json.dumps(dict(nw_cuda.LAUNCHES)), file=sys.stderr, flush=True)
raise SystemExit(code)
"""


def spawn_ranks(argv, workdir, name, timeout, env=None):
    """Run DIST_RANKS processes of `python3 argv...` from the repository
    root as torchrun would (parallel/dist.launch_local), with PYTHONPATH
    at the root; returns their stdouts and stderrs.  A rank that exits
    non-zero fails the phase, and when the deadline passes every rank is
    killed and the phase fails."""
    from gfalign_torch.parallel import dist

    logs = pathlib.Path(workdir) / name
    logs.mkdir(exist_ok=True)
    try:
        got = dist.launch_local(argv, DIST_RANKS, timeout, logs, cwd=ROOT,
                                env={"PYTHONPATH": str(ROOT), **(env or {})})
    except RuntimeError as exc:
        raise RuntimeError(f"phase 11 {name}: {exc}") from exc
    bad = [(rank, rc) for rank, (rc, _, _) in enumerate(got) if rc != 0]
    if bad:
        raise RuntimeError(f"phase 11 {name}: ranks exited {bad}; stderr tails "
                           f"{[err[-1500:] for _, _, err in got]}")
    return [out for _, out, _ in got], [err for _, _, err in got]


def rank_run_search(graph, aln, nodes, device, evaluate_fn, use_native):
    """One search on this rank with the launch counters zeroed: (stdout
    bytes, wall seconds, K1 launches)."""
    import torch

    from gfalign_torch.engine.search import search
    from gfalign_torch.ops import nw_cuda

    for k in nw_cuda.LAUNCHES:
        nw_cuda.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    search(graph, aln, nodes, "498", "503", out=buf, device=device,
           evaluate_fn=evaluate_fn, use_native=use_native)
    torch.cuda.synchronize()
    return buf.getvalue().encode(), time.perf_counter() - t0, nw_cuda.LAUNCHES["packed"]


def rank_worker(spec_path):
    """One rank of phase 11 (`chip_smoke.py --rank-worker spec.json`, spawned
    by phase_distributed): runs (a)-(d) on this rank's device and checks
    every output and launch count, raising on the first difference;
    writes its numbers to <spec out>.rank<r>.json."""
    import torch

    sys.path.insert(0, str(ROOT))
    from gfalign_torch.cli.main import main as cli_main
    from gfalign_torch.engine import graph_align
    from gfalign_torch.engine.alignments import AlignmentSet
    from gfalign_torch.engine.evaluate import (distributed_evaluator,
                                               frontier_sharded_evaluator)
    from gfalign_torch.io.gfa import read_gfa
    from gfalign_torch.ops import seqalign, seqalign_cuda
    from gfalign_torch.parallel import dist

    spec = json.loads(pathlib.Path(spec_path).read_text())
    dist.init_if_requested()
    pid, count = dist.process_info()
    if count != DIST_RANKS:
        raise RuntimeError(f"rank worker: {count} processes, want {DIST_RANKS}")
    device = dist.rank_device("cuda")
    if device.type != "cuda":
        raise RuntimeError(f"rank {pid} scores on {device}")
    res = dict(rank=pid, device=str(device), card=torch.cuda.get_device_name(device))
    graph = read_gfa(spec["gfa"])

    # (a) the full-scale search, reads sharded by qname, Python driver + K1
    aln = AlignmentSet()
    aln.load(spec["gaf"], shard=(pid, count), shard_by="qname")
    out, wall, k1 = rank_run_search(graph, aln, spec["nodes"], device,
                                    distributed_evaluator(), False)
    if out != pathlib.Path(spec["search_golden"]).read_bytes():
        raise RuntimeError(f"rank {pid}: read-sharded search differs from the golden")
    if k1 == 0:
        raise RuntimeError(f"rank {pid}: read-sharded search launched no K1")
    res["search"] = dict(reads=aln.count, wall_s=wall, k1_launches=k1)

    # (b) the post-filter search, frontier sharded, both drivers
    aln = AlignmentSet()
    aln.load(spec["filtered"])
    res["filtered"] = []
    for use_native in (False, True):
        out, wall, k1 = rank_run_search(graph, aln, spec["nodes"], device,
                                        frontier_sharded_evaluator(), use_native)
        driver = "native" if use_native else "python"
        if digest(out) != tuple(spec["filtered_golden"]):
            raise RuntimeError(f"rank {pid}: post-filter search ({driver} driver) "
                               f"differs from the golden")
        if (k1 > 0) == use_native:
            raise RuntimeError(f"rank {pid}: post-filter search ({driver} driver) "
                               f"launched K1 {k1} times")
        res["filtered"].append(dict(driver=driver, reads=aln.count, wall_s=wall,
                                    k1_launches=k1))

    # (d) evalGFA statistics with duplicate marking, through the CLI's main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["evalGFA", "-g", spec["gaf"]])
    wall = time.perf_counter() - t0
    got = digest(buf.getvalue().encode())
    want = tuple(spec["evalgfa_digest"]) if pid == 0 else digest(b"")
    if rc != 0 or got != want:
        raise RuntimeError(f"rank {pid}: evalGFA printed {got}, want {want}")
    res["evalgfa"] = dict(wall_s=wall)

    # (c) the seeded align of all reads, reads sharded by index, K3
    for k in seqalign_cuda.LAUNCHES:
        seqalign_cuda.LAUNCHES[k] = 0
    for k in graph_align.PHASE_SECONDS:
        graph_align.PHASE_SECONDS[k] = 0.0
    for k in seqalign.TRACEBACK_CALLS:
        seqalign.TRACEBACK_CALLS[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["align", "-f", spec["align_gfa"], "-r", spec["align_reads"],
                       "-o", spec["align_out"], "-p", "hifi"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(seqalign_cuda.LAUNCHES)
    tracebacks = dict(seqalign.TRACEBACK_CALLS)
    if rc != 0:
        raise RuntimeError(f"rank {pid}: align exited {rc}")
    if launches["banded"] == 0:
        raise RuntimeError(f"rank {pid}: align launched no K3")
    if (tracebacks["python"] or tracebacks["native"]
            or not tracebacks["banded_cuda"] or not launches["bandtrace"]):
        raise RuntimeError(f"rank {pid}: align tracebacks {tracebacks}, "
                           f"launches {launches}")
    if pid == 0:                       # rank 0 wrote the gathered GAF
        got = digest(pathlib.Path(spec["align_out"]).read_bytes())
        if got != tuple(spec["align_golden"]):
            raise RuntimeError(f"distributed align GAF {got} differs from the golden "
                               f"{spec['align_golden']}")
    res["align"] = dict(wall_s=wall, launches=launches, tracebacks=tracebacks,
                        phase_seconds=dict(graph_align.PHASE_SECONDS))
    pathlib.Path(f"{spec['out']}.rank{pid}.json").write_text(json.dumps(res))
    print(json.dumps(res), flush=True)
    return 0


def phase_distributed(workdir, wl, paths=None, single_align_s=None):
    """Phase 11: DIST_RANKS rank processes on the one card, over gloo and
    /dev/shm (a-d in one spawn of rank_worker, e through the CLI):
    (a) the full-scale search with reads sharded, Python driver + K1;
    (b) the post-filter search (R = 249) with the frontier sharded, by the
    Python driver + K1 and by the C++ driver over the ring; (c) the seeded
    align of all reads with reads sharded, K3; (d) evalGFA statistics with
    duplicate marking; (e) `python -m gfalign_torch search` on the
    post-filter reads.  Every output against its golden (or, for d, the
    one-process run's bytes)."""
    from tests.test_torch_goldens import port_align_workloads

    work = pathlib.Path(workdir)
    if paths is None:
        paths = write_inputs(workdir, wl, phase="11")
    filtered = work / "filtered.gaf"
    if not filtered.exists():
        write_filtered(work, wl, paths)
    align_dir = work / "align"
    if not (align_dir / "seeded.fa").exists():
        t0 = time.time()
        port_align_workloads(wl, align_dir)
        log(f"phase 11 inputs: align workloads written in {time.time() - t0:.1f} s")
    evalgfa, evalgfa_s, _ = run_main(["evalGFA", "-g", paths["gaf"]])
    golden = read_goldens()
    align_golden = read_goldens("torch_slice_align_seed0.md5")
    spec = dict(gfa=paths["gfa"], gaf=paths["gaf"], nodes=paths["search_nodelist"],
                filtered=str(filtered), search_golden=str(ROOT / "tests/data/torch_slice_search_seed0.out"),
                filtered_golden=golden["search_filtered.out"],
                evalgfa_digest=digest(evalgfa), align_gfa=str(align_dir / "seeded.gfa"),
                align_reads=str(align_dir / "seeded.fa"),
                align_out=str(work / "seeded.dist.gaf"),
                align_golden=align_golden["seeded.gaf"], out=str(work / "phase11"))
    spec_path = work / "phase11.json"
    spec_path.write_text(json.dumps(spec))
    t0 = time.time()
    _, errs = spawn_ranks([str(ROOT / "chip_smoke.py"), "--rank-worker", str(spec_path)],
                          workdir, "worker", DIST_SECONDS)
    worker_s = time.time() - t0
    ranks = [json.loads(pathlib.Path(f"{spec['out']}.rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    notes = sorted({line.split("] ", 1)[-1] for e in errs for line in e.splitlines()
                    if "allreduce over" in line})
    log(f"phase 11 {DIST_RANKS} ranks on {ranks[0]['card']} ({', '.join(r['device'] for r in ranks)}), "
        f"runs a-d in {worker_s:.1f} s with start-up; {'; '.join(notes)}")
    for r in ranks:
        a, b, c = r["search"], r["filtered"], r["align"]
        ph = c["phase_seconds"]
        log(f"phase 11 rank {r['rank']}: (a) read-sharded search {a['reads']} reads "
            f"golden-equal in {a['wall_s']:.2f} s, K1 launches {a['k1_launches']}; "
            f"(b) post-filter search frontier-sharded golden-equal, Python driver + K1 "
            f"{b[0]['wall_s']:.4f} s (K1 launches {b[0]['k1_launches']}), C++ driver "
            f"{b[1]['wall_s']:.4f} s; (d) evalGFA {r['evalgfa']['wall_s']:.2f} s; "
            f"(c) align {c['wall_s']:.2f} s, seeding {ph['seeding']:.2f} s, scoring "
            f"{ph['scoring']:.2f} s, tracebacks {ph['traceback']:.2f} s "
            f"({c['tracebacks']['banded_cuda']} banded walks in "
            f"{c['launches']['bandtrace']} launches), K3 launches {c['launches']['banded']}")
    single = f"{single_align_s:.2f} s" if single_align_s else "not run"
    log(f"phase 11 (c) seeded align, all 10,000 reads on {DIST_RANKS} ranks: GAF golden-equal "
        f"(rank 0 wrote it), slowest rank {max(r['align']['wall_s'] for r in ranks):.2f} s "
        f"against phase 9's one process {single}; (d) bytes equal to the one-process "
        f"evalGFA ({evalgfa_s:.2f} s)")
    t0 = time.time()
    outs, errs = spawn_ranks(["-c", CLI_COUNTING, "search", "-f", paths["gfa"], "-g",
                              str(filtered), "-n", paths["search_nodelist"], "-s", "498",
                              "-d", "503"], workdir, "cli", DIST_CLI_SECONDS)
    cli_s = time.time() - t0
    if digest(outs[0].encode()) != golden["search_filtered.out"] or any(outs[1:]):
        raise RuntimeError(f"phase 11 (e) CLI search: rank 0 printed {digest(outs[0].encode())}"
                           f", the others {[len(o) for o in outs[1:]]} bytes")
    cli_k1 = [[json.loads(line[9:])["packed"] for line in e.splitlines()
               if line.startswith("LAUNCHES ")][-1] for e in errs]
    if not all(cli_k1):
        raise RuntimeError(f"phase 11 (e) CLI search: K1 launches by rank {cli_k1}")
    log(f"phase 11 (e) GFALIGN_TORCH_DISTRIBUTED=1 python -m gfalign_torch search on "
        f"the post-filter reads, {DIST_RANKS} ranks: rank 0 golden-equal, the others "
        f"silent, K1 launches by rank {cli_k1}, {cli_s:.1f} s with start-up")
    return dict(ranks=ranks, worker_s=worker_s, cli_s=cli_s, cli_k1_launches=cli_k1, transport=notes,
                single_align_s=single_align_s, single_evalgfa_s=evalgfa_s)


def dump_details(details, name):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / name).write_text(json.dumps(details, indent=1) + "\n")


def main(only: str = "") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import gfalign_torch  # noqa: F401  (fails outside a checkout of the repo)

    from gfalign_torch import synth

    t_start = time.time()
    smi, name = phase_card()
    build_s, sass = phase_build()
    gen = torch.Generator().manual_seed(0)
    if only == "sa":
        dump_details(dict(card=smi, device=name, build_s=build_s, sass=sass,
                          seqalign_ragged=phase_seqalign_ragged(gen),
                          seqalign_ultra_long=phase_seqalign_ultra_long(),
                          seqalign_synthetic=phase_seqalign_synthetic(),
                          walk=phase_walk(), bandtrace=phase_bandtrace()),
                     "chip_smoke_sa.json")
        log(f"phases 1, 2, 8, 8b and 8c passed in {time.time() - t_start:.1f} s (--sa: "
            f"the other phases were not run, so no result line is printed)")
        return 0
    # the phases that also run alone, after phases 1 and 2
    alone = {"dist": (11, lambda work: phase_distributed(work, synth.make_workload(seed=0))),
             "host-ladder": (12, lambda work: phase_host_ladder(work, synth.make_workload(seed=0))),
             "trace": (13, lambda work: phase_trace(work, synth.make_workload(seed=0))),
             "dryrun": (14, lambda work: phase_dryrun())}
    if only in alone:
        phase, run = alone[only]
        with tempfile.TemporaryDirectory() as workdir:
            res = run(workdir)
        dump_details(dict(card=smi, device=name, build_s=build_s, **{only: res}),
                     f"chip_smoke_{only}.json")
        log(f"phases 1, 2 and {phase} passed in {time.time() - t_start:.1f} s on {smi} "
            f"(--{only}: the other phases were not run, so no result line is printed)")
        return 0
    k1_bench = phase_k1_bench(gen)
    k2_check = phase_k2(gen)
    if only == "nw":
        dump_details(dict(card=smi, device=name, build_s=build_s, sass=sass,
                          k1_bench=k1_bench, k2_check=k2_check),
                     "chip_smoke_nw.json")
        log(f"phases 1-4 passed in {time.time() - t_start:.1f} s (--nw: the "
            f"other phases were not run, so no result line is printed)")
        return 0
    wl = synth.make_workload(seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        search, evalpath, largest, search_argv, paths = phase_end_to_end(workdir, wl)
        filtered_search = phase_filtered_search(workdir, wl, paths)
        long_paths, long_tensors = phase_long_paths()
        k1, k2 = phase_main_shapes(largest, long_tensors)
        profile = phase_profile(search_argv, search["window_s"])
        sa_ragged = phase_seqalign_ragged(gen)
        sa_ultra_long = phase_seqalign_ultra_long()
        sa_synthetic = phase_seqalign_synthetic()
        walk = phase_walk()
        bandtrace = phase_bandtrace()
        align, recs = phase_align(workdir, wl)
        sa_main = phase_seqalign_main_shapes(recs)
        distributed = phase_distributed(workdir, wl, paths, align["seeded"]["seconds"])
        host_ladder = phase_host_ladder(workdir, wl, align)
        trace = phase_trace(workdir, wl, paths)
    dryrun = phase_dryrun()

    launches = {"packed": search["launches"]["packed"] + evalpath["launches"]["packed"],
                "split": long_paths["launches"]["split"],
                "banded": align["seeded"]["launches"]["banded"],
                "pairs": align["band_edge"]["launches"]["pairs"],
                "cross": align["exhaustive"]["launches"]["cross"],
                "walk": sum(run["launches"]["walk"] for run in align.values()),
                "bandtrace": align["seeded"]["launches"]["bandtrace"]}
    table = []
    for kind, res, source in (("packed", k1, "nw_path"), ("split", k2, "nw_path"),
                              ("banded", sa_main["banded_128"], "seqalign"),
                              ("pairs", sa_main["pairs"], "seqalign"),
                              ("cross", sa_main["cross"], "seqalign")):
        table.append(dict(KERNELS[kind], route="cuda",
                          source=f"gfalign_torch/csrc/{source}.cu",
                          launches=launches[kind], max_abs_err=res["max_abs_err"],
                          ms=res["ms"], plain_ms=res["plain_ms"],
                          bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                          library_ms=None))
    clr_walk = max((v for k, v in walk.items() if k not in ("faults", "ultra_long")),
                   key=lambda v: v["cells"])   # the largest CLR pair, timed plain too
    table.append(dict(KERNELS["walk"], route="cuda",
                      source="gfalign_torch/csrc/seqalign.cu", launches=launches["walk"],
                      max_abs_err=walk["faults"]["max_abs_err"],
                      ops_differ=walk["faults"]["ops_differ"],
                      codes_differ=walk["faults"]["codes_differ"], ms=clr_walk["ms"],
                      plain_ms=clr_walk["plain_ms"],
                      bound_ms=clr_walk["bound_ms"], bound_by="operations",
                      host_ms=clr_walk["host_ms"], library_ms=None))
    ont = bandtrace["ont_r10 w2048 201.6 kb alone"]
    table.append(dict(KERNELS["bandtrace"], route="cuda",
                      source="gfalign_torch/csrc/seqalign.cu",
                      launches=launches["bandtrace"],
                      max_abs_err=bandtrace["faults"]["max_abs_err"],
                      ops_differ=bandtrace["faults"]["ops_differ"],
                      declines_differ=bandtrace["faults"]["declines_differ"],
                      codes_differ=bandtrace["faults"]["codes_differ"], ms=ont["ms"],
                      plain_ms=bandtrace["plain_ms"], bound_ms=ont["bound_ms"],
                      bound_by="operations", host_ms=ont["host_ms"], library_ms=None))
    details = dict(card=smi, device=name, build_s=build_s, sass=sass, k1_bench=k1_bench,
                   k2_check=k2_check, search=search, evalpath=evalpath,
                   filtered_search=filtered_search,
                   long_paths=long_paths, k1_main=k1, k2_main=k2, profile=profile,
                   seqalign_ragged=sa_ragged, seqalign_ultra_long=sa_ultra_long,
                   seqalign_synthetic=sa_synthetic, walk=walk, bandtrace=bandtrace,
                   align=align, seqalign_main=sa_main, distributed=distributed,
                   host_ladder=host_ladder, trace=trace, dryrun=dryrun,
                   ops_per_cell=OPS_PER_CELL, seconds=time.time() - t_start)
    dump_details(details, "chip_smoke.json")
    log(f"all phases passed in {details['seconds']:.1f} s on {smi}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":   # phase 11's ranks
        raise SystemExit(rank_worker(sys.argv[2]))
    if sys.argv[1:] not in ([], ["--nw"], ["--sa"], ["--dist"], ["--host-ladder"],
                            ["--trace"], ["--dryrun"]):
        raise SystemExit("usage: python3 chip_smoke.py [--nw | --sa | --dist | "
                         "--host-ladder | --trace | --dryrun]")
    raise SystemExit(main(only=sys.argv[1][2:] if sys.argv[1:] else ""))
