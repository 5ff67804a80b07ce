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
     deltas, N codes, all-PAD rows, multi-step paths), then at phase 10's
     shapes synthesised without an align run (bench_seqalign), timed with
     the first design's recorded times beside;
  9. `align` end to end through gfalign_torch.cli.main.main on CUDA, three
     runs, each GAF equal to its golden in tests/data/ (md5 and record
     count) with the launch counters zeroed before and read after: the
     seeded engine at full scale (the 1,142-segment graph of
     make_workload(seed=0) and all 10,000 of its reads, 2-8 kb, hifi;
     must launch K3), a small seeded run whose hand-made reads end on the
     band edge at both band widths (must launch K4), and the exhaustive
     engine on a 34-segment graph (must launch K5); every traceback of
     every run must go through the native library (ops/seqalign's
     TRACEBACK_CALLS: no Python traceback);
 10. K3, K4 and K5 timed against their plain versions at those runs' own
     shapes: K3 at the seeded run's largest chunk at widths 128 and 512, K4
     at the largest bucket launched, K5 at the exhaustive run's first call;
     K3 and K4 with the first design's recorded times beside.

A kernel's bound is its useful DP cells times its integer-ALU operations
per cell (OPS_PER_CELL) over the card's int32 ALU rate, or its bytes over
HBM bandwidth if larger.  For K3-K5 the cells are those of the rows up to
each read's last non-PAD char (the kernels skip the rest).

`python3 chip_smoke.py --nw` stops after phase 4 (build, K1 and K2 against
their plain versions: under a minute) and prints no result line;
`python3 chip_smoke.py --sa` runs phases 1, 2 and 8 only (build, K3-K5
against their plain versions and at the synthesised phase-10 shapes: about
a minute), no result line either.

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
    """Machine instructions per DP cell of every K1, K2, K3 and K4 row loop,
    read off the built libraries.  K1 and K2 spend two max-type
    instructions on a cell (K1 two add-then-max; K2 a max and an
    add-then-max), so an innermost loop's count of them gives its cells.
    A K3 group kernel's row is 2 + log2(G) shuffles over L cells a thread,
    and a K4 wavefront step one shuffle over K cells (L, G and K from the
    kernel's template arguments), so there the loop's shuffles give its
    cells.  'alu' leaves out loads, stores, branches, barriers and
    shuffles."""
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


def phase_end_to_end(workdir, wl):
    import gfalign_torch.engine.search as search_mod
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
    log(f"phase 5 inputs: make_workload(seed=0) written and md5-checked in "
        f"{time.time() - t0:.1f} s")

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
    nodes = pathlib.Path(work) / "filter_nodelist.ls"
    nodes.write_text("".join(n + "\n" for n in wl.filter_nodelist))
    filtered = str(pathlib.Path(work) / "filtered.gaf")
    _, filter_s, _ = run_main(["filter", "-g", paths["gaf"], "-n", str(nodes),
                               "-o", filtered])
    if digest(pathlib.Path(filtered).read_bytes()) != golden["filtered.gaf"]:
        raise RuntimeError("filter output differs from the golden filtered.gaf")
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


def run_align(name, runs, golden, workdir):
    """One `align` run through the CLI on CUDA against its golden GAF."""
    import torch

    from gfalign_torch.cli.main import main
    from gfalign_torch.engine import graph_align
    from gfalign_torch.ops import seqalign, seqalign_cuda

    gfa, reads, preset = runs[name]
    for path in (gfa, reads):
        key = pathlib.Path(path).name
        if digest(pathlib.Path(path).read_bytes()) != golden[key]:
            raise RuntimeError(f"{key} differs from the recorded input")
    out_gaf = pathlib.Path(workdir) / f"{name}.out.gaf"
    for k in seqalign_cuda.LAUNCHES:
        seqalign_cuda.LAUNCHES[k] = 0
    for k in graph_align.PHASE_SECONDS:
        graph_align.PHASE_SECONDS[k] = 0.0
    for k in seqalign.TRACEBACK_CALLS:
        seqalign.TRACEBACK_CALLS[k] = 0
    rec = AlignRecorder()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with rec.installed(), contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(["align", "-f", gfa, "-r", reads, "-o", str(out_gaf), "-p", preset])
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(seqalign_cuda.LAUNCHES)
    tracebacks = dict(seqalign.TRACEBACK_CALLS)
    if rc != 0:
        raise RuntimeError(f"align ({name}) exited {rc}: {err.getvalue()[-400:]}")
    if tracebacks["python"] or not tracebacks["native"]:
        raise RuntimeError(f"align ({name}) tracebacks {tracebacks}: each must go "
                           f"through the native library")
    if not buf.getvalue().startswith(f"Invoking: gfalign-tpu-align -p {preset} "):
        raise RuntimeError(f"align ({name}) did not echo its invocation")
    got = digest(out_gaf.read_bytes())
    if got != golden[f"{name}.gaf"]:
        keep = ROOT / "chiprun_out"
        keep.mkdir(exist_ok=True)
        (keep / f"{name}.out.gaf").write_bytes(out_gaf.read_bytes())
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

    t_start = time.time()
    smi, name = phase_card()
    build_s, sass = phase_build()
    gen = torch.Generator().manual_seed(0)
    if only == "sa":
        dump_details(dict(card=smi, device=name, build_s=build_s, sass=sass,
                          seqalign_ragged=phase_seqalign_ragged(gen),
                          seqalign_synthetic=phase_seqalign_synthetic()),
                     "chip_smoke_sa.json")
        log(f"phases 1, 2 and 8 passed in {time.time() - t_start:.1f} s (--sa: "
            f"the other phases were not run, so no result line is printed)")
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
    from gfalign_torch import synth

    wl = synth.make_workload(seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        search, evalpath, largest, search_argv, paths = phase_end_to_end(workdir, wl)
        filtered_search = phase_filtered_search(workdir, wl, paths)
        long_paths, long_tensors = phase_long_paths()
        k1, k2 = phase_main_shapes(largest, long_tensors)
        profile = phase_profile(search_argv, search["window_s"])
        sa_ragged = phase_seqalign_ragged(gen)
        sa_synthetic = phase_seqalign_synthetic()
        align, recs = phase_align(workdir, wl)
        sa_main = phase_seqalign_main_shapes(recs)

    launches = {"packed": search["launches"]["packed"] + evalpath["launches"]["packed"],
                "split": long_paths["launches"]["split"],
                "banded": align["seeded"]["launches"]["banded"],
                "pairs": align["band_edge"]["launches"]["pairs"],
                "cross": align["exhaustive"]["launches"]["cross"]}
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
    details = dict(card=smi, device=name, build_s=build_s, sass=sass, k1_bench=k1_bench,
                   k2_check=k2_check, search=search, evalpath=evalpath,
                   filtered_search=filtered_search,
                   long_paths=long_paths, k1_main=k1, k2_main=k2, profile=profile,
                   seqalign_ragged=sa_ragged, seqalign_synthetic=sa_synthetic,
                   align=align, seqalign_main=sa_main,
                   ops_per_cell=OPS_PER_CELL, seconds=time.time() - t_start)
    dump_details(details, "chip_smoke.json")
    log(f"all phases passed in {details['seconds']:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--nw"], ["--sa"]):
        raise SystemExit("usage: python3 chip_smoke.py [--nw | --sa]")
    raise SystemExit(main(only=sys.argv[1][2:] if sys.argv[1:] else ""))
