"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's tests: the same code paths on a graph of 120 segments."""

import copy

from benchmark import common, run

GRAPH = dict(n_segments=120, seg_len=[120, 400], tangle_seg_len=[1500, 3000],
             filter_margin=6)
READS = dict(n_reads=150, read_len=[500, 1200])


def small_cell(name: str):
    spec = common.benchmark_spec()
    cell, cfg, tr = common.cell_files(spec, name)
    cfg = copy.deepcopy(cfg)
    cfg["graph"].update(GRAPH)
    cfg["reads"].update(READS)
    if tr["mode"] == "align":
        tr = dict(tr, reads_per_call=10, warm_reads=4, check_reads=30, dp_reads=8)
    return spec, cfg, tr


def run_small(name: str, seed: int = 11, seconds: float = 1.0, trace: int = 0,
              control: bool = False):
    """(result, checks) of one run of the small cell on the CPU."""
    spec, cfg, tr = small_cell(name)
    args = run.parse(["--workload", name, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.execute(args, spec, cfg, tr, "cpu", control=control)
