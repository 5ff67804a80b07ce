"""Readings for the limits of `correct`, on the card at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control] [--sample N] [--data-seed N]

For each seed, one run of the cell as benchmark/run.py makes it (set-up,
a short window, the judgement) and one line with the numbers compared;
with --control the same window is judged a second time with the control
in the program's place: the reference aligner and banded DP in
saturating int8 for the align cells, the reference search with the
reverse complement left out for the search cells.  --data-seed makes the
graph and reads from another seed than the cells' own, to read the
numbers on other data.  The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import common, run, workload  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sample", type=int, default=0,
                    help="judge this many reads (all of them in the DP "
                         "comparisons too), for the largest reading any seed "
                         "can give on a fixed pool")
    ap.add_argument("--data-seed", type=int, default=None)
    a = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    spec = common.benchmark_spec()
    _, config, traffic = common.cell_files(spec, a.workload)
    if a.sample:
        traffic = dict(traffic, check_reads=a.sample, dp_reads=a.sample)
    if a.data_seed is not None:
        workload.DATA_SEED = a.data_seed
    for seed in (int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
        result, checks = run.execute(args, spec, config, traffic, "cuda",
                                     control=a.control)
        line = {"workload": a.workload, "seed": seed,
                "data_seed": workload.DATA_SEED, "correct": result["correct"],
                "checks": {k: v["value"] for k, v in checks.items()}}
        if a.control:
            line["control"] = {"correct": result["control"]["correct"],
                               "checks": {k: v["value"] for k, v in
                                          result["control"]["checks"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
