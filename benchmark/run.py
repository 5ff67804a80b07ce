"""The benchmark of gfalign_torch, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is one fresh process.  It puts every build cache inside the
checkout, makes the cell's inputs from the seed (the graph and reads of
the cell's configuration, written under TMPDIR), warms up on the cell's
own call, then calls the program back to back for `--seconds` and prints
one JSON line: `correct`, `attempted`, `failed`, the metrics, the device,
and last the numbers compared with their limits.  `--trace 0` reports
the cell's end-to-end metrics; `--trace 1` runs the same window with the
benchmark's wrappers around the program's layers, then one bounded slice
under torch.profiler, and reports the per-layer metrics.

Everything a cell is made of is found by name from BENCHMARK.json: its
configuration (configs/<config>.json), its traffic (traffic/<cell>.json,
whose `mode` names the driver in modes/), and each per-layer metric's
reader (metrics/<metric>.py).
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import common  # noqa: E402  (path set above)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def passes(checks: dict) -> bool:
    """Every compared number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def mode_module(name: str):
    import importlib

    return importlib.import_module(f"benchmark.modes.{name}")


def execute(args, spec: dict, config: dict, traffic: dict, device: str,
            control: bool = False) -> tuple:
    """Set-up, the window, the traced slice and the judgement of one run;
    returns (result without its checks, checks).  `control` judges the
    reference's lower-precision stand-in in the program's place as well,
    from the same window: the result's "control" holds its `correct` and
    its checks."""
    import torch

    cell_mode = mode_module(traffic["mode"])
    on_card = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="gfalign-bench-") as work:
        cell = cell_mode.Cell(config, traffic, args.seed, work, device)
        cell.prepare()
        cell.warm()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        attempted = failed = done = 0
        t_first = time.perf_counter()
        setup_s = t_first - common.T_START
        traced = cell.traced() if args.trace else contextlib.nullcontext()
        with traced:
            cell.start_window()
            k = 0
            t_last = t_first
            walls = []
            try:
                while t_last - t_first < args.seconds:
                    units, ok = cell.call(k)
                    attempted += units
                    if ok:
                        done += units
                    else:
                        failed += units
                    k += 1
                    walls.append(time.perf_counter() - t_last)
                    t_last += walls[-1]
            finally:
                cell.end_window()
            elapsed = t_last - t_first
            summary = None
            if args.trace:
                from benchmark import trace

                if on_card:
                    sl = trace.Slice(torch)
                    cell.profiled_call(k, sl)
                    summary = sl.summary()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if args.trace:
            obs = cell.observations(done)
            obs["slice"] = summary
            metrics = {}
            for m in common.metrics_of(spec, args.workload, "per_layer"):
                value = common.load_reader(m["name"]).read(obs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            e2e = cell.end_to_end(elapsed, done) if done else {}
            e2e["setup_s"] = setup_s
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in common.metrics_of(spec, args.workload, "end_to_end")
                       if m["name"] in e2e}
        checks = cell.judge()
        control_checks = cell.judge(control=True) if control else None
    sound = failed == 0 and done > 0
    result = {"correct": sound and passes(checks), "attempted": attempted,
              "failed": failed, "metrics": metrics}
    if control:
        result["control"] = {"correct": sound and passes(control_checks),
                             "checks": control_checks}
    if on_card:
        result["device"] = common.device_block(
            torch, 1, peak, summary if args.trace else None)
        if args.trace and summary is not None:
            result["breakdown"] = summary["breakdown"]
    print(f"setup {setup_s:.3f} s, window {elapsed:.3f} s, {done} "
          f"{cell.unit} done of {attempted}, calls "
          + " ".join(f"{w:.3f}" for w in walls), file=sys.stderr, flush=True)
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    common.set_cache_dirs()
    try:
        spec = common.benchmark_spec()
        cell, config, traffic = common.cell_files(spec, args.workload)
    except OSError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    try:
        import gfalign_torch  # the system under test, from this checkout
    except ImportError as exc:
        print(f"benchmark: the program is not in this checkout ({exc})",
              file=sys.stderr)
        return 2
    if pathlib.Path(gfalign_torch.__file__).resolve().parents[1] != common.ROOT:
        print(f"benchmark: gfalign_torch comes from {gfalign_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    facts = common.card_facts()
    print("card " + ", ".join(f"{k}={v}" for k, v in facts.items()),
          file=sys.stderr, flush=True)
    result, checks = execute(args, spec, config, traffic, "cuda")
    bad = common.forbidden_loaded()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
