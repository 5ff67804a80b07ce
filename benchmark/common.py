"""What every cell of the benchmark shares: where the caches go, the cell's
files found by name, the device's description, the result line, the
per-layer metric readers and the check for JAX in the process."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]     # the checkout
HERE = pathlib.Path(__file__).resolve().parent         # benchmark/
FORBIDDEN = ("jax", "jaxlib", "flax", "gfalign_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time in
    clock ticks against the uptime), so that set-up counts the
    interpreter's own start too."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - process_age()


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds: the port's own builds go to
    build/gfalign_torch/ beside its sources (it is a source checkout), and
    the toolchains' caches under build/benchmark/."""
    base = ROOT / "build" / "benchmark"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    for var in ("GFALIGN_TORCH_TRACE", "GFALIGN_TORCH_CACHE",
                "GFALIGN_TORCH_DISTRIBUTED", "GFALIGN_TORCH_DEVICE",
                "GFALIGN_TORCH_SEED_SAMPLE"):
        os.environ.pop(var, None)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(spec: dict, workload: str) -> tuple:
    """(cell entry, configuration, traffic mix) of a cell, each found by
    its name: configs/<config>.json through the configuration's `file`,
    traffic/<cell>.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """metrics/<name>.py, the reader of one per-layer metric."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the port must never load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_facts() -> Dict[str, str]:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    q = "name,power.limit,clocks.max.sm,clocks.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    vals = [v.strip() for v in out[0].split(",")]
    return dict(zip(q.split(","), vals))


def device_block(torch, count: int, peak: int, trace: Optional[dict]) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers beside their limits, last on standard error and
    last in the result line, which is the last line on standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
