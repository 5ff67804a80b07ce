"""The traced slice: torch.profiler (CPU and CUDA activity) over a bounded
part of a run, reduced in memory to the device's busy time, each kernel's
time and the longest idle gaps.  Nothing is written to disk."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np


class Slice:
    """Start with `start()`, end with `stop()` (once); then `summary()`."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.t1 is not None:
            return
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        return reduce_events(
            [(e.name(), e.device_type().name, e.start_ns(), e.duration_ns())
             for e in events],
            self.t1 - self.t0)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip() or "?"


def union_intervals(starts: np.ndarray, ends: np.ndarray) -> List[Tuple[int, int]]:
    order = np.argsort(starts, kind="stable")
    out: List[Tuple[int, int]] = []
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events: List[Tuple[str, str, int, int]], window_s: float,
                  top: int = 10) -> dict:
    """(name, device type, start ns, duration ns) events of one slice ->
    busy_s (the union of device intervals), window_s (the slice's host
    time), kernels {name: seconds}, and the breakdown: the `top` device
    operations by time and the `top` longest gaps between device work,
    each named by the innermost host operation that spans its middle
    ("host Python" where none does)."""
    dev = [(n, s, d) for n, t, s, d in events if t == "CUDA" and d > 0]
    host = [(n, s, d) for n, t, s, d in events if t == "CPU" and d > 0]
    kernels: Dict[str, float] = {}
    for n, _, d in dev:
        kernels[n] = kernels.get(n, 0.0) + d / 1e9
    busy = []
    if dev:
        st = np.array([s for _, s, _ in dev], np.int64)
        en = st + np.array([d for _, _, d in dev], np.int64)
        busy = union_intervals(st, en)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    idle = []
    if host:
        hs = np.array([s for _, s, _ in host], np.int64)
        he = hs + np.array([d for _, _, d in host], np.int64)
        hd = he - hs
    for g, a, b in gaps:
        mid = (a + b) // 2
        label = "host Python"
        if host:
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            if cover.size:
                label = host[int(cover[np.argmin(hd[cover])])][0]
        idle.append([label, g / 1e9])
    short: Dict[str, float] = {}
    for n, sec in kernels.items():
        short[short_name(n)] = short.get(short_name(n), 0.0) + sec
    ops = sorted(short.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}
