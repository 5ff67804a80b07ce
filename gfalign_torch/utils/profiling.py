"""Spans, counters and torch.profiler traces.

One process-wide registry keeps a total per name: `span(name)` adds the
seconds of a `with` block and one call, `count(name, n)` adds to a
counter, and `snapshot()` copies the totals so a caller can take the
difference over a stretch of work (`since`).  Totals are kept per name, in
constant memory; nesting and order are what a profiler trace shows.  The
modules' old counter dicts (graph_align.PHASE_SECONDS and HOST_LADDER,
seqalign.TRACEBACK_CALLS, nw_cuda.LAUNCHES, seqalign_cuda.LAUNCHES) are
`view`s of these totals under their old keys.  The registry is written by
the thread that runs the mode.

A span costs a check of the profiler's flag, two clock reads and two dict
updates.  While a torch.profiler records, it also opens a profiler range of
its name (a function-scope record function), so the span shows in the
profiler's events and traces, on the clock of the device's events.  It is
not `torch.profiler.record_function`: that is a user annotation, and on a
card the profiler adds a device-side copy of each one (`gpu_user_annotation`)
that spans the kernels launched under it, which reads as device work.

Set GFALIGN_TORCH_TRACE=<dir> to record a CLI call with torch.profiler:
CPU activity, and CUDA activity (the kernels, copies and the runtime calls
that launch them) when the run scores on a CUDA device, with the spans
above.  The recording is written as one Chrome trace,
<dir>/gfalign_torch.<pid>.json, so each process of a distributed run
writes its own file; Perfetto or chrome://tracing open it.  Unset, no
profiler is built and nothing is recorded.  A trace that was asked for and
cannot be written fails the run: the file is opened before the mode runs,
and a failed export raises.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys
from collections.abc import MutableMapping
from time import perf_counter
from typing import Dict, Iterable, List

TRACE_ENV = "GFALIGN_TORCH_TRACE"

SECONDS: Dict[str, float] = {}     # span name -> seconds inside it
CALLS: Dict[str, int] = {}         # span name -> times entered
COUNTS: Dict[str, int] = {}        # counter name -> total


def _profiler_range(name: str):
    """An entered function-scope profiler range named `name`."""
    rf = sys.modules["torch"]._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _recording() -> bool:
    """Whether a torch.profiler records now; no profiler can before torch
    is imported, so this imports nothing."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class span:
    """`with span(name):` adds the block's seconds and one call to `name`."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.rf = _profiler_range(self.name) if _recording() else None
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = perf_counter() - self.t0
        name = self.name
        SECONDS[name] = SECONDS.get(name, 0.0) + dt
        CALLS[name] = CALLS.get(name, 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Inside `with s:`, leave the span for the body and enter it again
        after: the span counts one call an interval, and a profiler sees
        each interval close (a range still open when a profiler stops is
        not in its events)."""
        self.__exit__(None, None, None)
        try:
            yield
        finally:
            self.__enter__()


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


def snapshot() -> dict:
    """A copy of the totals: {"seconds": .., "calls": .., "counts": ..}."""
    return {"seconds": dict(SECONDS), "calls": dict(CALLS),
            "counts": dict(COUNTS)}


def since(before: dict) -> dict:
    """The totals added since `before` (a snapshot), names that moved only."""
    now = snapshot()
    out = {}
    for kind, table in now.items():
        old = before.get(kind, {})
        out[kind] = {k: v - old.get(k, 0) for k, v in table.items()
                     if v != old.get(k, 0)}
    return out


def report(totals: dict) -> List[str]:
    """One line a span, then one a counter, of `since`'s totals."""
    lines = [f"span {name} {totals['seconds'][name]:.6f} s "
             f"{totals['calls'].get(name, 0)} calls"
             for name in sorted(totals["seconds"])]
    lines += [f"count {name} {n}" for name, n in sorted(totals["counts"].items())]
    return lines


class view(MutableMapping):
    """The registry's entries `prefix + key` of one table, under the short
    keys a module has always published: reads and writes go to the
    registry, which keeps the only copy."""

    def __init__(self, table: Dict, prefix: str, keys: Iterable[str], zero=0):
        self._table, self._prefix = table, prefix
        self._keys = tuple(keys)
        for k in self._keys:
            table.setdefault(prefix + k, zero)

    def _name(self, key: str) -> str:
        if key not in self._keys:
            raise KeyError(key)
        return self._prefix + key

    def __getitem__(self, key: str):
        return self._table[self._name(key)]

    def __setitem__(self, key: str, value) -> None:
        self._table[self._name(key)] = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("a registry view keeps its keys")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))


@contextlib.contextmanager
def maybe_trace(device=None):
    """Record the body under torch.profiler when GFALIGN_TORCH_TRACE names
    a directory; yields the profiler, or None when not tracing."""
    trace_dir = os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield None
        return
    path = pathlib.Path(trace_dir) / f"gfalign_torch.{os.getpid()}.json"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w"):
            pass
    except OSError as exc:
        raise RuntimeError(f"{TRACE_ENV}={trace_dir}: cannot write the trace "
                           f"{path}: {exc}") from exc
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
