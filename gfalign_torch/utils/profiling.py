"""Profiling hook: torch.profiler traces behind an environment variable
(the reference only logs elapsed times under --verbose).

Set GFALIGN_TORCH_TRACE=<dir> to record a mode's execution with
torch.profiler: CPU activity, and CUDA activity (the kernels, copies and
the runtime calls that launch them) when the run scores on a CUDA device.
The recording is written as one Chrome trace, <dir>/gfalign_torch.<pid>.json,
so each process of a distributed run writes its own file; Perfetto or
chrome://tracing open it.  Unset, no profiler is built and nothing is
recorded.  A trace that was asked for and cannot be written fails the run:
the file is opened before the mode runs, and a failed export raises.
"""

from __future__ import annotations

import contextlib
import os
import pathlib

TRACE_ENV = "GFALIGN_TORCH_TRACE"


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
