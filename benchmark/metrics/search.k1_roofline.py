"""K1, the path alignment kernel (ops/nw_cuda.py, csrc/nw_path.cu,
kernels nw_fwd_packed_*), over the traced frontier calls: its least time,
from each frontier's useful cells counted by roofline.path_work at the
call into evaluate_candidates, over its time in the trace, in %."""

from benchmark import roofline

LAYER = "kernel K1"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "search_s"
KERNELS = ("nw_fwd_packed",)


def read(obs):
    sl = obs.get("slice")
    work = obs.get("work", {}).get("k1")
    if obs.get("mode") != "search" or not sl or not work:
        return None
    t = sum(s for n, s in sl["kernels"].items() if any(k in n for k in KERNELS))
    return roofline.share(work, t)
