"""K3, the banded scoring kernel (ops/seqalign_cuda.py, csrc/seqalign.cu,
kernels banded_*), in the traced align call: its least time, from the
work of every call into ops.seqalign.banded_arena_scores counted by
roofline.banded_work, over its time in the trace, in %."""

from benchmark import roofline

LAYER = "kernel K3"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "align_reads_per_s"
KERNELS = ("banded_",)


def read(obs):
    sl = obs.get("slice")
    work = obs.get("work", {}).get("k3")
    if obs.get("mode") != "align" or not sl or not work:
        return None
    t = sum(s for n, s in sl["kernels"].items() if any(k in n for k in KERNELS))
    return roofline.share(work, t)
