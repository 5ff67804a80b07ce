"""The walk kernel (ops/seqalign_cuda._launch_walk, csrc/seqalign.cu,
kernels walk_*), in the traced align call: its least time, from the work of
every on-card call into ops.seqalign.traceback counted by
modes/align_ul.walk_work (the rectangle's cells, whatever the walk
computes), over its time in the trace, in %."""

from benchmark import roofline

LAYER = "walk kernel"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "align_reads_per_s"
KERNELS = ("walk_",)


def read(obs):
    sl = obs.get("slice")
    work = obs.get("work", {}).get("walk")
    if obs.get("mode") != "align" or not sl or not work:
        return None
    t = sum(s for n, s in sl["kernels"].items() if any(k in n for k in KERNELS))
    return roofline.share(work, t)
