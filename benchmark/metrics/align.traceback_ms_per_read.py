"""Placement rounds and tracebacks (graph_align.placement_rounds,
ops/seqalign.py, the native walks of io/native.py), from the delta of
graph_align.PHASE_SECONDS["traceback"] over the window, per read
aligned."""

LAYER = "placement and tracebacks"
SOURCE = "program_span"
UNIT = "ms/read"
MOVES = "align_reads_per_s"


def read(obs):
    if obs.get("mode") != "align" or not obs.get("reads"):
        return None
    return 1000.0 * obs["phase_s"]["traceback"] / obs["reads"]
