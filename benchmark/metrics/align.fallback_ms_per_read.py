"""The exact full-matrix traceback fallback (ops/seqalign.traceback, the walk
after a banded walk declined): the program's span align.traceback.full over
the window, per read aligned (counter align.reads), in ms."""

LAYER = "placement and tracebacks"
SOURCE = "program_span"
UNIT = "ms/read"
MOVES = "align_reads_per_s"


def read(obs):
    spans, counts = obs.get("spans"), obs.get("counts")
    if obs.get("mode") != "align" or spans is None or not counts:
        return None
    reads = counts.get("align.reads", 0)
    if reads <= 0:
        return None
    return 1000.0 * spans.get("align.traceback.full", 0.0) / reads
