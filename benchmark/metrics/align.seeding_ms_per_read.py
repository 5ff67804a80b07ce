"""Seeding: the k-mer index, anchor votes and candidate paths
(gfalign_torch engine/seeding.py, graph_align.gen_candidates), from the
delta of graph_align.PHASE_SECONDS["seeding"] over the window, per read
aligned."""

LAYER = "seeding"
SOURCE = "program_span"
UNIT = "ms/read"
MOVES = "align_reads_per_s"


def read(obs):
    if obs.get("mode") != "align" or not obs.get("reads"):
        return None
    return 1000.0 * obs["phase_s"]["seeding"] / obs["reads"]
