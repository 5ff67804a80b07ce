"""The scoring ladder: K3 banded rungs, K4 rescue and the device pools
(graph_align.score_pairs, DevicePools), from the delta of
graph_align.PHASE_SECONDS["scoring"] over the window (the dispatches and
the fetches that wait for the card), per read aligned."""

LAYER = "scoring ladder"
SOURCE = "program_span"
UNIT = "ms/read"
MOVES = "align_reads_per_s"


def read(obs):
    if obs.get("mode") != "align" or not obs.get("reads"):
        return None
    return 1000.0 * obs["phase_s"]["scoring"] / obs["reads"]
