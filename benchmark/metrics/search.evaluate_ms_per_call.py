"""Frontier scoring: encode, one upload, the device step (K1, the
membership filter, the tallies) and the tallies back (engine/evaluate.py,
parallel/score_step.py): the wall inside evaluate_candidates in the
window, per frontier call."""

LAYER = "frontier scoring"
SOURCE = "host_clock"
UNIT = "ms/call"
MOVES = "search_s"


def read(obs):
    if obs.get("mode") != "search" or not obs.get("frontier_calls"):
        return None
    return 1000.0 * obs["evaluate_s"] / obs["frontier_calls"]
