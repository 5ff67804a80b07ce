"""The best-first driver (engine/search.py): the searches' wall in the
window less the wall inside evaluate_candidates, which the benchmark
wraps where the driver looks it up, per frontier call."""

LAYER = "search driver"
SOURCE = "host_clock"
UNIT = "ms/call"
MOVES = "search_s"


def read(obs):
    if obs.get("mode") != "search" or not obs.get("frontier_calls"):
        return None
    return 1000.0 * (obs["search_wall_s"] - obs["evaluate_s"]) / obs["frontier_calls"]
