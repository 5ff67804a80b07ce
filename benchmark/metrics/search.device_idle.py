"""The card's idle share over the first frontier calls of a search after
the window (the traffic's profile_calls): 1 less the union of its kernel
and copy intervals in the torch.profiler trace over the slice's time,
in %."""

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "search_s"


def read(obs):
    sl = obs.get("slice")
    if obs.get("mode") != "search" or not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
