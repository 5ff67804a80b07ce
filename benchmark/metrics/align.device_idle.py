"""The card's idle share during one whole align call after the window:
1 less the union of its kernel and copy intervals in the torch.profiler
trace over the slice's time, in %."""

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "align_reads_per_s"


def read(obs):
    sl = obs.get("slice")
    if obs.get("mode") != "align" or not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
