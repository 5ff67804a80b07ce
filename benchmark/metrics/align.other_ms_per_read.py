"""Everything of an align call outside the three phases: the CLI, the
FASTQ and GFA parses, the device pools' set-up and the GAF emit
(cli/main.py, io/fastq.py, io/gfa.py, graph_align.emit_gaf): the calls'
wall in the window less the phases' seconds, per read aligned."""

LAYER = "CLI, parse and emit"
SOURCE = "host_clock"
UNIT = "ms/read"
MOVES = "align_reads_per_s"


def read(obs):
    if obs.get("mode") != "align" or not obs.get("reads"):
        return None
    rest = obs["calls_wall_s"] - sum(obs["phase_s"].values())
    return 1000.0 * rest / obs["reads"]
