"""Command-line surface: drop-in equivalent of the reference's
`gfalign [tool] [options]` (src/main.cpp), so the reference's
validateFiles/*.tst command lines run unmodified against this framework.

Six modes: align, evalGFA, subgraph, search, filter, evalPath.  This is
the PyTorch/CUDA port of gfalign_tpu/cli/main.py: every flag parses as
there, and all six modes run, with align, search and evalPath scoring on
`device` (CUDA unless the caller asks for the CPU).  `-j/--threads` sizes
the native host runtime's thread pools (io/native.set_threads).

A distributed run is N processes launched as torchrun launches them
(`torchrun --nproc-per-node N -m gfalign_torch ...`, or RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT set by hand) with GFALIGN_TORCH_DISTRIBUTED=1:
they join a gloo process group (parallel/dist.py), each scores on its own
device, and rank 0 alone writes stdout and the output files, the same
bytes as one process.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

import torch

VERSION = "0.1.0"

TOOLS = {"align": 0, "evalGFA": 1, "subgraph": 2, "search": 3, "filter": 4, "evalPath": 5}
MODE_NAMES = {mode: name for name, mode in TOOLS.items()}

_HELP = """gfalign [options] [tool] [arguments]
-h for additional help.

Tools:
align
evalGFA
evalPath
subgraph
search
filter
"""


class UserInput:
    def __init__(self) -> None:
        self.mode = 0
        self.in_sequence = ""
        self.in_align = ""
        self.in_reads: List[str] = []
        self.out_file = ""
        self.node_file = ""
        self.source = ""
        self.destination = ""
        self.path = ""
        self.preset = "hifi"
        self.stats_flag = False
        self.align_stats_flag = False
        self.sort_alignment_flag = False
        self.terminal_alignments_flag = False
        self.return_all_paths = False
        self.cmd_flag = False
        self.min_nodes = 0
        self.dijkstra_steps = 100000
        self.threads = 0
        self.cmd_echo: List[str] = []  # argv as typed, incl. argv[0]
        self.align_overrides: dict = {}  # AlignParams field overrides


_MODE_OPTS = {
    0: ("f:g:j:o:p:r:vh", ["input-sequence=", "input-alignment=", "preset=",
                           "input-reads=", "out-format=", "graph-statistics",
                           "threads=", "cmd", "verbose", "version", "help",
                           # aligner tunables (reference forwards arbitrary
                           # argv to GraphAligner, src/main.cpp:166-169;
                           # these expose the in-house AlignParams knobs,
                           # plus GraphAligner-compatible aliases)
                           "seed-k=", "min-score=", "band=", "wide-band=",
                           "max-anchors=", "max-paths-per-anchor=",
                           "seed-sample=",
                           "seeds-mxm-length=", "min-alignment-score=",
                           "precise-clipping="]),
    1: ("f:g:j:o:vh", ["input-sequence=", "input-alignment=", "out-format=",
                       "graph-statistics", "sort-alignment",
                       "output-terminal-alignments", "threads=", "cmd",
                       "verbose", "version", "help"]),
    2: ("f:j:n:o:vh", ["input-sequence=", "node-file=", "out-format=",
                       "graph-statistics", "threads=", "cmd", "verbose",
                       "version", "help"]),
    3: ("d:f:g:j:m:n:o:s:vh", ["destination=", "input-sequence=",
                               "input-alignment=", "max-steps=", "node-file=",
                               "out-format=", "source=", "return-all-paths",
                               "graph-statistics", "min-nodes=", "threads=",
                               "cmd", "verbose", "version", "help"]),
    4: ("g:j:n:o:vh", ["input-alignment=", "node-file=", "out-format=",
                       "min-nodes=", "threads=", "cmd", "verbose", "version",
                       "help"]),
    5: ("p:f:g:j:vh", ["path=", "input-sequence=", "input-alignment=",
                       "graph-statistics", "threads=", "cmd", "verbose",
                       "version", "help"]),
}


_MODE_HELP = {
    0: """gfalign align [options]

Options:
-f --input-sequence sequence input file (GFA1/2).
-g --input-alignment alignment input file (currently supports: GAF).
-r --input-reads reads to align (FASTQ/FASTA, repeatable).
-o --out-format ouput to file or stdout (currently supports: GAF).
-p --preset alignment presets (currently supports: hifi|CLR).
-v --version software version.
--graph-statistics output graph statistics (default: false).
--cmd print $0 to stdout.
""",
    1: """gfalign evalGFA [options]

Options:
-f --input-sequence sequence input file (GFA1/2).
-g --input-alignment alignment input file (currently supports: GAF).
-o --out-format ouput to file or stdout (currently supports: GFA, GAF).
--graph-statistics output graph statistics (default: false).
--sort-alignment output alignment sorted by query name.
--output-terminal-alignments output terminal alignments.
""",
    2: """gfalign subgraph [options]
Options:
-f --input-sequence sequence input file (GFA1/2).
-n --node-file list of nodes to retain in the subgraph.
-o --out-format ouput to file or stdout (currently supports: GFA).
""",
    3: """gfalign search [options]
Options:
-d --destination <string> destination node.
-f --input-sequence <filename> sequence input file (GFA1/2).
-g --input-alignment alignment input file (currently supports: GAF).
-m --max-steps <int> limit graph exploration.
-n --node-file <filename> list of nodes available to the search.
-s --source <string> source node.
--return-all-paths return all viable paths as they are discovered, not only better ones (default: false).
--graph-statistics output graph statistics (default: false).
--min-nodes <int> do not report paths with less than int nodes (default: 0).
""",
    4: """gfalign filter [options]
Options:
-g --input-alignment alignment input file (currently supports: GAF).
-n --node-file <filename> list of nodes available to the search.
-o --out-format ouput to file or stdout (currently supports: GAF).
--min-nodes <int> retain alignments mapping to at least int nodes.
""",
    5: """gfalign evalPath [options]
Options:
-p --path in GFA format.
-f --input-sequence <filename> sequence input file (GFA1/2).
-g --input-alignment alignment input file (currently supports: GAF).
--graph-statistics output graph statistics (default: false).
""",
}


def _print_version() -> None:
    print(f"gfalign-tpu v{VERSION}")
    raise SystemExit(0)


def _if_file_exists(path: str) -> str:
    """Exit cleanly on missing input files (reference ifFileExists,
    gfalibs functions.h via src/main.cpp:200)."""
    import os

    if path != "-" and not os.path.isfile(path):
        print(f"Error: file {path} does not exist.", file=sys.stderr)
        raise SystemExit(1)
    return path


def parse_args(argv: List[str]) -> UserInput:
    if not argv:
        print(_HELP, end="")
        raise SystemExit(0)
    mode = TOOLS.get(argv[0])
    if mode is None:
        print(f"mode '{argv[0]}' does not exist. Terminating.", file=sys.stderr)
        raise SystemExit(1)
    ui = UserInput()
    ui.mode = mode
    short, longs = _MODE_OPTS[mode]
    args = argv[1:]
    if mode == 0 and args and args[-1] in ("-p", "--preset"):
        # reference align-mode quirk: `-p` missing its argument falls back to
        # the CLR parameter set instead of erroring (src/main.cpp:155-160)
        args = args[:-1]
        ui.preset = "CLR"
    try:
        opts, extra = getopt.gnu_getopt(args, short.replace("h", "h"), longs)
    except getopt.GetoptError as exc:
        print(str(exc), file=sys.stderr)
        raise SystemExit(1)
    for opt, val in opts:
        if opt in ("-f", "--input-sequence"):
            ui.in_sequence = _if_file_exists(val)
        elif opt in ("-g", "--input-alignment"):
            ui.in_align = _if_file_exists(val)
            ui.align_stats_flag = True
        elif opt in ("-o", "--out-format"):
            ui.out_file = val
        elif opt in ("-j", "--threads"):
            ui.threads = int(val)
        elif opt in ("-n", "--node-file"):
            ui.node_file = _if_file_exists(val)
        elif opt in ("-s", "--source"):
            ui.source = val
        elif opt in ("-d", "--destination"):
            ui.destination = val
        elif opt in ("-m", "--max-steps"):
            ui.dijkstra_steps = int(val)
        elif opt in ("-p", "--preset") and mode == 0:
            ui.preset = val
        elif opt in ("-p", "--path") and mode == 5:
            ui.path = val
        elif opt in ("-r", "--input-reads"):
            ui.in_reads.append(_if_file_exists(val))
        elif opt == "--graph-statistics":
            ui.stats_flag = True
        elif opt == "--sort-alignment":
            ui.sort_alignment_flag = True
        elif opt == "--output-terminal-alignments":
            ui.terminal_alignments_flag = True
        elif opt == "--return-all-paths":
            ui.return_all_paths = True
        elif opt == "--seed-k":
            ui.align_overrides["seed_k"] = int(val)
        elif opt == "--min-score":
            ui.align_overrides["min_score"] = int(val)
        elif opt == "--band":
            ui.align_overrides["band"] = int(val)
        elif opt == "--wide-band":
            ui.align_overrides["wide_band"] = int(val)
        elif opt == "--max-anchors":
            ui.align_overrides["max_anchors"] = int(val)
        elif opt == "--max-paths-per-anchor":
            ui.align_overrides["max_paths_per_anchor"] = int(val)
        elif opt == "--seed-sample":
            # 1 = keep every index k-mer (disable the auto subsampling
            # that engages on large graphs); N > 1 = keep 1/N
            ui.align_overrides["seed_sample"] = int(val)
        elif opt == "--min-alignment-score":
            # GraphAligner-compatible alias (direct semantic match)
            ui.align_overrides["min_score"] = int(val)
        elif opt == "--seeds-mxm-length":
            # GraphAligner's minimum exact-match seed length; the in-house
            # anchor is a k-mer, so clamp into the valid k range
            ui.align_overrides["seed_k"] = max(9, min(31, int(val)))
        elif opt == "--precise-clipping":
            # GraphAligner clipping stringency in (0, 1): values below 0.9
            # signal noisy reads -> the wide CLR-style band
            if float(val) < 0.9:
                ui.align_overrides.setdefault("band", 512)
                ui.align_overrides.setdefault("wide_band", 1024)
        elif opt == "--min-nodes":
            ui.min_nodes = int(val)
        elif opt == "--cmd":
            ui.cmd_flag = True
        elif opt == "--verbose":
            from ..utils.log import lg
            lg.set_verbose(True)
        elif opt in ("-v", "--version"):
            _print_version()
        elif opt in ("-h", "--help"):
            print(_MODE_HELP[mode], end="")
            raise SystemExit(0)
    # positional reads (mode 0 allows bare file arguments after -r)
    if mode == 0:
        ui.in_reads.extend(a for a in extra if not a.startswith("-"))
    # reference mode-0 quirk: sorted/terminal output suppresses the summary
    if mode == 0 and (ui.sort_alignment_flag or ui.terminal_alignments_flag):
        ui.align_stats_flag = False
    return ui


def resolve_device(device=None) -> torch.device:
    """The scoring device: CUDA unless the caller asks for the CPU.  There
    is no silent CPU fallback: asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gfalign_torch scores on CUDA and no CUDA device is available; "
            "pass device='cpu' (GFALIGN_TORCH_DEVICE=cpu for "
            "`python -m gfalign_torch` and the scripts) to run on the CPU")
    return dev


def run(ui: UserInput, device: torch.device) -> int:
    """One CLI call.  Once the process knows it has work (a rank of a
    distributed run that a mode leaves idle returns first), the span
    cli.<mode> holds the rest of the call, recorded under torch.profiler
    when GFALIGN_TORCH_TRACE names a directory (one Chrome trace a process,
    utils/profiling.py); under --verbose, the spans and counters the call
    added follow, one line each, on stderr."""
    import os

    from ..utils import profiling
    from ..utils.log import lg

    out = sys.stdout
    # multi-process mode: GFALIGN_TORCH_DISTRIBUTED=1 -> gloo process
    # group, qname-sharded loading, summed statistics
    shard = None
    if os.environ.get("GFALIGN_TORCH_DISTRIBUTED"):
        import io

        from ..parallel import dist
        dist.init_if_requested()
        shard = dist.process_info()
        if shard == (0, 1):
            shard = None
        elif not _distributes(ui):
            if shard[0] != 0:
                return 0
            shard = None
        else:
            device = dist.rank_device(device)
            if shard[0] != 0:   # identical output everywhere; print once
                out = io.StringIO()
    before = profiling.snapshot() if lg.verbose_flag else None
    with profiling.maybe_trace(device), \
            profiling.span("cli." + MODE_NAMES[ui.mode]):
        rc = _run(ui, device, out, shard)
    if before is not None:
        for line in profiling.report(profiling.since(before)):
            lg.verbose(line)
    return rc


def _run(ui: UserInput, device: torch.device, out, shard) -> int:
    from ..engine.alignments import AlignmentSet
    from ..graph.stats import report_stats
    from ..io.gfa import read_gfa
    from ..utils.log import lg
    from ..utils.profiling import span

    if ui.threads:
        from ..io import native
        native.set_threads(ui.threads)
    if ui.cmd_flag:
        # reference echoes every argv token as typed, incl. argv[0]
        # (src/main.cpp:651-656: printf("%s ", argv[i]) loop)
        out.write("".join(t + " " for t in ui.cmd_echo) + "\n")

    graph = None
    if ui.in_sequence:
        lg.verbose(f"GFA: {ui.in_sequence}")
        graph = read_gfa(ui.in_sequence)
        if ui.stats_flag:
            report_stats(graph, out)

    alignments = AlignmentSet()
    if ui.in_align:
        lg.verbose(f"Alignment: {ui.in_align}")
        with span("io.read_gaf"):
            alignments.load(ui.in_align, ui.terminal_alignments_flag,
                            shard=shard, shard_by="qname")
    return _run_mode(ui, graph, alignments, out, device, shard)


def _distributes(ui: UserInput) -> bool:
    """Whether a mode has an exact distributed form: search, align and the
    evalGFA statistics (duplicate marking, summed totals).  Modes that
    write the whole record set (filter, subgraph, evalPath, sorted or
    decorated evalGFA output) run on rank 0 alone, since a shard of the
    records would write a shard of the output."""
    if ui.mode == 3:
        return True
    if ui.mode not in (0, 1) or ui.sort_alignment_flag:
        return False
    return not ui.out_file or (ui.mode == 0 and bool(ui.in_reads))


def _run_mode(ui, graph, alignments, out, device, shard=None) -> int:
    mode = ui.mode
    if mode == 0:
        from ..engine.aligner import align_mode
        if ui.in_reads:
            # distributed align: reads sharded by index across processes,
            # rank 0 gathers and writes the input-order GAF
            align_mode(graph, ui.in_reads, ui.out_file, ui.preset,
                       overrides=ui.align_overrides, echo=True, out=out,
                       shard=shard, device=device)
            ui.out_file = ""  # -o was the aligner's GAF; don't let the
            # evalGFA fall-through below overwrite it with a decorated GFA
        # falls through to evalGFA behavior (reference
        # src/input-gfalign.cpp:79-82 has no break after case 0)
        mode = 1
    if mode == 1:
        if ui.in_align:
            alignments.sort_by_name()
            if shard is not None:
                # exact global duplicate marking (the cross-process
                # scratch-leak quirk included), then the summed load-time
                # totals
                alignments.mark_duplicates_distributed(out)
                alignments.merge_distributed(dup_counts=False)
            else:
                alignments.mark_duplicates(out)
            if ui.align_stats_flag:
                alignments.print_stats(out)
            elif ui.sort_alignment_flag:
                alignments.output(ui.out_file, out)
        if ui.in_align and ui.out_file:
            from ..engine.evalgfa import eval_gfa
            from ..io.writers import write_decorated_gfa, write_graph
            if graph is None:
                # reference decorates even without -f: evalGFA runs on the
                # empty InSequences and writes an empty graph
                # (src/input-gfalign.cpp:93-97)
                from ..graph.model import Graph
                graph = Graph()
            eval_gfa(graph, alignments)
            if ui.in_sequence:
                write_decorated_gfa(graph, ui.in_sequence, ui.out_file)
            else:
                write_graph(graph, ui.out_file)
    elif mode == 2:
        if graph is None:
            print("subgraph: missing input graph (-f)", file=sys.stderr)
            return 1
        nodelist = _read_nodelist(ui.node_file)
        sub = graph.subgraph(nodelist)
        if ui.out_file:
            from ..io.writers import write_graph
            write_graph(sub, ui.out_file)
    elif mode == 3:
        if graph is None:
            print("search: missing input graph (-f)", file=sys.stderr)
            return 1
        from ..engine.search import search
        evaluate_fn = None
        if shard is not None and ui.in_align:
            # reads sharded by qname whatever their number: on one H100
            # neither evaluator was the faster across read counts from
            # 249 to 10,000 (PERF.md section 5), and this one loads a
            # shard instead of every record
            from ..engine.evaluate import distributed_evaluator
            evaluate_fn = distributed_evaluator()
        search(graph, alignments if ui.in_align else None, ui.node_file,
               ui.source, ui.destination, ui.dijkstra_steps, ui.min_nodes,
               ui.return_all_paths, out, evaluate_fn=evaluate_fn, device=device)
    elif mode == 4:
        nodelist = _read_nodelist(ui.node_file)
        alignments.filter_by_nodelist(nodelist, ui.min_nodes)
        if ui.out_file:
            alignments.output(ui.out_file, out)
    elif mode == 5:
        if graph is None:
            print("evalPath: missing input graph (-f)", file=sys.stderr)
            return 1
        from ..engine.evalpath import eval_path
        eval_path(graph, alignments, ui.path, out, device=device)
    return 0


def _read_nodelist(node_file: str) -> List[str]:
    with open(node_file) as fh:
        return [line.rstrip("\n") for line in fh if line.rstrip("\n") != ""]


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run one CLI invocation (the `gfalign-torch` script, `python -m
    gfalign_torch`); `device` None means GFALIGN_TORCH_DEVICE, and CUDA
    when that is unset."""
    import os

    from ..utils.fmt import cout
    cout.reset()  # fresh process state when called in-process (tests)
    args = list(sys.argv[1:] if argv is None else argv)
    ui = parse_args(args)
    ui.cmd_echo = [sys.argv[0] if argv is None else "gfalign"] + args
    if device is None:
        device = os.environ.get("GFALIGN_TORCH_DEVICE") or None
    return run(ui, resolve_device(device))


if __name__ == "__main__":
    raise SystemExit(main())
