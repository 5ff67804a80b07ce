"""Device memory of the exact full-matrix walk: the bytes its buffers take
(the program's counter kernels.seqalign.walk_bytes: codes, boundary rows,
hand-over columns, result) over the cells of the rectangles asked for
(align.traceback.full_cells), over the window, in bytes a cell."""

LAYER = "walk kernel"
SOURCE = "program_counter"
UNIT = "B/cell"
MOVES = "align_reads_per_s"


def read(obs):
    counts = obs.get("counts")
    if obs.get("mode") != "align" or not counts:
        return None
    cells = counts.get("align.traceback.full_cells", 0)
    if "kernels.seqalign.walk_bytes" not in counts or cells <= 0:
        return None
    return counts["kernels.seqalign.walk_bytes"] / cells
