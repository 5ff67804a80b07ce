"""`correct` has to come out false for the control and for each fault a
cell can have.  Each test skips the harness's look for a card and drives
the rest of a run of a small cell on the CPU (tests/small.py), with the
timed path broken underneath where the fault says; a sound run of the
same cell comes out correct.

Faults that these cells cannot have: a step returning its state
unchanged (no call carries state into the next) and the exchange between
chips left out (every cell runs on one chip)."""

import pytest

from benchmark.tests.small import run_small


@pytest.mark.parametrize("cell", ["hifi.align", "clr.align", "hifi.search",
                                  "hifi.search_tangle"])
def test_sound_run_is_correct(cell):
    result, checks = run_small(cell, seed=2 ** 31 + 3)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", ["hifi.align", "clr.align", "hifi.search",
                                  "hifi.search_tangle"])
def test_control_is_not_correct(cell):
    result, checks = run_small(cell, seed=2 ** 31 + 4, control=True)
    assert result["correct"], checks
    assert not result["control"]["correct"], result["control"]["checks"]


def test_align_half_the_reads_left_out(monkeypatch):
    from gfalign_torch.engine import graph_align

    real = graph_align.emit_gaf
    monkeypatch.setattr(graph_align, "emit_gaf",
                        lambda results, write: real(results[::2], write))
    result, checks = run_small("hifi.align", seed=21)
    assert not result["correct"] and checks["unplaced"]["value"] > 0


def test_align_token_altered_where_produced(monkeypatch):
    from gfalign_torch.ops import seqalign

    def altered(fn):
        def call(*a, **kw):
            pl = fn(*a, **kw)
            if pl is None:
                return pl
            cigar = list(pl.cigar)
            n, op = cigar[0]
            cigar[0] = (n, "X" if op == "=" else "=")
            return pl._replace(cigar=cigar)
        return call

    monkeypatch.setattr(seqalign, "traceback", altered(seqalign.traceback))
    monkeypatch.setattr(seqalign, "banded_traceback",
                        altered(seqalign.banded_traceback))
    result, checks = run_small("hifi.align", seed=22)
    assert not result["correct"] and checks["record_faults"]["value"] > 0


@pytest.fixture
def device_ladder(monkeypatch):
    """The card's scoring ladder (K3 banded, K4 full DP) on the CPU, through
    the kernels' plain versions: the CPU's own ladder is the host's."""
    from gfalign_torch.engine import graph_align

    monkeypatch.setattr(graph_align, "align_engine", lambda device: "device")


@pytest.mark.parametrize("cell", ["hifi.align", "clr.align"])
def test_align_sound_run_on_the_device_ladder_is_correct(device_ladder, cell):
    result, checks = run_small(cell, seed=2 ** 31 + 5)
    assert result["correct"], checks


def test_align_ladder_score_altered_where_produced(monkeypatch, device_ladder):
    """K3's score of every placed pair raised by one: the traceback's parity
    gate sends each pair to the exact walk, so the records stay right and
    only the ladder's sample sees it."""
    from gfalign_torch.ops import seqalign

    real = seqalign.banded_arena_scores

    def altered(*a, **kw):
        best, bi, bj, edge = real(*a, **kw)
        return (best + (best > 0).to(best.dtype)), bi, bj, edge

    monkeypatch.setattr(seqalign, "banded_arena_scores", altered)
    result, checks = run_small("hifi.align", seed=26)
    assert not result["correct"] and checks["ladder_score_faults"]["value"] > 0
    assert checks["record_faults"]["value"] == 0


@pytest.mark.parametrize("cell", ["hifi.search", "hifi.search_tangle"])
def test_search_half_the_reads_left_out(monkeypatch, cell):
    from gfalign_torch.engine import evaluate

    real = evaluate.ReadBatch.__init__

    def half(self, read_paths, device="cuda"):
        real(self, list(read_paths)[::2], device)

    monkeypatch.setattr(evaluate.ReadBatch, "__init__", half)
    result, checks = run_small(cell, seed=23)
    assert not result["correct"] and checks["rows_differ"]["value"] > 0


def test_search_answer_altered_where_produced(monkeypatch):
    """The tallies come from the native driver on the CPU (the card's
    runs take them from evaluate_candidates): one good count is raised."""
    from gfalign_torch.io import native

    real = native.native_search

    def altered(*a, **kw):
        out = real(*a, **kw)
        rows = out.decode().split("\n")
        cols = rows[0].split("\t")
        cols[2] = str(int(cols[2]) + 1)
        rows[0] = "\t".join(cols)
        return "\n".join(rows).encode()

    monkeypatch.setattr(native, "native_search", altered)
    result, checks = run_small("hifi.search", seed=24)
    assert not result["correct"] and checks["rows_differ"]["value"] > 0
