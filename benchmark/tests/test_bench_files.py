"""BENCHMARK.json and the files it names: each parses, keeps to the
contract's shapes, and agrees with the files it finds by name."""

import json
import re

import pytest

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = common.benchmark_spec()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_parse(cell):
    entry, config, traffic = common.cell_files(SPEC, cell)
    assert config["name"] == entry["config"]
    assert traffic["mode"] in ("align", "search")
    assert set(traffic["limits"]) and all(v >= 0 for v in traffic["limits"].values())
    e2e = {m["name"] for m in common.metrics_of(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert common.metrics_of(SPEC, cell, "per_layer")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(metric):
    mod = common.load_reader(metric["name"])
    assert mod.LAYER == metric["layer"] and mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"] and mod.MOVES == metric["moves"]
    moves = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(moves["workloads"])
    assert mod.read({}) is None


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((common.ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert data["assumed"]
    for key in data["reduced"]:     # a cut of scale, never of a width
        assert key in data and NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_len", "band"))
    if "reads" in data["reduced"]:
        assert "n_reads" in data["cut"]
