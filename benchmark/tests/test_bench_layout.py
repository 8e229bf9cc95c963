"""Every cell, configuration, mix and metric is a file found by name, and
BENCHMARK.json keeps to the shape the harness reads."""
import json
import re
import shutil

import pytest

import harness

BENCH = harness.HERE
DATA = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
#: BENCHMARK.json with the shelved cells, which keep to the same shape
ALL = harness.catalog(shelved=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in DATA["workloads"]]


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["benchmark"]
    assert 1 <= DATA["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell, ALL)
    assert c.driver_path.exists()
    assert c.config["name"] == c.entry["config"]
    for spec in c.end_to_end:
        assert hasattr(c.reader(spec, layer=False), "read")
    for spec in c.per_layer:
        assert hasattr(c.reader(spec, layer=True), "read")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    assert config["assumed"]


@pytest.mark.parametrize("bench", [DATA, ALL], ids=["benchmark", "shelved"])
def test_names_and_units(bench):
    cells = [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics] + cells
             + [c["name"] for c in bench["configs"]])
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")
    layers = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in layers
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in layers[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_adding_a_cell_edits_no_file(tmp_path):
    """A new cell is a new mix file and a new entry: the harness finds both
    without a change to any file it already has."""
    home = tmp_path / "benchmark"
    shutil.copytree(BENCH, home, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}
    (home / "mixes" / "frames512.json").write_text(json.dumps(
        {"driver": "frames", "size": 512, "poses": 4, "jitter_deg": 5.0,
         "trace_steps": 8}))
    bench = json.loads(json.dumps(DATA))
    bench["workloads"].append({"name": "trex14k.frames512", "config": "trex14k",
                               "traffic": "frames512", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "trex14k.frames1024" in m.get("workloads", []):
            m["workloads"].append("trex14k.frames512")
    cell = harness.Cell("trex14k.frames512", bench, home=home)
    assert cell.traffic["size"] == 512
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "frame_p95_ms",
                                                    "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
