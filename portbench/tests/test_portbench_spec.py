"""BENCHMARK.json's shape, and every configuration, traffic mix and metric
reader it names, found by name."""

import json
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in bench["configs"] + bench["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in bench["configs"]:
        assert 1 <= len(c["source"]) <= 200


def test_end_to_end_bounds(bench):
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in by_name
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_an_end_to_end_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_loads_by_name(bench):
    pairs = set()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        pairs.add((w["config"], w["traffic"]))
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert len(pairs) == len(bench["workloads"])


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_config_files_state_their_cuts(bench):
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert c["file"].startswith("portbench/configs/")
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]
        assert cfg["guarantee"] and cfg["precision"] == "float32"


def test_readers_find_nothing_in_an_empty_run(bench):
    from portbench.harness.window import RunRecord

    empty = RunRecord(config={}, traffic={})
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.reader(m["name"])(empty) is None
