"""The harness finds every cell, configuration, mix, limit and metric
reader by name from files of their own, and BENCHMARK.json keeps to the
contract's shape."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert names == ["pairs_per_s", "pairs_per_s.bf16", "pairs_per_s.b1",
                     "peak_gib", "setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.name == workload and cell.chips == 1
    assert cell.traffic["recipe"]["optim"] == "adam"
    assert set(cell.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert callable(cell.build_reference)
    rate = {"recipe_f32": "pairs_per_s.b1", "fast_b8_bf16":
            "pairs_per_s.bf16"}.get(workload.split(".")[1], "pairs_per_s")
    assert {m["name"] for m in cell.end_to_end} == {
        rate, "peak_gib", "setup_s"}
    assert len(cell.per_layer) == 9
    for m in cell.per_layer:
        assert m["moves"] == rate
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_file(metric):
    path = os.path.join(spec.HERE, "metrics", metric["name"] + ".py")
    assert os.path.isfile(path)
    assert metric["moves"].startswith("pairs_per_s")


def test_config_files_are_the_configs_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
