"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and each per-layer metric's arrow to an end-to-end metric of its cells."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def names():
    out = [w["name"] for w in MANIFEST["workloads"]] + [c["name"] for c in MANIFEST["configs"]]
    out += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    out += [w["traffic"] for w in MANIFEST["workloads"]] + [w["config"] for w in MANIFEST["workloads"]]
    return out


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("name", names())
def test_names_in_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_keys_and_unit(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_of_its_cells(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    target = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in target or cell in target["workloads"], (metric["name"], cell)


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in MANIFEST["per_layer"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").exists()


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file_under_paths(config):
    assert config["file"].startswith("portbench/")
    doc = json.loads((ROOT / config["file"]).read_text())
    assert doc["name"] == config["name"] and doc["source"] == config["source"]
    assert len(config["source"]) <= 200
