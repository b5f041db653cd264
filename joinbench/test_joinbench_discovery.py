"""BENCHMARK.json against the files it names, and against the contract's
limits on names, units, bounds and cells."""
import json
import math
import re

import pytest

from joinbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "joinbench/run.py"]
    assert BENCH["paths"] == ["joinbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found_and_reduced_keys_exist(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"joinbench/configs/{cfg['name']}.json"
    with open(harness.ROOT / cfg["file"]) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files_and_metrics(name):
    spec = harness.cell(name)
    assert spec["chips"] in (1, 4)
    assert spec["traffic_data"]["name"] == spec["traffic"]
    e2e = {m["name"] for m in harness.metric_names(name, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metric_names(name, True)
    assert per_layer
    for m in harness.metric_names(name, False) + per_layer:
        assert callable(harness.load_metric(m["name"]).read)


def test_every_file_is_named():
    names = {c["name"] for c in BENCH["configs"]}
    assert {p.stem for p in (harness.HERE / "configs").glob("*")} == names
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (harness.HERE / "traffic").glob("*")} == traffic
    metrics = {m["name"] for m in METRICS}
    assert {p.stem for p in (harness.HERE / "metrics").glob("*.py")} \
        == metrics


def test_names_units_and_text_fields():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_metrics_bounds_and_arrows():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_chips_and_the_check_fit_the_budget():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, math.floor(0.25 * len(CELLS)))
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
