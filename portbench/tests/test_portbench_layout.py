"""Every cell, configuration and metric of BENCHMARK.json resolves to its
file by name, and the file keeps the contract's shapes."""
import json
import re
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    path = ROOT / cfg["file"]
    assert path == ROOT / "portbench" / "configs" / f"{cfg['name']}.json"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data
    for mod in (data["dataset"], data["reference"]):
        assert (ROOT / "portbench" / "datasets" / f"{data['dataset']}.py").is_file()
        assert (ROOT / "portbench" / "reference" / f"{data['reference']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    wl = json.loads((ROOT / "portbench" / "workloads" / f"{cell['traffic']}.json").read_text())
    assert wl["config"] == cell["config"]
    assert (ROOT / "portbench" / "clients" / f"{wl['client']}.py").is_file()
    assert (ROOT / "portbench" / "loops" / f"{wl['loop']}.py").is_file()
    with open(ROOT / "portbench" / "queries" / wl["templates"], "rb") as f:
        templates = tomllib.load(f)
    assert set(wl["queries"]) <= set(templates)
    # every cell reports setup_s, another end-to-end metric, a per-layer metric,
    # and the end-to-end metric each of its per-layer metrics moves
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                               "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
