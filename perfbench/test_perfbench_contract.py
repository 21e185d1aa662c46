"""BENCHMARK.json and the files it names: every cell, configuration,
traffic, entry and metric resolves by name to its file, and the file
keeps to the benchmark's contract (names, units, bounds, keys)."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_full_check_fits_the_limit_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert traffic["pool"] >= 3           # the first steps' rows all differ
    work = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert (HERE / "entries" / f"{work['entry']}.py").exists()
    assert set(work["limits"]) == {"loss", "grad1", "change"}
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell])
               for m in BENCH["per_layer"])


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(config):
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("perfbench/")
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["source"] == c["source"]
    assert (HERE / "reference" / f"{body['reference']}.py").exists()
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME.match(key) and key in body
        assert key in body["changed"]
        assert not re.search(r"(_dim|_rank|hidden_size|intermediate|n_embd"
                             r"|n_inner|head)", key)
    assert any(w["config"] == config for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves(metric):
    m = next(m for m in METRICS if m["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        # every cell listed reports the end-to-end metric it moves
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        reader = HERE / "metrics" / f"{metric}.py"
        tree = ast.parse(reader.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body)
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
