"""BENCHMARK.json against the contract's shape, and every item it names
found by name."""

import json
import re

import pytest

from benchmark import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = R.load_manifest()
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_every_item_of_a_cell_is_found_by_name(cell, trace):
    plan = R.Plan(BENCH, cell, trace)
    assert plan.config["entry"] == "pipeline_run"
    assert set(plan.limits) == {"alpha_mad", "rgba_mismatch",
                                "palette_mismatch"}
    names = [m["name"] for m, _ in plan.metrics]
    assert names, "every cell reports metrics of both kinds"
    for _, reader in plan.metrics:
        assert callable(reader.read)
    if not trace:
        assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("kind,key", [("configs", "config"),
                                      ("traffic", "traffic")])
def test_a_missing_item_names_its_file(kind, key):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0][key] = "no_such_item"
    with pytest.raises(FileNotFoundError, match=f"benchmark/{kind}/"
                       "no_such_item.json"):
        R.Plan(bench, bench["workloads"][0]["name"], False)


def test_a_missing_metric_reader_names_its_file():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="no_such"))
    with pytest.raises(FileNotFoundError,
                       match="benchmark/metrics/no_such.py"):
        R.Plan(bench, CELLS[0], True)


def test_a_metric_listed_for_some_cells_is_read_only_there():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["workloads"] = [CELLS[0]]
    name = bench["per_layer"][0]["name"]
    assert name in [m["name"] for m in R.metrics_of(bench, CELLS[0], True)]
    assert name not in [m["name"] for m in R.metrics_of(bench, CELLS[1],
                                                        True)]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_what_is_run(cfg):
    with open(R.ROOT / cfg["file"]) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert body["source"] == cfg["source"]
