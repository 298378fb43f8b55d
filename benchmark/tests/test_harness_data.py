"""Cells, configurations, traffic mixes and metrics are found by name from
BENCHMARK.json, and the file keeps to the benchmark's contract."""
import importlib
import json
import os
import re

import pytest

from benchmark import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_bounds():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell, config, mix = R.load_cell(w["name"])
        assert config["name"] == w["config"]
        assert importlib.import_module(f"benchmark.traffic.{mix['kind']}")
        assert cell["per_layer"], "every cell reports a per-layer metric"
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("entry", bench()["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert all(k in config for k in entry["reduced"])
    assert config["flags"] == ["-a"] and config["threads"] == 8


@pytest.mark.parametrize("m", bench()["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
    empty = dict(timers={}, counters={}, frags=0, bases=0, window_s=1.0,
                 device=None)
    assert reader.read(empty) is None     # nothing to read: no number


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        R.load_cell("no-such-cell")
