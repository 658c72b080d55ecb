"""BENCHMARK.json against the rules of its contract, and the files it
names."""

import json
import os
import re

import pytest

from slambench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    # A full check of 24 cells fits into its 43,200 seconds.
    full = ((2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200)
    assert full <= 43200


def test_names_units_and_lines(bench):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def _reports(bench, workload):
    return {m["name"] for m in bench["end_to_end"]
            if harness.applies(m, workload)}


def test_moves_are_reported_where_read(bench):
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m.get("workloads", names):
            assert w in names
            assert m["moves"] in _reports(bench, w), (m["name"], w)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = _reports(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, w["name"]) for m in bench["per_layer"])


def test_files_found_by_name(bench):
    assert bench["paths"] == ["slambench"]
    for c in bench["configs"]:
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(ROOT, "slambench", "limits",
                                           c["name"] + ".json"))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "slambench", "traffic",
                                           w["traffic"] + ".json"))
        assert any(c["name"] == w["config"] for c in bench["configs"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
