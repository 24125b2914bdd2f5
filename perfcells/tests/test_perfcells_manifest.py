"""``BENCHMARK.json`` against the benchmark's schema, and every file it
names present. CPU only."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    for w in bench["command"]:
        assert not w.startswith("/") and ".." not in w
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(bench):
    cfgs = bench["configs"]
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    wls = bench["workloads"]
    assert 1 <= len(wls) <= 24
    names = [w["name"] for w in wls]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in wls]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in wls) <= max(1, len(wls) // 4)
    cfg_names = {c["name"] for c in bench["configs"]}
    for w in wls:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfg_names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        with open(os.path.join(ROOT, "perfcells", "cells",
                               w["name"] + ".json")) as f:
            cell = json.load(f)
        assert cell["config"] == w["config"]
        assert os.path.isfile(os.path.join(ROOT, "perfcells", "drivers",
                                           cell["driver"] + ".py"))
        assert cell["limits"], "a cell compares at least one number"


def test_metrics(bench):
    e2e, pl = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in pl:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", cells)
        assert os.path.isfile(os.path.join(ROOT, "perfcells", "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        reported = [m for m in e2e if c in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(c in m["workloads"] for m in pl)
