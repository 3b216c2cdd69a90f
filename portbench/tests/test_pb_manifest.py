"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files, and the run length a full check fits with 24 cells."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32
    assert all(TEXT.match(w) for w in m["command"])
    assert all(PATH.match(p) and ".." not in p.split("/") for p in m["paths"])
    for word in m["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"]), word
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


def test_configs_and_cells():
    m = manifest()
    names = [c["name"] for c in m["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert c["name"] in used
    cells = [w["name"] for w in m["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) \
        == len(cells)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert os.path.exists(os.path.join(BENCH, "mixes",
                                           w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(cells) // 4)


def test_metrics():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [x["name"] for x in m["per_layer"]]
    assert len(set(names)) == len(names)
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    layers = {}
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["moves"] in e2e and TEXT.match(x["layer"])
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(x.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           x["name"] + ".py"))
        layers.setdefault(x["layer"], x["layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        assert any(c in x.get("workloads", [c]) for x in m["per_layer"])


def test_files_under_paths_use_name_characters():
    for base, _, files in os.walk(BENCH):
        if any(p in base for p in ("__pycache__", os.sep + "cache",
                                   os.sep + "out")):
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH.match(rel), rel
