"""Finds a cell's parts by name: the manifest (BENCHMARK.json at the
checkout's root) names each cell's configuration and traffic mix and the
metrics; each configuration is configs/<name>.json, each mix
mixes/<name>.json and each per-layer metric a reader metrics/<name>.py
with a function read(ctx) that returns the value, or None where the run
had nothing to read. A new cell, configuration, mix or metric is a new
file and a new manifest entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, bench_dir: str) -> tuple[dict, str]:
    path = os.path.join(bench_dir, kind, f"{name}.json")
    with open(path) as fh:
        return json.load(fh), path


def config(name: str, bench_dir: str = BENCH_DIR) -> tuple[dict, str]:
    return _json("configs", name, bench_dir)


def mix(name: str, bench_dir: str = BENCH_DIR) -> tuple[dict, str]:
    return _json("mixes", name, bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The read(ctx) function of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The manifest's metrics a cell reports: its end-to-end ones, or with
    trace its per-layer ones (those without a `workloads` list, and those
    whose list names the cell)."""
    ms = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in ms if cell in m.get("workloads", [cell])]
