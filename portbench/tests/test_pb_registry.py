"""The harness finds a cell's parts by name: a configuration, a mix and a
per-layer metric that it has never heard of, added as files."""

import json
import os

from portbench import registry


def test_finds_files_it_did_not_know(tmp_path):
    bench = str(tmp_path)
    for d in ("configs", "mixes", "metrics"):
        os.makedirs(os.path.join(bench, d))
    with open(os.path.join(bench, "configs", "newdb.json"), "w") as fh:
        json.dump({"database": {"n_sv": 7}}, fh)
    with open(os.path.join(bench, "mixes", "burst-1.json"), "w") as fh:
        json.dump({"on_target_share": 0.5}, fh)
    with open(os.path.join(bench, "metrics", "queue_ms.serve.py"), "w") as fh:
        fh.write("def read(ctx):\n    return ctx['window_s'] * 2\n")
    man = {"workloads": [{"name": "newdb.burst-1", "config": "newdb",
                          "traffic": "burst-1", "chips": 1, "why": "x"}],
           "end_to_end": [{"name": "reads_per_s"}],
           "per_layer": [{"name": "queue_ms.serve",
                          "workloads": ["newdb.burst-1"]},
                         {"name": "elsewhere", "workloads": ["other.cell"]},
                         {"name": "everywhere"}]}
    w = registry.workload(man, "newdb.burst-1")
    cfg, path = registry.config(w["config"], bench)
    assert cfg["database"]["n_sv"] == 7 and path.endswith("newdb.json")
    assert registry.mix(w["traffic"], bench)[0]["on_target_share"] == 0.5
    assert registry.metric_reader("queue_ms.serve", bench)(
        {"window_s": 3.0}) == 6.0
    names = [m["name"] for m in registry.cell_metrics(man, w["name"], True)]
    assert names == ["queue_ms.serve", "everywhere"]
    assert [m["name"] for m in registry.cell_metrics(man, w["name"], False)] \
        == ["reads_per_s"]


def test_the_manifest_cells_resolve():
    man = registry.manifest()
    for w in man["workloads"]:
        registry.config(w["config"])
        registry.mix(w["traffic"])
    for m in man["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
