"""CPU tests of the benchmark (python -m pytest portbench/tests -q).

Tests that need a card carry the `cuda` marker and skip inside the
`cuda_device` fixture; none of the benchmark's own checks needs one.
"""

import json
import os
import shutil
import sys

import pytest

os.environ.setdefault("OMP_NUM_THREADS", "1")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
BENCH = os.path.join(ROOT, "portbench")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_config(**database):
    """chrom2k's configuration cut to a CPU test's size."""
    with open(os.path.join(BENCH, "configs", "chrom2k.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny"
    cfg["database"].update(dict(n_sv=24, seed=5, chrom_lengths={
        "chr1": 200_000, "chr2": 150_000}), **database)
    cfg["sample"]["pairs"] = 6000
    return cfg


def tiny_bench(path, cells=("tiny.regions", "tiny.offtarget90")) -> dict:
    """A bench folder at `path` with the tiny configuration, both mixes at
    a CPU batch size, and the real metric readers; returns a manifest of
    its cells."""
    os.makedirs(os.path.join(path, "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "mixes"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(path, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(path, "configs", "tiny.json"), "w") as fh:
        json.dump(tiny_config(), fh)
    for m in ("regions", "offtarget90"):
        with open(os.path.join(BENCH, "mixes", f"{m}.json")) as fh:
            d = json.load(fh)
        d.update(batch_reads=256, warmup_batches=1, pool_reads_per_s=300,
                 check_pairs=32 if m == "regions" else 128)
        with open(os.path.join(path, "mixes", f"{m}.json"), "w") as fh:
            json.dump(d, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        man = json.load(fh)
    man["workloads"] = [dict(name=c, config=c.split(".")[0],
                             traffic=c.split(".")[1], chips=1, why="test")
                        for c in cells]
    # each metric in the tiny cells of the mixes whose cells report it
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            mixes = {w.split(".")[1] for w in m["workloads"]}
            m["workloads"] = [c for c in cells if c.split(".")[1] in mixes]
    # every reader the folder holds, also those no cell lists yet, in
    # every tiny cell's traced run
    listed = {m["name"] for m in man["per_layer"]}
    for f in sorted(os.listdir(os.path.join(BENCH, "metrics"))):
        if f.endswith(".py") and f[:-3] not in listed:
            man["per_layer"].append(dict(
                name=f[:-3], unit="x", better="lower", source="program_span",
                layer="test", moves="setup_s"))
    return man


@pytest.fixture(scope="session")
def tiny_db(tmp_path_factory):
    """The tiny configuration's database, built once for the session by
    the benchmark's own builder (the program's fc_index and the
    reference's index)."""
    from portbench import db

    path = str(tmp_path_factory.mktemp("bench"))
    man = tiny_bench(path)
    cfg_path = os.path.join(path, "configs", "tiny.json")
    import subprocess

    subprocess.run([sys.executable, "-m", "portbench.db", cfg_path,
                    os.path.join(path, "cache", "tiny")], check=True,
                   cwd=ROOT)
    assert db.is_built(os.path.join(path, "cache", "tiny"), tiny_config())
    return path, man
