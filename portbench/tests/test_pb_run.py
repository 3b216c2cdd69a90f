"""A whole run on the CPU at a tiny size, past the harness's look for a
card: the program's records against the plain reference (the port's CPU
path), no JAX loaded, and `correct` false when the timed path is broken
underneath or when the control stands in the program's place. And the
harness's batches are run_fc_aln's, item for item."""

import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT
from portbench import feed, harness, registry

RUN = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from portbench import harness
man = json.loads({man!r})
res = harness.run_cell({cell!r}, man, {seed}, 2.0, {trace}, t0, device="cpu",
                       bench_dir={bench!r}, log=lambda s: None)
print(json.dumps(dict(res=res, loaded=harness.forbidden_modules())))
"""


@pytest.mark.parametrize("cell,trace", [("tiny.regions", True),
                                        ("tiny.offtarget90", False)])
def test_sound_run_is_correct_and_loads_no_jax(tiny_db, cell, trace):
    path, man = tiny_db
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=ROOT, man=json.dumps(man),
                                          cell=cell, seed=2 ** 31 + 5,
                                          trace=trace, bench=path)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["res"]
    assert got["loaded"] == []
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["checks"]["mismatched_pairs"] == {"value": 0, "limit": 0}
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    want = {m["name"] for m in registry.cell_metrics(man, cell, trace)}
    if trace:
        # the CPU has no device trace: the card's readers find nothing
        assert names == want - {"dp_kernels_pct", "device_idle_pct"}
        assert {"prep_wall_pct", "dp_pct", "index_upload_s"} <= names
        assert "busy_s" in res["device"] and "breakdown" in res
    else:
        assert names == want == {"host_rss_peak_gib", "setup_s"}


def _shift_positions(blob: bytes) -> bytes:
    """Every record of a batch's blob one base to the right."""
    out, o = bytearray(blob), 0
    while o < len(out):
        n = struct.unpack_from("<i", out, o)[0]
        pos = struct.unpack_from("<i", out, o + 8)[0]
        struct.pack_into("<i", out, o + 8, pos + 1)
        o += 4 + n
    return bytes(out)


def _alter_answers(eng):
    emit = eng._emit_tail
    eng._emit_tail = lambda *a, **k: _shift_positions(emit(*a, **k))


def _drop_half_the_batch(eng):
    stream = eng.align_stream

    def half(batches):
        for seqs, oris, aux in batches:
            h = len(seqs) // 4 * 2
            yield seqs[:h], oris[:h], tuple(x[:h] for x in aux)

    eng.align_stream = lambda batches: stream(half(batches))


@pytest.mark.parametrize("fault", [_alter_answers, _drop_half_the_batch])
def test_broken_timed_path_is_not_correct(tiny_db, fault):
    import torch

    torch.set_num_threads(1)
    path, man = tiny_db
    res = harness.run_cell("tiny.regions", man, 77, 2.0, False,
                           time.perf_counter(), device="cpu",
                           bench_dir=path, engine_hook=fault,
                           log=lambda s: None)
    assert not res["correct"]
    assert res["checks"]["mismatched_pairs"]["value"] > 0


def test_control_is_not_correct(tiny_db):
    from portbench import control

    path, man = tiny_db
    r = control.control_readings("tiny.regions", 3, 2.0, bench_dir=path,
                                 man=man)
    assert r["mismatched_pairs_reference"] == 0
    assert r["mismatched_pairs_control"] > 0, r


def test_batches_are_run_fc_alns(tiny_db, tmp_path, monkeypatch):
    """The harness keeps its own copy of run_fc_aln's chunk_stream and
    native-emit batch_stream (it times each batch and stops at the
    window's end): on one FASTQ, both hand the engine the same items."""
    import argparse

    import torch

    from pansvr_tpu_torch.cli import main as cli_main
    from pansvr_tpu_torch.pipeline import read_signal_fastq

    from conftest import tiny_config

    torch.set_num_threads(1)
    path, _ = tiny_db
    db_dir = os.path.join(path, "cache", "tiny")
    with open(os.path.join(path, "mixes", "regions.json")) as fh:
        mix = json.load(fh)
    pool, offs, smp = feed.make_pool(db_dir, tiny_config(), mix, 2 ** 33 + 3,
                                     2000, workers=2)
    fq, status = tmp_path / "signal.fq", tmp_path / "status.sam"
    fq.write_bytes(pool)
    status.write_text(smp.status_text())
    step = mix["batch_reads"]
    n_full = (len(offs) - 1) * 2 // step
    seen = []

    def capture(chunks_a, eng, pe, writer, ori_writer, header, filt,
                batch_stream):
        assert getattr(eng, "_emit_ctx", None) is not None
        seen.extend(batch_stream())
        writer.close()

    monkeypatch.setattr(cli_main, "_run_aln_stream", capture)
    args = argparse.Namespace(
        index_dir=os.path.join(db_dir, "rdbg"),
        header_sam=os.path.join(db_dir, "header.sam"),
        status_file=str(status), device="cpu",
        output=str(tmp_path / "out.bam"), output_ori=None, batch=step,
        signal_fq=str(fq), trace=None)
    cli_main.run_fc_aln(args)
    with open(fq) as fh:
        takes = []
        mine = list(harness.batch_items(
            harness.chunks(read_signal_fastq(fh), step, n_max=n_full), takes))
    assert n_full >= 2 and len(takes) == n_full
    assert len(seen) >= n_full
    for (s1, o1, a1), (s2, o2, a2) in zip(mine, seen):
        assert s1 == s2 and a1 == a2
        # the originals: an array the native parser fills, or objects
        assert type(o1) is type(o2) and len(o1) == len(o2)
        if isinstance(o1, np.ndarray):
            assert o1.dtype == o2.dtype and np.array_equal(o1, o2)
        else:
            assert [vars(x) for x in o1] == [vars(x) for x in o2]
