"""The port's program spans (pansvr_tpu_torch/utils/trace.py) on the CPU,
plain path, through run_fc_aln on a small signal world: the engine's
split timers keep their identities; with no profiler nothing is
recorded and no profiler range is opened; under torch.profiler the main
thread's `pansvr.*` ranges never overlap and sit on the recorder's
stamps once its clock offset is applied, every batch id shows each
phase from its source to its BAM write, the prep worker's spans end
before their batch's prep wait does, a retried batch keeps its id, the
main thread is under spans for most of the stream, and fc_aln --trace
writes the worker's track into trace.json."""

import argparse
import json
import os
import shutil
from collections import defaultdict

import pytest
import torch

from pansvr_tpu_torch.align.bam_out import EmitContext
from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig
from pansvr_tpu_torch.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu_torch.cli.main import run_fc_aln
from pansvr_tpu_torch.index.builder import build_index
from pansvr_tpu_torch.index.store import load_any, save_index
from pansvr_tpu_torch.io.bam import BamHeader
from pansvr_tpu_torch.pipeline import read_signal_fastq
from pansvr_tpu_torch.signal.extract import SignalOptions, extract_signal
from pansvr_tpu_torch.utils import trace
from pansvr_tpu_torch.utils.simulate import (DictGenome, make_dataset,
                                             write_sim_bam)

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

BATCH = 32
# what every batch of the native-emit stream passes through, by span
PHASES = {"source", "prep", "prep_wait", "chain_wait", "collect",
          "dp_dispatch", "dp_wait", "replay", "emit", "bam_write"}
# the profiled runs leave every DP problem to the host's scalar DP (no
# size class holds one): the plain path's DP kernels issue so many small
# ops that the profile of a stream would take minutes to read here
HOST_DP = dict(dp_q=1, dp_t=1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_torch_engine.py's CLI world, grown to 800 pairs (250
    signal reads, 8 batches of 32), made with the port's own modules."""
    d = tmp_path_factory.mktemp("trace_world")
    ds = make_dataset(seed=21, n_sv=8, n_pairs=800, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    save_index(build_index([(c.name, c.seq) for c in contigs],
                           first_level_bases="auto"), str(d / "rdbg"))
    write_sim_bam(ds, str(d / "sim.bam"))
    with open(d / "signal.fq", "w") as fh:
        stats = extract_signal(
            str(d / "sim.bam"), fh,
            opts=SignalOptions(discard_both_full_match=True,
                               not_using_filter=True))
    (d / "status.sam").write_text(stats.status_file_text())
    with open(d / "header.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    return d


def _ranges(prof) -> list:
    """(name, start us, end us) of the `pansvr.*` ranges of a finished
    profile, by start."""
    from torch.autograd import DeviceType

    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(trace.PREFIX)), key=lambda r: r[1])


def _args(d, out, trace_dir=None):
    # a copy of the index per run: fc_aln rewrites its engine_tune.json
    idx = out.with_suffix(".rdbg")
    shutil.copytree(d / "rdbg", idx)
    return argparse.Namespace(
        index_dir=str(idx), header_sam=str(d / "header.sam"),
        status_file=str(d / "status.sam"), device="cpu",
        output=str(out), output_ori=None, batch=BATCH,
        signal_fq=str(d / "signal.fq"),
        trace=None if trace_dir is None else str(trace_dir))


@pytest.fixture(scope="module")
def untraced(world, tmp_path_factory):
    """A stream with no profiler, the plain DP on the CPU; opening a
    profiler range fails it."""
    out = tmp_path_factory.mktemp("untraced") / "out.bam"

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "_Range", refuse)
        eng = run_fc_aln(_args(world, out),
                         config=EngineConfig(dp_q=48, dp_t=64, dp_chunk=128))
    return eng


@pytest.fixture(scope="module")
def traced(world, tmp_path_factory):
    """The same stream under a CPU profile, written by fc_aln --trace:
    (engine, profile, trace directory)."""
    d = tmp_path_factory.mktemp("traced")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    eng = run_fc_aln(_args(world, d / "out.bam", d / "trace"),
                     config=EngineConfig(**HOST_DP), tracer=prof)
    return eng, prof, d / "trace"


@pytest.mark.parametrize("run", ["untraced", "traced"])
def test_split_timers_keep_their_identities(run, request):
    eng = request.getfixturevalue(run)
    p = (eng if run == "untraced" else eng[0]).prof
    assert p["n_batches"] >= 6
    assert p["host_submit"] == pytest.approx(
        p["prep_wait"] + p["front_enqueue"], rel=1e-9)
    assert p["dp_dispatch"] == pytest.approx(
        p["dp_layout"] + p["dp_enqueue"], rel=1e-9)
    assert 0 < p["emit_s"] <= p["host_replay"]
    assert p["source_s"] > 0 and p["bam_write_s"] > 0
    assert 0 < p["prep_cpu_s"] and p["prep_s"] > 0
    assert "front_run" not in p


def test_no_profiler_records_nothing(untraced):
    assert untraced.tr.ring is None and untraced.tr.ranges is None
    assert untraced.prof["n_dp_chunks"] > 0       # the DP ran on the CPU


def test_main_ranges_are_flat_and_on_the_recorders_clock(traced):
    eng, prof, _ = traced
    evs = _ranges(prof)
    assert len(evs) == len(eng.tr.ranges) > 100
    for (_, _, e0), (_, s1, _) in zip(evs, evs[1:]):
        assert e0 <= s1 + 1e-3
    off, pairs = trace.match(eng.tr, evs)
    assert len(pairs) == len(evs)
    # the profiler stamps each end inside the call that opens or closes
    # the range, which the recorder stamps on both sides
    for (_, _, _, t0, t1, d0, d1), (_, s, e) in pairs:
        assert t0 / 1e3 + off - 100 <= s <= (t0 + d0) / 1e3 + off + 100
        assert t1 / 1e3 + off - 100 <= e <= (t1 + d1) / 1e3 + off + 100


def test_every_batch_shows_each_phase(traced):
    eng = traced[0]
    seen = defaultdict(set)
    for s in eng.tr.ring:
        seen[s.batch].add(s.name)
    n = int(eng.prof["n_batches"])
    for b in range(n):
        assert PHASES <= seen[b], (b, PHASES - seen[b])
    assert set(range(n)) <= set(seen)


def test_worker_prep_ends_before_its_prep_wait(traced):
    eng = traced[0]
    waits = {s.batch: s for s in eng.tr.ring
             if s.main and s.name == "prep_wait"}
    workers = [s for s in eng.tr.ring if not s.main]
    assert workers and {s.name for s in workers} == {"prep"}
    for s in workers:
        assert s.t1 <= waits[s.batch].t1 + 100_000, s
        assert 0 < s.attrs["reads"] <= BATCH and s.attrs["cpu_s"] >= 0


def test_main_thread_is_under_spans(traced):
    p = traced[0].prof
    assert p["main_traced_s"] - p["engine_build"] >= 0.8 * p["stream_s"]


def test_trace_json_holds_the_worker_track(traced):
    eng, _, d = traced
    with open(d / "trace.json") as fh:
        evs = json.load(fh)["traceEvents"]
    worker = [e for e in evs if e.get("cat") == "pansvr"]
    main = [e for e in evs if e.get("ph") == "X"
            and e.get("name", "").startswith("pansvr.")
            and e.get("cat") == "cpu_op"]
    n_worker = sum(1 for s in eng.tr.ring if not s.main)
    assert len(worker) == n_worker > 0
    assert all(e["name"] == "pansvr.prep" and e["args"]["batch"] >= 0
               for e in worker)
    assert len(main) == len(eng.tr.ranges)
    assert all("batch" in e["args"] for e in main)
    assert {e["tid"] for e in worker}.isdisjoint({e["tid"] for e in main})
    # the worker's spans fall inside the profiled stream
    lo = min(e["ts"] for e in main)
    hi = max(e["ts"] + e["dur"] for e in main)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in worker)


def test_retried_batch_keeps_its_id(world):
    """One lane a row in the flat front pool: the batch overflows, the
    engine widens the pool and dispatches it again under its own id."""
    d = world
    header = BamHeader.from_sam_text((d / "header.sam").read_text())
    eng = AlignEngine(load_any(str(d / "rdbg")), device="cpu",
                      ori_chrom_names=header.ref_names,
                      config=EngineConfig(nf_mult=1, **HOST_DP))
    eng.set_native_emit(EmitContext(eng.host, header, 600, 200, 150))
    recs = list(read_signal_fastq(str(d / "signal.fq")))[:192]
    from pansvr_tpu_torch.align import native_glue

    batches = [([r[1] for r in recs[i:i + 96]],
                native_glue.parse_comments([r[3] for r in recs[i:i + 96]]),
                ([r[0] for r in recs[i:i + 96]],
                 [r[2] for r in recs[i:i + 96]],
                 [r[3] for r in recs[i:i + 96]]))
               for i in (0, 96)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = list(eng.align_stream(iter(batches)))
    assert len(out) == 2 and eng.prof["n_retry"] >= 1
    first = [s for s in eng.tr.ring if s.batch == 0]
    retries = {s.retry for s in first if s.name == "prep"}
    assert {0, 1} <= retries
    assert any(s.name == "redispatch" and s.retry == 1 for s in first)
    assert any(s.name == "replay" and s.retry >= 1 for s in first)
    assert {s.batch for s in eng.tr.ring if s.name == "replay"} == {0, 1}
