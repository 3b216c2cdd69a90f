"""One run of one cell: set up, warm up, measure, check, report.

The window drives the port's fc_aln stream as `run_fc_aln` runs it (its
default EngineConfig: CUDA graphs, stream depth 3, native emit): an
AlignEngine on the configuration's index store, signal reads parsed by
the program's FASTQ reader from a pipe that the sample's generator
(feed.py, a process of its own) fills, batches of the mix's size built
as run_fc_aln's native-emit batch_stream builds them, and records
written by `_run_aln_stream` through the program's BGZF writer thread.
Load is a closed loop: the engine pulls the next batch when it can take
it. The harness hands batches until the window's seconds have passed;
the window ends when the last one's records are written.

The generator makes the whole pool before the program's set-up starts,
while the measured process waits, and its seconds are left out of
setup_s: a deployment's fc_aln finds its sample's FASTQ already written.
During set-up and the window the feeder only copies the pool into the
pipe.

Spans the harness takes itself: each batch from the moment the engine
takes it off the source to the moment its records reach the writer, and
the window. Per-layer numbers come from the engine's own timers and
counters (read before and after the window) and, with --trace 1, from
torch.profiler over the window. The run's log also gives the process's
CPU seconds over the window a thousand reads, which tells a slower host
(more CPU seconds for the same reads) from a process held up elsewhere.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

from . import check, db, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "pansvr_tpu")
# K1 and K2 by name in a device trace ("void (anonymous
# namespace)::extd2_fwd_kernel<2, 4>(...)")
DP_KERNELS = ("extd2_fwd_kernel", "extd2_tb_kernel")
NAME_CHARS = 120     # a breakdown's names are cut to this length


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (pansvr_tpu_torch is not pansvr_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class TimedWriter:
    """The program's BamWriter, with the time each batch's records reach
    it (align_stream yields one blob a batch, in order)."""

    def __init__(self, writer):
        self.w = writer
        self.done: list = []

    def write_blob(self, blob: bytes) -> None:
        self.w.write_blob(blob)
        self.done.append(time.perf_counter())

    def close(self) -> None:
        self.w.close()


def pool_reads(mix: dict, seconds: float) -> int:
    """Reads the sample's pool holds: twice what the mix's assumed top
    rate takes in the window, and no fewer than the warm-up's (which
    feed.py cuts from all over the pool)."""
    return int(max(mix["warmup_batches"] * mix["batch_reads"],
                   2 * mix["pool_reads_per_s"] * seconds))


def chunks(recs, step: int, n_max=None, deadline=None):
    """Batches of `step` records off the FASTQ reader `recs` (run_fc_aln's
    chunk_stream): at most n_max, and none started after `deadline`."""
    n = 0
    while ((n_max is None or n < n_max)
           and (deadline is None or time.perf_counter() < deadline)):
        buf = [next(recs) for _ in range(step)]
        n += 1
        yield buf


def batch_items(chunk_iter, takes: list):
    """run_fc_aln's native-emit batch_stream over chunk_iter, with the
    time the engine takes each item appended to `takes`."""
    from pansvr_tpu_torch.align import native_glue
    from pansvr_tpu_torch.pipeline import parse_signal_comment

    for chunk in chunk_iter:
        comments = [p[3] for p in chunk]
        oris = native_glue.parse_comments(comments)
        if oris is None:
            oris = [parse_signal_comment(c)[0] for c in comments]
        item = ([p[1] for p in chunk], oris,
                ([p[0] for p in chunk], [p[2] for p in chunk], comments))
        takes.append(time.perf_counter())
        yield item


def end_to_end(reads: int, window_s: float, lat_ms: list, rss_gib: float,
               setup_s: float) -> dict:
    """The end-to-end metrics of a window: every read of the batches it
    handed over its wall, the 95th percentile (linear between order
    statistics) of the batches' latencies, the process's peak RSS and
    the set-up's seconds."""
    return dict(reads_per_s=reads / window_s,
                batch_p95_ms=float(np.percentile(lat_ms, 95))
                if lat_ms else None,
                host_rss_peak_gib=rss_gib, setup_s=setup_s)


def device_breakdown(prof, top: int = 10) -> tuple:
    """(busy seconds, device seconds by kernel name, the `top` kernels,
    the `top` idle gaps) of a finished profile (CPU and CUDA
    activities). Busy is the union of the device intervals of its
    kernels, copies and sets, kernels in a CUDA graph's replay included;
    each of the longest idle gaps of the card is labelled by the host
    operation that overlapped it most."""
    from torch.autograd import DeviceType

    by_name, spans, host = {}, [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
        else:
            host.append((a, b, e.name))
    spans.sort()
    gaps, busy_us = [], 0.0
    end = None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        if end is None or b > end:
            busy_us += b - (a if end is None else max(a, end))
            end = b
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], np.float64)
    he = np.array([h[1] for h in host], np.float64)
    idle = []
    for g, g0, g1 in gaps[:top]:
        ov = np.minimum(he, g1) - np.maximum(hs, g0) if len(hs) else []
        k = int(np.argmax(ov)) if len(hs) and ov.max() > 0 else -1
        idle.append([host[k][2] if k >= 0 else "no traced host op", g / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (busy_us / 1e6, by_name, [[n[:NAME_CHARS], s] for n, s in ops],
            idle)


def run_cell(cell: str, man: dict, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda",
             bench_dir: str = registry.BENCH_DIR,
             engine_hook=None, log=print) -> dict:
    """One run of `cell`; returns the result line's object. `engine_hook`
    (tests) is called with the engine before the warm-up."""
    import torch

    from pansvr_tpu_torch.align import native_glue
    from pansvr_tpu_torch.align.bam_out import EmitContext
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu_torch.align.host_align import PEScorer
    from pansvr_tpu_torch.cli.main import _run_aln_stream
    from pansvr_tpu_torch.index.store import load_any
    from pansvr_tpu_torch.io.bam import BamHeader, BamWriter
    from pansvr_tpu_torch.pipeline import read_signal_fastq
    from pansvr_tpu_torch.signal.extract import SignalStats

    w = registry.workload(man, cell)
    cfg, cfg_path = registry.config(w["config"], bench_dir)
    mix, mix_path = registry.mix(w["traffic"], bench_dir)
    root = registry.ROOT
    db_dir = os.path.join(bench_dir, "cache", w["config"])
    out_dir = os.path.join(bench_dir, "out", cell)
    built = not db.is_built(db_dir, cfg)
    if built:
        log(f"building the {w['config']} database in {db_dir}")
        subprocess.run([sys.executable, "-m", "portbench.db", cfg_path, db_dir],
                       check=True, cwd=root)
    t_db = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    n_pool = pool_reads(mix, seconds)
    rfd, wfd = os.pipe()
    feeder = subprocess.Popen(
        [sys.executable, "-m", "portbench.feed", db_dir, cfg_path, mix_path,
         str(seed), str(n_pool), str(wfd)],
        pass_fds=(wfd,), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, cwd=root, start_new_session=True)
    os.close(wfd)
    fh = None
    try:
        # the sample is made before the program's set-up, which it does
        # not count in
        ready = json.loads(feeder.stdout.readline())
        t_ready = time.perf_counter()
        gen_s = t_ready - t_db
        idx = load_any(os.path.join(db_dir, "rdbg"))
        with open(os.path.join(db_dir, "header.sam")) as f:
            header = BamHeader.from_sam_text(f.read())
        eng = AlignEngine(idx, config=EngineConfig(),
                          ori_chrom_names=header.ref_names, device=device)
        t_eng_built = time.perf_counter()
        stats = SignalStats.parse_status_text(ready["status"])
        status = dict(read_len=stats.read_len, min_isize=stats.min_isize,
                      max_isize=stats.max_isize)
        pe = PEScorer(eng.host, stats.max_isize or 600,
                      stats.min_isize or 200, stats.read_len or 150)
        if not native_glue.emit_available():
            raise RuntimeError("the native emit of the glue library is "
                               "missing (fc_aln's default path needs it)")
        eng.set_native_emit(EmitContext(
            eng.host, header, stats.max_isize or 600,
            stats.min_isize or 200, stats.read_len or 150))
        # the lane budgets a deployment's earlier runs on this index
        # converged to, as fc_aln loads them from its engine_tune.json
        if cfg.get("engine_tune"):
            tune = os.path.join(out_dir, "engine_tune.json")
            with open(tune, "w") as f:
                json.dump(cfg["engine_tune"], f)
            eng.load_tuning(tune)
        if engine_hook is not None:
            engine_hook(eng)
        fh = os.fdopen(rfd, "r", buffering=1 << 20)
        rfd = None
        recs = read_signal_fastq(fh)
        step = mix["batch_reads"]

        def run(path, chunk_iter):
            takes = []
            writer = TimedWriter(BamWriter(path, header))
            _run_aln_stream(iter(()), eng, pe, writer, None, header, 0,
                            lambda: batch_items(chunk_iter, takes))
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            return takes, writer.done

        t_eng = time.perf_counter()
        warm = mix["warmup_batches"]
        run(os.path.join(out_dir, "warmup.bam"), chunks(recs, step, n_max=warm))
        prof0 = dict(eng.prof)
        sets0 = {k: set(v) for k, v in eng.shape_sets.items()}
        tracer = contextlib.nullcontext()
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if eng.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            tracer = torch.profiler.profile(activities=acts)
        window_bam = os.path.join(out_dir, "window.bam")
        threads = len(os.listdir("/proc/self/task")) \
            if os.path.isdir("/proc/self/task") else None
        cpu0 = time.process_time()
        t_w0 = time.perf_counter()
        with tracer as prof:
            takes, done = run(window_bam,
                              chunks(recs, step, deadline=t_w0 + seconds))
            t_w1 = time.perf_counter()
        cpu_s = time.process_time() - cpu0
        window_s = t_w1 - t_w0
        rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss \
            * 1024 / 2 ** 30
        gpu_peak = int(torch.cuda.max_memory_reserved(eng.device)) \
            if eng.device.type == "cuda" else 0
        delta = {k: v - prof0.get(k, 0.0) for k, v in eng.prof.items()}
        prof_total = dict(eng.prof)
        n_win = len(takes)
        lat_ms = [1e3 * (d - t) for t, d in zip(takes, done)]
        reads = n_win * step
        setup_s = t_w0 - t0 - gen_s
        log(f"window: {n_win} batches, {reads} reads in {window_s:.3f} s, "
            f"{os.path.getsize(window_bam)} bytes of BAM; "
            f"set-up {setup_s:.3f} s: to the database "
            f"({'built' if built else 'found'}) {t_db - t0:.3f} s, then "
            f"(the sample's {ready['pairs']} pairs made in {gen_s:.3f} s, "
            f"left out) engine built {t_eng_built - t_ready:.3f} s, "
            f"warm-up of {warm} batches {t_w0 - t_eng:.3f} s")
        log(f"process CPU over the window: {cpu_s / window_s:.3f} CPUs, "
            f"{1e6 * cpu_s / max(reads, 1):.3f} ms a thousand reads; "
            f"{threads} threads in the process, torch intra-op threads "
            f"{torch.get_num_threads()}")
        eng.save_tuning(os.path.join(out_dir, "engine_tune.json"))
        with open(os.path.join(out_dir, "engine_tune.json")) as f:
            log(f"engine tuning after the window: {f.read()}")
        for kind, keys in eng.shape_sets.items():
            new = sorted(map(str, keys - sets0[kind]))
            if new:
                log(f"{kind} shape sets first met in the window: {new}")
        busy_s = by_name = ops = idle = None
        if trace:
            busy_s, by_name, ops, idle = device_breakdown(prof)
            del prof
        fh.close()
        fh = None
        # the window's pairs are the pool's first reads // 2
        pick = check.sample_pairs(seed, 0, reads // 2, mix["check_pairs"])
        feeder.stdin.write(json.dumps({"pairs": pick}) + "\n")
        feeder.stdin.flush()
        texts = json.loads(feeder.stdout.readline())
        feeder.stdin.close()
        feeder.wait(timeout=120)
        del eng, pe, idx
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_c = time.perf_counter()
        pairs = [check.parse_pair(t) for t in texts]
        ref_idx = db.load_ref_index(os.path.join(db_dir, "refindex"))
        want = check.expected_records(ref_idx, header.ref_names, status,
                                      pairs)
        got = check.bam_records(window_bam, set(want))
        bad = check.mismatched(got, want)
        log(f"check: {len(want)} pairs, "
            f"{sum(len(r) for r in want.values())} records expected, "
            f"{len(bad)} differ, {time.perf_counter() - t_c:.3f} s"
            + (f"; first: {bad[:3]}" if bad else ""))
    finally:
        if fh is not None:
            fh.close()
        if rfd is not None:
            os.close(rfd)
        if feeder.poll() is None:
            # the feeder and its chunk workers share its process group
            os.killpg(feeder.pid, signal.SIGKILL)
        feeder.wait()
    checks = {"mismatched_pairs": (len(bad), 0),
              "unwritten_batches": (n_win - len(done), 0)}
    if all(v <= lim for v, lim in checks.values()):
        shutil.rmtree(out_dir, ignore_errors=True)
    ctx = dict(window_s=window_s, prof=delta, prof_total=prof_total,
               busy_s=busy_s, kernel_s=by_name, dp_kernels=DP_KERNELS,
               batches=n_win, reads=reads)
    e2e = end_to_end(reads, window_s, lat_ms, rss_gib, setup_s)
    metrics = {}
    for m in registry.cell_metrics(man, cell, trace):
        name = m["name"]
        v = registry.metric_reader(name, bench_dir)(ctx) if trace \
            else e2e.get(name)
        if v is not None:
            metrics[name] = {"value": v, "unit": m["unit"]}
    if lat_ms:
        log(f"batch latency over {len(lat_ms)} batches: median "
            f"{float(np.median(lat_ms)):.3f} ms, p95 "
            f"{float(np.percentile(lat_ms, 95)):.3f} ms, max "
            f"{max(lat_ms):.3f} ms")
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": 1, "memory_peak_bytes": gpu_peak}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": len(want), "failed": len(bad),
           "metrics": metrics, "device": dev}
    if trace and busy_s is not None:
        dev["busy_s"] = busy_s
        dev["window_s"] = window_s
        out["breakdown"] = {"device_ops": ops, "idle_gaps": idle}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv: list, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for k in ("USE_FLAX", "USE_TF", "USE_JAX"):
        os.environ[k] = "0"
    man = registry.manifest()
    w = registry.workload(man, a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: cell {a.workload} needs {w['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    log = lambda s: print(f"[portbench] {s}", file=sys.stderr, flush=True)
    res = run_cell(a.workload, man, a.seed, a.seconds, bool(a.trace), t0,
                   log=log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0
