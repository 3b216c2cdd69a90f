"""The chromosome-scale world end to end on the port, one process a stage
(the port's counterpart of tools/chrom_scale_run.py).

    python -m pansvr_tpu_torch.scale_run --out DIR [--pairs N]
        [--stages gen,anchor,index,signal,aln,sort,sv,sv_inline,parity,compare]
        [--device cuda|cpu]

The world is world.build_chrom_world's (seed 99, 2,000 DEL/INS/DUP SVs on
chr1 60 Mbp + chr2 40 Mbp, error 0.01, index at the auto first level)
with N read pairs (default 5,000,000). Stages, each in a process of its
own, timed (wall) with the process's own peak RSS (the largest process
of the stage: RUSAGE_CHILDREN of a wrapper around it):

  gen        world.gen_chrom_world: genome.fa, svs.vcf, header.sam, sim.bam
  anchor     fc_anchor_ref genome.fa svs.vcf > anchors.fa
  index      fc_index anchors.fa rdbg
  signal     fc_signal sim.bam -o signal.fq -s status.sam -U -D
  aln        fc_aln rdbg signal.fq header.sam -o aln.bam -b 8192
             -r status.sam --device D; adds the reads and reads/s of the
             pass, the engine's counters and phase timers, the host
             fallback share of the reads with a k-mer hit, peak GPU
             memory, the device index's bytes, K1/K2 launches by
             (kernel, Tmax, W, problems) with each shape's kernel time
             alone on its last launch's inputs and bound
             (ops/kernel_bounds.pass_table), and the engine_tune.json
             the run left
  sort       io.bai.sort_bam + build_bai: aln.sorted.bam (+ .bai)
  sv         fc_sv anchors.fa aln.sorted.bam genome.fa -o result.vcf
             -r status.sam --device D; adds requests, chunks, plan / run
             / finish seconds, the PASS count and the kernel table
  sv_inline  the same fc_sv inputs with the inline native DP
             (ContigDpBatcher(INLINE)) -> result_inline.vcf
  parity     (a) the first 16,384 signal reads: fc_aln --device cpu and
             --device D in both engine configurations (depth 3 with
             device collect, depth 1 with host collect) give identical
             BAM records; (b) the first 1,024 reads: the engine on D
             equals its HostAligner field by field; on a card, one
             profiled depth-3 pass over the 16,384 reads gives the
             device's busy share
  compare    (c) result.vcf's records equal result_inline.vcf's; (d) if
             DIR/result_jax.vcf is there (the JAX package's fc_sv over
             aln.sorted.bam, run as a command of its own), its records
             too; F1 of result.vcf against the planted SVs (svs.vcf,
             io.vcf_compare at its defaults), all records and PASS only

fc_aln and fc_sv run their subcommand's function on the subcommand's
argv (cli.main.parse_args, run_fc_aln / run_fc_sv) in a child that then
writes the counters. Every stage's line goes into DIR/report.json as it
ends; a stage that fails stops the run (exit code 1). DIR holds
gigabytes at full size: keep it out of the repository's files (the
repository's .gitignore lists scale_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import world

STAGES = ("gen", "anchor", "index", "signal", "aln", "sort", "sv",
          "sv_inline", "parity", "compare")
BATCH = 8192               # fc_aln -b, as tools/chrom_scale_run.py's run
N_BAM_PARITY = 16_384
N_HOST_PARITY = 1024
MAX_FALLBACK = 0.05        # host fallback share of the reads with a hit
# (name, EngineConfig fields) of the card's engine configurations
CONFIGS = (("depth3_device_collect", dict(stream_depth=3, collect="auto")),
           ("depth1_host_collect", dict(stream_depth=1, collect="host")))

# runs argv, then writes the peak RSS (KiB) of the processes it waited
# for into the file argv[1] and exits with argv's exit code
_RSS_WRAPPER = (
    "import subprocess,resource,sys;"
    "p=subprocess.run(sys.argv[2:]);"
    "r=resource.getrusage(resource.RUSAGE_CHILDREN);"
    "open(sys.argv[1],'w').write(str(r.ru_maxrss));"
    "sys.exit(p.returncode)"
)


def paths(out_dir: str) -> dict:
    """The world's files (world.chrom_paths) and the stages' outputs."""
    return dict(world.chrom_paths(out_dir), **{
        k: os.path.join(out_dir, f) for k, f in (
            ("aln", "aln.bam"), ("sorted", "aln.sorted.bam"),
            ("vcf_card", "result.vcf"), ("vcf_inline", "result_inline.vcf"),
            ("vcf_jax", "result_jax.vcf"), ("report", "report.json"),
            ("parity_dir", "parity"))})


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _save(rep: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rep, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def _child_json(out_dir: str, stage: str) -> str:
    return os.path.join(out_dir, f".{stage}.json")


def _write_child(out_dir: str, stage: str, data: dict) -> None:
    with open(_child_json(out_dir, stage), "w") as fh:
        json.dump(data, fh, sort_keys=True)


def run_timed(name: str, argv: list[str], out_dir: str, stdout=None) -> dict:
    """Run argv under the RSS wrapper: its wall seconds, its own peak RSS
    (GiB) and its exit code."""
    print(f"[scale] {name}: {' '.join(argv[:6])} ...", flush=True)
    rss_file = os.path.join(out_dir, f".rss_{name}.txt")
    # the children import this package from where this process found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (root, os.environ.get("PYTHONPATH")) if x))
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", _RSS_WRAPPER, rss_file, *argv],
                       stdout=stdout, env=env)
    wall = time.perf_counter() - t
    try:
        with open(rss_file) as fh:
            rss_gib = int(fh.read().strip()) / 2**20
    except (OSError, ValueError):
        rss_gib = None
    out = dict(wall_s=wall, peak_rss_gib=rss_gib, rc=p.returncode)
    print(f"[scale] {name}: {wall:.1f} s, peak RSS {rss_gib} GiB, "
          f"rc={p.returncode}", flush=True)
    return out


def _stage_argv(stage: str, p: dict, a) -> tuple[list[str], str | None]:
    """(argv, stdout file) of a stage's process."""
    port = [sys.executable, "-m", "pansvr_tpu_torch"]
    if stage == "anchor":
        return port + ["fc_anchor_ref", p["genome"], p["vcf"]], p["anchors"]
    if stage == "index":
        return port + ["fc_index", p["anchors"], p["index"]], None
    if stage == "signal":
        return port + ["fc_signal", p["bam"], "-o", p["signal"], "-s",
                       p["status"], "-U", "-D"], None
    return [sys.executable, "-m", "pansvr_tpu_torch.scale_run", "--out",
            a.out, "--pairs", str(a.pairs), "--device", a.device,
            "--child", stage], None


def _peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _gpu_peak_mib(dev) -> float | None:
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**20


def _reset_gpu_peak(device: str):
    import torch

    from .index.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def _kernel_table(samples: dict) -> list[dict]:
    """ops.kernel_bounds.pass_table of the launches counted since the last
    reset (empty on the CPU, where nothing launches)."""
    from .ops import extd2_cuda as ec
    from .ops.kernel_bounds import int_ops_per_s, pass_table

    launches = dict(ec.LAUNCHES_BY_SHAPE)
    if not launches:
        return []
    return pass_table(samples, launches, int_ops_per_s()[0])


def _rss_now() -> dict:
    """This process's resident set now (GiB): in all, anonymous, mapped
    from files (shared libraries among them) and shared memory."""
    out = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key = line.split(":")[0]
            if key in ("VmRSS", "RssAnon", "RssFile", "RssShmem"):
                out[key] = int(line.split()[1]) / 2**20
    return out


def _child_aln(p: dict, a) -> dict:
    from dataclasses import fields

    steps = {"start": _rss_now()}
    import torch

    from .cli.main import parse_args, run_fc_aln
    from .ops import extd2_cuda as ec

    steps["torch_imported"] = _rss_now()
    dev = _reset_gpu_peak(a.device)
    steps["device_ready"] = _rss_now()
    if dev.type == "cuda":
        from ._build import load_kernels

        load_kernels()
    steps["kernels_loaded"] = _rss_now()
    args = parse_args(["fc_aln", p["index"], p["signal"], p["header"], "-o",
                       p["aln"], "-b", str(BATCH), "-r", p["status"],
                       "--device", a.device])
    ec.reset_launches()
    with ec.keep_samples() as samples:
        t = time.perf_counter()
        eng = run_fc_aln(args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        pass_s = time.perf_counter() - t
    # the adaptive layer's counters (absent from eng.prof until they fire)
    prof = dict.fromkeys(("n_widen", "n_retry", "n_retry_over", "n_fallback",
                          "n_budget_fallback", "n_compacted", "n_rechain",
                          "n_oversize", "n_hit_reads"), 0.0)
    prof.update((k, float(v)) for k, v in sorted(eng.prof.items()))
    hit = max(prof["n_hit_reads"], 1.0)
    didx = eng.didx
    index_bytes = sum(getattr(didx, f.name).numel()
                      * getattr(didx, f.name).element_size()
                      for f in fields(didx)
                      if isinstance(getattr(didx, f.name), torch.Tensor))
    with open(os.path.join(p["index"], "engine_tune.json")) as fh:
        tune = json.load(fh)
    return dict(
        pass_s=pass_s, reads=int(prof["n_reads"]),
        reads_per_s=prof["n_reads"] / pass_s, prof=prof,
        fallback_share=prof["n_fallback"] / hit,
        gpu_peak_mib=_gpu_peak_mib(dev), device_index_bytes=index_bytes,
        index=dict(n_kmer_padded=didx.n_kmer, n_uni_padded=didx.n_uni,
                   first_level=didx.first_level_bases),
        launches=dict(ec.LAUNCHES), kernels=_kernel_table(samples),
        engine_tune=tune, rss_steps=dict(steps, end=_rss_now()))


def _child_sort(p: dict, a) -> dict:
    from .io.bai import build_bai, sort_bam

    sort_bam(p["aln"], p["sorted"])
    build_bai(p["sorted"])
    return {}


def _child_sv(p: dict, a) -> dict:
    from .cli.main import parse_args, run_fc_sv
    from .ops import extd2_cuda as ec

    dev = _reset_gpu_peak(a.device)
    steps = {"device_ready": _rss_now()}
    args = parse_args(["fc_sv", p["anchors"], p["sorted"], p["genome"],
                       "-o", p["vcf_card"], "-r", p["status"],
                       "--device", a.device])
    ec.reset_launches()
    with ec.keep_samples() as samples:
        t = time.perf_counter()
        verdicts, dp = run_fc_sv(args)
        wall = time.perf_counter() - t
    return dict(wall_in_process_s=wall, regions=len(verdicts),
                n_pass=sum(v.passed for v in verdicts), dp=dp.prof,
                gpu_peak_mib=_gpu_peak_mib(dev), launches=dict(ec.LAUNCHES),
                kernels=_kernel_table(samples),
                rss_steps=dict(steps, end=_rss_now()))


def _child_sv_inline(p: dict, a) -> dict:
    from .assembly.sv_call import INLINE, ContigDpBatcher, run_sv_calling
    from .cli.main import fc_sv_inputs, parse_args, write_sv_vcf

    args = parse_args(["fc_sv", p["anchors"], p["sorted"], p["genome"],
                       "-o", p["vcf_inline"], "-r", p["status"]])
    dp = ContigDpBatcher(INLINE)
    verdicts, records = run_sv_calling(args.bam, *fc_sv_inputs(args), dp=dp)
    write_sv_vcf(args.output, records)
    return dict(regions=len(verdicts), n_pass=sum(v.passed for v in verdicts),
                dp=dp.prof)


def _device_busy_share(run) -> dict:
    """torch.profiler (CPU + CUDA) over run(): the device time of every
    event over the wall of run() (one stream, so the sum is the busy
    time), with the profiler on."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = 0.0
    for e in prof.key_averages():
        dev_us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return dict(wall_s=wall, device_busy_s=dev_us / 1e6,
                busy_share=dev_us / 1e6 / wall if wall else None)


def _child_parity(p: dict, a) -> dict:
    from .align.engine import AlignEngine, EngineConfig
    from .cli.main import parse_args, run_fc_aln

    d = p["parity_dir"]
    os.makedirs(d, exist_ok=True)
    idx_dir = os.path.join(d, "rdbg")
    if not os.path.isdir(idx_dir):
        world._copy_index(p["index"], idx_dir)
    tune = os.path.join(idx_dir, "engine_tune.json")
    head = os.path.join(d, "head.fq")
    n_head = world.head_signal(p["signal"], head, N_BAM_PARITY)

    def fc_aln(device, cfg, out):
        # every run starts from the default lane budgets
        if os.path.exists(tune):
            os.remove(tune)
        return run_fc_aln(parse_args([
            "fc_aln", idx_dir, head, p["header"], "-o", out, "-r",
            p["status"], "-b", str(BATCH), "--device", device]),
            config=EngineConfig(**cfg))

    runs = [("cpu", "default", {})] + [(a.device, name, cfg)
                                       for name, cfg in CONFIGS]
    bams = []
    for device, name, cfg in runs:
        bams.append(os.path.join(d, f"head_{device}_{name}.bam"))
        fc_aln(device, cfg, bams[-1])
    recs = [world.bam_records(b) for b in bams]
    if not recs[0] or any(r != recs[0] for r in recs[1:]):
        raise AssertionError(f"parity (a): BAM records differ: "
                             f"{[len(r) for r in recs]}")
    out = dict(a_reads=n_head, a_records=len(recs[0]),
               a_runs=[f"{dv} {nm}" for dv, nm, _ in runs])
    seqs, oris = world.read_batch(p["signal"], N_HOST_PARITY)
    eng = AlignEngine(world.load_index(idx_dir),
                      ori_chrom_names=world.header_names(p["header"]),
                      device=a.device)
    out.update(b_reads=len(seqs),
               b_reads_with_alignments=world.host_parity(eng, seqs, oris))
    if eng.device.type == "cuda":
        name, cfg = CONFIGS[0]
        out["profiled_pass"] = dict(config=name, reads=n_head, **(
            _device_busy_share(lambda: fc_aln(
                a.device, cfg, os.path.join(d, "head_profiled.bam")))))
    return out


def _compare(p: dict) -> dict:
    """(c), (d) and F1 from the VCFs the sv stages wrote."""
    from .io.vcf_compare import compare_vcfs

    card = world.vcf_body(p["vcf_card"])
    out = dict(records=len(card),
               c_inline_identical=card == world.vcf_body(p["vcf_inline"]))
    if os.path.exists(p["vcf_jax"]):
        out["d_jax_identical"] = card == world.vcf_body(p["vcf_jax"])
    for key, pass_only in (("f1_all", False), ("f1_pass", True)):
        r = compare_vcfs(p["vcf"], p["vcf_card"], pass_only=pass_only)
        out[key] = dict(f1=r.f1, recall=r.recall, precision=r.precision,
                        truth=r.n_truth, query=r.n_query,
                        matched=len(r.matches), classes=r.class_counts())
    return out


_CHILDREN = dict(aln=_child_aln, sort=_child_sort, sv=_child_sv,
                 sv_inline=_child_sv_inline, parity=_child_parity)


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m pansvr_tpu_torch.scale_run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--pairs", type=int, default=world.CHROM_PAIRS,
                    help="read pairs of the world (default 5,000,000)")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages to run, in their order")
    ap.add_argument("--device", default="cuda",
                    help="device of fc_aln, fc_sv and parity's engine runs")
    ap.add_argument("--child", choices=("gen",) + tuple(_CHILDREN),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    bad = set(a.stages.split(",")) - set(STAGES)
    if bad:
        ap.error(f"unknown stages {sorted(bad)}")
    return a


def main(argv=None) -> int:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    a.out = os.path.abspath(a.out)
    os.makedirs(a.out, exist_ok=True)
    p = paths(a.out)
    if a.child == "gen":
        g = world.gen_chrom_world(a.out, a.pairs)
        _write_child(a.out, a.child, dict(seconds=g["gen_seconds"],
                                          workers=os.cpu_count()))
        return 0
    if a.child:
        line = _CHILDREN[a.child](p, a)
        # this process's own peak (the wrapper's covers its children too,
        # nvcc's kernel build among them)
        line["self_peak_rss_gib"] = _peak_rss_gib()
        _write_child(a.out, a.child, line)
        return 0

    try:
        with open(p["report"]) as fh:
            rep = json.load(fh)
    except (OSError, ValueError):
        rep = {}
    rep.update(pairs=a.pairs, device=a.device, world=dict(world.CHROM_WORLD),
               batch=BATCH)
    if a.device.startswith("cuda"):
        rep["card"] = card_line()
    stages = rep.setdefault("stages", {})
    todo = a.stages.split(",")
    for stage in STAGES:
        if stage not in todo:
            continue
        if stage == "compare":
            rep["compare"] = _compare(p)
            _save(rep, p["report"])
            print(f"[scale] compare: {json.dumps(rep['compare'])}",
                  flush=True)
            if not (rep["compare"]["c_inline_identical"]
                    and rep["compare"].get("d_jax_identical", True)):
                print("[scale] compare: the VCF records differ", flush=True)
                return 1
            continue
        argv, stdout_path = _stage_argv(stage, p, a)
        if os.path.exists(_child_json(a.out, stage)):
            os.remove(_child_json(a.out, stage))
        if stdout_path:
            with open(stdout_path, "w") as fh:
                line = run_timed(stage, argv, a.out, stdout=fh)
        else:
            line = run_timed(stage, argv, a.out)
        if os.path.exists(_child_json(a.out, stage)):
            with open(_child_json(a.out, stage)) as fh:
                line.update(json.load(fh))
        stages[stage] = line
        if stage == "signal":
            with open(p["signal"]) as fh:
                rep["signal_reads"] = sum(1 for _ in fh) // 4
        _save(rep, p["report"])
        if line["rc"] != 0:
            print(f"[scale] {stage} failed (rc={line['rc']})", flush=True)
            return 1
        if stage == "aln":
            print(f"[scale] aln: {line['reads']} reads at "
                  f"{line['reads_per_s']:.1f} reads/s; host fallback "
                  f"{line['fallback_share']:.4%} of the reads with a hit; "
                  f"launches {line['launches']}", flush=True)
            if line["fallback_share"] > MAX_FALLBACK:
                print(f"[scale] aln: host fallback over {MAX_FALLBACK:.0%}",
                      flush=True)
                return 1
    print(f"[scale] report: {p['report']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
