"""The chromosome-scale and genome worlds end to end on the port, one
process a stage (the port's counterpart of tools/chrom_scale_run.py).

    python -m pansvr_tpu_torch.scale_run --out DIR [--world chrom|genome]
        [--pairs N] [--svs N] [--first-level FL] [--sv-shards N]
        [--stages gen,anchor,index,signal,aln,aln_ops,aln_cards,sort,sv,
                  sv_inline,parity,compare]
        [--device cuda|cpu] [--cards N] [--share-card]

--world chrom (the default) is world.build_chrom_world's recipe (seed
99, 2,000 DEL/INS/DUP SVs on chr1 60 Mbp + chr2 40 Mbp, error 0.01,
index at the auto first level) with N read pairs (default 5,000,000);
--world genome is world.build_genome_world's (seed 2024, 40,000
DEL/INS/DUP SVs on 24 chromosomes of 16 Mbp, error 0.01, index at the
reference's first level 14, 5,000,000 pairs). --svs cuts the SV count,
--first-level sets the index's level. Stages, each in a process of its
own, timed (wall) with the process's own peak RSS (the largest process
of the stage: RUSAGE_CHILDREN of a wrapper around it):

  gen        world.gen_chrom_world with the world's recipe: genome.fa,
             svs.vcf, header.sam, sim.bam
  anchor     fc_anchor_ref genome.fa svs.vcf > anchors.fa
  index      fc_index anchors.fa rdbg --first-level FL; adds the index's
             first level, k-mers and unitigs
  signal     fc_signal sim.bam -o signal.fq -s status.sam -U -D
  aln        fc_aln rdbg signal.fq header.sam -o aln.bam -b 8192
             -r status.sam --device D with the engine's defaults (on a
             card a CUDA graph a batch's front + chain + collect and one a
             DP chunk, CONFIGS[0]), from the default lane budgets (the
             index's engine_tune.json removed first); adds the reads and
             reads/s of the pass (and of the pass without the engine's
             index upload), the engine's counters and phase timers, the
             front's share of the pass (host_submit, sync_chain), the host
             fallback share of the reads with a k-mer hit, the graph
             counters (captures, warm-ups, replays, evictions, the most
             held at once) and the distinct shape sets the pass keyed,
             front and DP apart, peak GPU memory allocated and reserved
             during the pass, the device index's bytes by tensor, the
             seconds and the peak-RSS step of one to_device of the index
             before the pass, K1/K2 launches by (kernel, Tmax, W,
             problems) with each shape's kernel time alone on its last
             launch's inputs and bound (ops/kernel_bounds.pass_table), and
             the engine_tune.json the run left
  aln_ops    the same pass op by op (EngineConfig(fuse_chain=False),
             OPS_CONFIG) -> aln_ops.bam, with the same report (no to_device
             of its own); compare (f) holds its records to aln.bam's
  aln_cards  fc_aln over --cards N: the fan-out (parallel.aln_shard.
             run_aln_fanout, N worker processes, each pinned to its card
             by CUDA_VISIBLE_DEVICES={shard}) -> aln_fanout.bam, then the
             data-mesh engine over make_data_mesh(N) with its CUDA graphs
             -> aln_mesh.bam, both over the whole signal FASTQ; each one's
             BAM records must equal aln.bam's. Records reads/s, the
             fan-out's split / worker / merge seconds and the mesh
             engine's phase timers and graph counters. Raises when fewer
             than N cards are visible; --share-card runs the N workers
             and the N mesh entries all on the first card (host overlap,
             not scaling: the report says which). On the CPU, N workers
             with --device cpu and a mesh of N CPU entries
  sort       io.bai.sort_bam + build_bai: aln.sorted.bam (+ .bai)
  sv         fc_sv over every SV region through the region fan-out
             (parallel.fanout.run_sv_fanout, --sv-shards worker processes,
             default one per CPU, each with its contig DP on D) ->
             result.vcf; then, in this stage's process, fc_sv --device D
             over the inline shard (the first of the world's chromosome
             shards: all regions for chrom, the first of 24 for genome,
             about 1,667 of its 40,000 regions) -> result_shard.vcf, with its
             requests, chunks, plan / run / finish seconds, PASS count
             and the kernel table
  sv_inline  the inline shard with the inline native DP
             (ContigDpBatcher(INLINE)) -> result_inline.vcf
  parity     (a) the first 16,384 signal reads: fc_aln
             --device cpu and --device D in the three engine
             configurations (CONFIGS: depth 3 with device collect and
             depth 1 with host collect, both with CUDA graphs on a card,
             and depth 3 op by op) give identical BAM records; (b) the first 1,024 reads: the engine
             on D equals its HostAligner field by field; (e) at a fixed
             first level, the same reads on D over an index of the same
             anchors at the auto first level give (a)'s BAM records; on a
             card, one profiled depth-3 pass over the reads, profiled
             after the engine is built, gives the card's idle share
  compare    (c) result_shard.vcf's records equal result_inline.vcf's and
             the fan-out's records on the shard's chromosomes; (d) if
             DIR/result_jax.vcf is there (the JAX package's fc_sv over
             aln.sorted.bam on the inline shard's -S/-E, which the report
             holds, run as a command of its own), its records equal
             result_shard.vcf's; F1 of result.vcf against the planted SVs
             (svs.vcf, io.vcf_compare at its defaults), all records and
             PASS only, and on the shard's chromosomes for the card and
             the JAX package; (f) if aln_ops.bam is there, its records
             equal aln.bam's over the whole pass

fc_aln and fc_sv run their subcommand's function on the subcommand's
argv (cli.main.parse_args, run_fc_aln / run_fc_sv) in a child that then
writes the counters. Every stage's line goes into DIR/report.json as it
ends; a stage that fails stops the run (exit code 1). DIR holds
gigabytes at full size (the genome world's ~20 GB): keep it out of the
repository's files (the repository's .gitignore lists scale_out/).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from . import world
from .utils.memory import peak_rss_gib

STAGES = ("gen", "anchor", "index", "signal", "aln", "aln_ops", "aln_cards",
          "sort", "sv", "sv_inline", "parity", "compare")
# each world's recipe, read pairs, index first level and the number of
# chromosome shards whose first the inline DP and the JAX fc_sv run over
WORLDS = dict(
    chrom=dict(recipe=world.CHROM_WORLD, pairs=world.CHROM_PAIRS,
               first_level="auto", inline_shards=1),
    genome=dict(recipe=world.GENOME_WORLD, pairs=world.GENOME_PAIRS,
                first_level=world.GENOME_FIRST_LEVEL, inline_shards=24))
BATCH = 8192               # fc_aln -b, as tools/chrom_scale_run.py's run
N_BAM_PARITY = 16_384
N_HOST_PARITY = 1024
MAX_FALLBACK = 0.05        # host fallback share of the reads with a hit
# (name, EngineConfig fields) of the card's engine configurations: two
# with the per-batch CUDA graphs (fuse_chain, the default), and the first
# of them op by op (OPS_CONFIG)
CONFIGS = (("depth3_device_collect", dict(stream_depth=3, collect="auto")),
           ("depth1_host_collect", dict(stream_depth=1, collect="host")),
           ("depth3_device_collect_ops", dict(stream_depth=3, collect="auto",
                                              fuse_chain=False)))
OPS_CONFIG = CONFIGS[2]
# the graph counters of an fc_aln pass's report (ProgramCache's prof)
GRAPH_COUNTERS = ("n_graph_capture", "graph_capture_s", "graph_warmup_s",
                  "n_graph_replay", "graph_replay_s", "n_graph_evict",
                  "n_graph_held_max", "n_front_shape_sets",
                  "n_dp_shape_sets")

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
            ("aln", "aln.bam"), ("aln_ops", "aln_ops.bam"),
            ("aln_fanout", "aln_fanout.bam"), ("aln_mesh", "aln_mesh.bam"),
            ("sorted", "aln.sorted.bam"),
            ("vcf_card", "result.vcf"), ("vcf_shard", "result_shard.vcf"),
            ("vcf_inline", "result_inline.vcf"),
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
        return port + ["fc_index", p["anchors"], p["index"],
                       "--first-level", str(a.first_level)], None
    if stage == "signal":
        return port + ["fc_signal", p["bam"], "-o", p["signal"], "-s",
                       p["status"], "-U", "-D"], None
    return [sys.executable, "-m", "pansvr_tpu_torch.scale_run",
            *_option_argv(a), "--child", stage], None


def _option_argv(a) -> list[str]:
    """The options of a run, as a child stage takes them."""
    out = ["--out", a.out, "--device", a.device, "--world", a.world]
    for k in ("pairs", "svs", "first_level", "sv_shards", "cards"):
        out += ["--" + k.replace("_", "-"), str(getattr(a, k))]
    return out + ["--share-card"] * bool(a.share_card)


def recipe(a) -> dict:
    """The world's recipe with the run's SV count."""
    return dict(WORLDS[a.world]["recipe"], n_sv=a.svs)


def inline_shard(p: dict, a) -> range:
    """The chromosome indices (-S, -E + 1) of the first of the world's
    inline_shards chromosome shards: the regions the inline DP and the
    JAX fc_sv run over."""
    from .parallel.fanout import regions_per_chromosome
    from .parallel.mesh import shard_chromosomes

    return shard_chromosomes(
        regions_per_chromosome(p["anchors"], p["sorted"]),
        WORLDS[a.world]["inline_shards"])[0]


def _gpu_peak_mib(dev, reserved: bool = False) -> float | None:
    """Peak GPU memory allocated (or reserved by the caching allocator,
    graph pools included) on dev since the last reset, MiB."""
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_reserved if reserved \
        else torch.cuda.max_memory_allocated
    return peak(dev) / 2**20


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


def index_tensor_bytes(didx) -> dict:
    """Bytes of each tensor of a DeviceIndex."""
    import dataclasses

    import torch

    return {f.name: getattr(didx, f.name).numel()
            * getattr(didx, f.name).element_size()
            for f in dataclasses.fields(didx)
            if isinstance(getattr(didx, f.name), torch.Tensor)}


def _time_to_device(index_dir: str, dev) -> dict:
    """One index.device.to_device of the index store (as the engine
    builds it) before the pass: its seconds and its host memory, the
    resident set before and the process's peak after (GiB); the
    tensors are freed again."""
    import torch

    from .index.device import to_device

    idx = world.load_index(index_dir)
    before = _rss_now()["VmRSS"]
    peak_before = peak_rss_gib()
    t = time.perf_counter()
    didx = to_device(idx, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = dict(seconds=time.perf_counter() - t, rss_before_gib=before,
               peak_rss_before_gib=peak_before,
               peak_rss_after_gib=peak_rss_gib(),
               peak_step_gib=peak_rss_gib() - before,
               bytes=sum(index_tensor_bytes(didx).values()))
    del didx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _drop_tuning(index_dir: str) -> None:
    """Remove the engine_tune.json an earlier fc_aln left in the index,
    so that a pass starts from the default lane budgets."""
    tune = os.path.join(index_dir, "engine_tune.json")
    if os.path.exists(tune):
        os.remove(tune)


def graph_report(eng) -> dict:
    """The graph counters and shape sets of an engine's pass (0 where
    nothing fired; the keys of every shape set, for the one that churns)."""
    out = {k: float(eng.prof.get(k, 0.0)) for k in GRAPH_COUNTERS}
    out["shape_set_keys"] = {kind: sorted(map(list, keys))
                             for kind, keys in eng.shape_sets.items()}
    return out


def same_records(path_a: str, path_b: str, what: str) -> int:
    """The raw BAM record bodies of two files, compared one by one as
    they stream: their count, or AssertionError at the first that
    differs (an empty file fails too)."""
    from itertools import zip_longest

    from .io.bam import BamReader

    n = 0
    for x, y in zip_longest(BamReader(path_a).iter_bodies(),
                            BamReader(path_b).iter_bodies()):
        if x != y:
            raise AssertionError(f"{what}: BAM record {n} differs "
                                 f"({path_a} vs {path_b})")
        n += 1
    if not n:
        raise AssertionError(f"{what}: no BAM records")
    return n


class ReservedSampler:
    """Samples the caching allocator's reserved bytes on a card every
    `period` seconds in a thread (allocator statistics only: no CUDA call,
    so a graph capture in the main thread is not disturbed). .samples:
    [(seconds since start, MiB)]."""

    def __init__(self, dev, period: float = 2.0):
        import threading

        self.index = dev.index if dev.index is not None else 0
        self.period = period
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        import torch

        t0 = time.perf_counter()
        while True:
            self.samples.append((
                round(time.perf_counter() - t0, 3),
                torch.cuda.memory_stats(self.index).get(
                    "reserved_bytes.all.current", 0) / 2**20))
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def reserved_by_pool(dev) -> dict:
    """The card's reserved memory now (MiB) by the caching allocator's
    pool and stream: "graph pool <id>" for a CUDA graph pool, "stream
    <handle>" for the ordinary blocks of each stream."""
    import torch

    out: dict = {}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != dev.index:
            continue
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        key = f"graph pool {pool}" if any(pool) \
            else f"stream {seg['stream']}"
        out[key] = out.get(key, 0.0) + seg["total_size"] / 2**20
    return out


def _aln_pass(p: dict, a, config: tuple, out_bam: str, steps: dict) -> dict:
    """One fc_aln pass over the whole signal FASTQ in the engine
    configuration `config` (name, EngineConfig fields), from the default
    lane budgets, with the kernel launches, GPU peaks and graph counters
    of the pass alone."""
    import torch

    from .align.engine import EngineConfig
    from .cli.main import parse_args, run_fc_aln
    from .ops import extd2_cuda as ec

    dev = _reset_gpu_peak(a.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    args = parse_args(["fc_aln", p["index"], p["signal"], p["header"], "-o",
                       out_bam, "-b", str(BATCH), "-r", p["status"],
                       "--device", a.device])
    _drop_tuning(p["index"])
    ec.reset_launches()
    sampler = ReservedSampler(dev) if dev.type == "cuda" else None
    with ec.keep_samples() as samples, sampler or contextlib.nullcontext():
        t = time.perf_counter()
        eng = run_fc_aln(args, config=EngineConfig(**config[1]))
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
    by_tensor = index_tensor_bytes(didx)
    with open(os.path.join(p["index"], "engine_tune.json")) as fh:
        tune = json.load(fh)
    return dict(
        config=config[0], fuse_chain=eng.cfg.fuse_chain,
        pass_s=pass_s, reads=int(prof["n_reads"]),
        reads_per_s=prof["n_reads"] / pass_s, prof=prof,
        stream_reads_per_s=prof["n_reads"] / (pass_s
                                              - prof["index_upload"]),
        front_share={k: prof.get(k, 0.0) / pass_s
                     for k in ("host_submit", "sync_chain")},
        fallback_share=prof["n_fallback"] / hit,
        graphs=graph_report(eng),
        gpu_peak_mib=_gpu_peak_mib(dev),
        gpu_reserved_mib=_gpu_peak_mib(dev, reserved=True),
        reserved_samples_mib=sampler.samples if sampler else None,
        reserved_by_pool_mib=reserved_by_pool(dev) if sampler else None,
        device_index_bytes=sum(by_tensor.values()),
        device_index_bytes_by_tensor=by_tensor,
        index=dict(n_kmer_padded=didx.n_kmer, n_uni_padded=didx.n_uni,
                   first_level=didx.first_level_bases),
        launches=dict(ec.LAUNCHES), kernels=_kernel_table(samples),
        engine_tune=tune, rss_steps=dict(steps, end=_rss_now()))


def _child_aln(p: dict, a) -> dict:
    steps = {"start": _rss_now()}
    import torch  # noqa: F401

    steps["torch_imported"] = _rss_now()
    dev = _reset_gpu_peak(a.device)
    steps["device_ready"] = _rss_now()
    if dev.type == "cuda":
        from ._build import load_kernels

        load_kernels()
    steps["kernels_loaded"] = _rss_now()
    todev = _time_to_device(p["index"], dev)
    steps["to_device_done"] = _rss_now()
    return dict(_aln_pass(p, a, CONFIGS[0], p["aln"], steps),
                to_device=todev)


def _child_aln_ops(p: dict, a) -> dict:
    return _aln_pass(p, a, OPS_CONFIG, p["aln_ops"], {"start": _rss_now()})


def card_mesh(a) -> tuple[list, dict | None, str]:
    """(the data mesh, the fan-out's worker_env, what the stage measures)
    of --cards N on a.device. Raises when fewer than N cards are visible
    (make_data_mesh would quietly return the ones there are), unless
    --share-card puts every entry and worker on the first card."""
    import torch

    from .index.device import resolve_device
    from .parallel.mesh import make_data_mesh

    n = a.cards
    dev = resolve_device(a.device)
    if dev.type != "cuda":
        return make_data_mesh(n, dev), None, f"{n} {dev.type} entries"
    if a.share_card:
        return [torch.device("cuda", 0)] * n, None, \
            f"host overlap: {n} workers and {n} mesh entries on one card"
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"aln_cards: --cards {n} asks for {n} cards, "
                           f"{have} visible (--share-card runs them all on "
                           "the first card)")
    return make_data_mesh(n), {"CUDA_VISIBLE_DEVICES": "{shard}"}, \
        f"{n} cards"


def _child_aln_cards(p: dict, a) -> dict:
    """The fan-out and the data mesh over --cards N, each over the whole
    signal FASTQ, each held to aln.bam's records."""
    import torch

    from .align.engine import EngineConfig
    from .cli.main import parse_args, run_fc_aln
    from .parallel.aln_shard import run_aln_fanout

    mesh, worker_env, measures = card_mesh(a)
    _drop_tuning(p["index"])
    split = {}
    t = time.perf_counter()
    run_aln_fanout(p["index"], p["signal"], p["header"], p["aln_fanout"],
                   a.cards, status_file=p["status"], batch=BATCH,
                   worker_env=worker_env, device=a.device, prof=split)
    fan_s = time.perf_counter() - t
    fan_records = same_records(p["aln"], p["aln_fanout"], "aln_cards fan-out")

    cards = list(dict.fromkeys(d for d in mesh if d.type == "cuda"))
    if cards:
        torch.cuda.init()   # before a call that names a card by its index
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    _drop_tuning(p["index"])
    t = time.perf_counter()
    eng = run_fc_aln(parse_args([
        "fc_aln", p["index"], p["signal"], p["header"], "-o", p["aln_mesh"],
        "-b", str(BATCH), "-r", p["status"], "--device", a.device]),
        config=EngineConfig(**CONFIGS[0][1]), mesh=mesh)
    for d in cards:
        torch.cuda.synchronize(d)
    mesh_s = time.perf_counter() - t
    mesh_records = same_records(p["aln"], p["aln_mesh"], "aln_cards mesh")
    n_reads = int(eng.prof["n_reads"])
    return dict(
        cards=a.cards, share_card=bool(a.share_card), measures=measures,
        reads=n_reads,
        fanout=dict(workers=a.cards, wall_s=fan_s,
                    reads_per_s=n_reads / fan_s, records=fan_records,
                    **split),
        mesh=dict(entries=[str(d) for d in mesh], wall_s=mesh_s,
                  reads_per_s=n_reads / mesh_s, records=mesh_records,
                  prof={k: float(v) for k, v in sorted(eng.prof.items())},
                  graphs=graph_report(eng),
                  gpu_reserved_mib=sum(torch.cuda.max_memory_reserved(d)
                                       for d in cards) / 2**20
                  if cards else None))


def _child_sort(p: dict, a) -> dict:
    from .io.bai import build_bai, sort_bam

    sort_bam(p["aln"], p["sorted"])
    build_bai(p["sorted"])
    return {}


def _pass_records(path: str) -> int:
    return sum(line.split("\t")[6] == "PASS"
               for line in world.vcf_body(path))


def _child_sv(p: dict, a) -> dict:
    from .cli.main import parse_args, run_fc_sv
    from .ops import extd2_cuda as ec
    from .parallel.fanout import regions_per_chromosome, run_sv_fanout
    from .parallel.mesh import shard_chromosomes

    counts = regions_per_chromosome(p["anchors"], p["sorted"])
    t = time.perf_counter()
    run_sv_fanout(p["anchors"], p["sorted"], p["genome"], p["vcf_card"],
                  a.sv_shards, status_file=p["status"], device=a.device)
    fanout = dict(wall_s=time.perf_counter() - t,
                  workers=len(shard_chromosomes(counts, a.sv_shards)),
                  sv_shards=a.sv_shards,
                  records=len(world.vcf_body(p["vcf_card"])))
    dev = _reset_gpu_peak(a.device)
    steps = {"device_ready": _rss_now()}
    sh = inline_shard(p, a)
    args = parse_args(["fc_sv", p["anchors"], p["sorted"], p["genome"],
                       "-o", p["vcf_shard"], "-r", p["status"],
                       "-S", str(sh.start), "-E", str(sh.stop - 1),
                       "--device", a.device])
    ec.reset_launches()
    with ec.keep_samples() as samples:
        t = time.perf_counter()
        verdicts, dp = run_fc_sv(args)
        wall = time.perf_counter() - t
    return dict(regions=sum(counts), n_pass=_pass_records(p["vcf_card"]),
                fanout=fanout, shard=[sh.start, sh.stop - 1],
                shard_regions=len(verdicts),
                shard_n_pass=sum(v.passed for v in verdicts),
                wall_in_process_s=wall, dp=dp.prof,
                gpu_peak_mib=_gpu_peak_mib(dev), launches=dict(ec.LAUNCHES),
                kernels=_kernel_table(samples),
                rss_steps=dict(steps, end=_rss_now()))


def _child_sv_inline(p: dict, a) -> dict:
    from .assembly.sv_call import INLINE, ContigDpBatcher, run_sv_calling
    from .cli.main import fc_sv_inputs, parse_args, write_sv_vcf

    sh = inline_shard(p, a)
    args = parse_args(["fc_sv", p["anchors"], p["sorted"], p["genome"],
                       "-o", p["vcf_inline"], "-r", p["status"],
                       "-S", str(sh.start), "-E", str(sh.stop - 1)])
    dp = ContigDpBatcher(INLINE)
    verdicts, records = run_sv_calling(args.bam, *fc_sv_inputs(args), dp=dp)
    write_sv_vcf(args.output, records)
    return dict(shard=[sh.start, sh.stop - 1], regions=len(verdicts),
                n_pass=sum(v.passed for v in verdicts), dp=dp.prof)


def profiled_fc_aln(argv: list, config, mesh=None) -> dict:
    """fc_aln (the CLI's run_fc_aln on argv, over `mesh` when one is
    given) with torch.profiler (CPU and CUDA) over its stream only,
    started after the engine is built and the index is on the card:
    kernel_bounds.device_activity of the stream (its wall with the
    profiler on), the batches, and the engine's graph counters."""
    import torch

    from .cli.main import parse_args, run_fc_aln
    from .ops.kernel_bounds import device_activity

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    eng = run_fc_aln(parse_args(argv), config=config, mesh=mesh, tracer=prof)
    p = eng.prof
    return dict(batches=int(p["n_batches"]),
                n_graph_capture=int(p["n_graph_capture"]),
                n_graph_replay=int(p["n_graph_replay"]),
                **device_activity(prof, p["stream_s"]))


def _child_parity(p: dict, a) -> dict:
    from .align.engine import AlignEngine, EngineConfig
    from .cli.main import parse_args, run_fc_aln

    d = p["parity_dir"]
    os.makedirs(d, exist_ok=True)
    idx_dir = os.path.join(d, "rdbg")
    if not os.path.isdir(idx_dir):
        world._copy_index(p["index"], idx_dir)
    head = os.path.join(d, "head.fq")
    n_head = world.head_signal(p["signal"], head, N_BAM_PARITY)

    def fc_aln(device, cfg, out, index=idx_dir):
        # every run starts from the default lane budgets
        tune = os.path.join(index, "engine_tune.json")
        if os.path.exists(tune):
            os.remove(tune)
        return run_fc_aln(parse_args([
            "fc_aln", index, head, p["header"], "-o", out, "-r",
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
    if a.first_level != "auto":
        out["e"] = _parity_e(p, a, d, lambda index, bam: fc_aln(
            a.device, CONFIGS[0][1], bam, index), bams[1], n_head)
    seqs, oris = world.read_batch(p["signal"], N_HOST_PARITY)
    eng = AlignEngine(world.load_index(idx_dir),
                      ori_chrom_names=world.header_names(p["header"]),
                      device=a.device)
    out.update(b_reads=len(seqs),
               b_reads_with_alignments=world.host_parity(eng, seqs, oris))
    if eng.device.type == "cuda":
        name, cfg = CONFIGS[0]
        tune = os.path.join(idx_dir, "engine_tune.json")
        if os.path.exists(tune):
            os.remove(tune)
        out["profiled_pass"] = dict(config=name, reads=n_head, **(
            profiled_fc_aln([
                "fc_aln", idx_dir, head, p["header"], "-o",
                os.path.join(d, "head_profiled.bam"), "-r", p["status"],
                "-b", str(BATCH), "--device", a.device],
                EngineConfig(**cfg))))
    return out


def _parity_e(p: dict, a, d: str, fc_aln, fixed_bam: str,
              n_head: int) -> dict:
    """(e): the reads of (a) over an index of the same anchors at the
    auto first level give the BAM records of the index at a.first_level
    (the probe's layout changes with the level, its answers must not)."""
    from .index.builder import build_index
    from .index.store import save_index
    from .io.fasta import read_fasta

    auto_dir = os.path.join(d, "rdbg_auto")
    idx = build_index(list(read_fasta(p["anchors"]).items()),
                      first_level_bases="auto")
    save_index(idx, auto_dir)
    bam = os.path.join(d, "head_auto_level.bam")
    fc_aln(auto_dir, bam)
    got, want = world.bam_records(bam), world.bam_records(fixed_bam)
    if not want or got != want:
        raise AssertionError(f"parity (e): BAM records differ between first "
                             f"levels {idx.first_level_bases} and "
                             f"{a.first_level}: {len(got)} vs {len(want)}")
    return dict(reads=n_head, records=len(want),
                levels=[int(a.first_level), idx.first_level_bases])


def _f1(truth: list, query: list) -> dict:
    from .io.vcf_compare import compare_calls

    r = compare_calls(truth, query)
    return dict(f1=r.f1, recall=r.recall, precision=r.precision,
                truth=r.n_truth, query=r.n_query, matched=len(r.matches),
                classes=r.class_counts())


def _compare(p: dict) -> dict:
    """(c), (d) and F1 from the VCFs the sv stages wrote; (f) from the
    BAMs of aln and aln_ops."""
    from .io.vcf_compare import load_calls

    fan = world.vcf_body(p["vcf_card"])
    shard = world.vcf_body(p["vcf_shard"])
    names = world.header_names(p["header"])
    with open(p["report"]) as fh:
        lo, hi = json.load(fh)["stages"]["sv"]["shard"]
    in_shard = set(names[lo: hi + 1])
    out = dict(records=len(fan), shard_records=len(shard),
               shard_chromosomes=sorted(in_shard),
               c_inline_identical=shard == world.vcf_body(p["vcf_inline"]),
               c_fanout_identical=shard == [
                   line for line in fan if line.split("\t")[0] in in_shard])
    vcfs = dict(card=p["vcf_shard"])
    if os.path.exists(p["vcf_jax"]):
        out["d_jax_identical"] = shard == world.vcf_body(p["vcf_jax"])
        vcfs["jax"] = p["vcf_jax"]
    if os.path.exists(p["aln_ops"]):
        try:
            out["f_records"] = same_records(p["aln"], p["aln_ops"],
                                            "compare (f)")
            out["f_ops_identical"] = True
        except AssertionError as e:
            out["f_ops_identical"] = False
            out["f_error"] = str(e)
    for key, pass_only in (("f1_all", False), ("f1_pass", True)):
        out[key] = _f1(load_calls(p["vcf"], pass_only=pass_only),
                       load_calls(p["vcf_card"], pass_only=pass_only))
    truth = [c for c in load_calls(p["vcf"]) if c.chrom in in_shard]
    out["f1_shard"] = {k: _f1(truth, load_calls(v)) for k, v in vcfs.items()}
    return out


_CHILDREN = dict(aln=_child_aln, aln_ops=_child_aln_ops,
                 aln_cards=_child_aln_cards, sort=_child_sort, sv=_child_sv,
                 sv_inline=_child_sv_inline, parity=_child_parity)


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m pansvr_tpu_torch.scale_run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--world", choices=tuple(WORLDS), default="chrom",
                    help="the recipe (default chrom)")
    ap.add_argument("--pairs", type=int,
                    help="read pairs of the world (default 5,000,000)")
    ap.add_argument("--svs", type=int,
                    help="SVs of the world (default the recipe's)")
    ap.add_argument("--first-level",
                    help="first level of the index, an int or 'auto' "
                         "(default: chrom auto, genome 14)")
    ap.add_argument("--sv-shards", type=int, default=os.cpu_count() or 1,
                    help="fc_sv fan-out worker processes (default: one "
                         "per CPU)")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages to run, in their order")
    ap.add_argument("--device", default="cuda",
                    help="device of fc_aln, fc_sv and parity's engine runs")
    ap.add_argument("--cards", type=int, default=2,
                    help="cards of the aln_cards stage: fan-out workers and "
                         "data-mesh entries (default 2)")
    ap.add_argument("--share-card", action="store_true",
                    help="aln_cards: every worker and mesh entry on the "
                         "first card (host overlap on one card)")
    ap.add_argument("--child", choices=("gen",) + tuple(_CHILDREN),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    bad = set(a.stages.split(",")) - set(STAGES)
    if bad:
        ap.error(f"unknown stages {sorted(bad)}")
    w = WORLDS[a.world]
    a.pairs = w["pairs"] if a.pairs is None else a.pairs
    a.svs = w["recipe"]["n_sv"] if a.svs is None else a.svs
    fl = w["first_level"] if a.first_level is None else a.first_level
    a.first_level = fl if fl == "auto" else int(fl)
    return a


def main(argv=None) -> int:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    a.out = os.path.abspath(a.out)
    os.makedirs(a.out, exist_ok=True)
    p = paths(a.out)
    if a.child == "gen":
        g = world.gen_chrom_world(a.out, a.pairs, **recipe(a))
        _write_child(a.out, a.child, dict(seconds=g["gen_seconds"],
                                          workers=os.cpu_count()))
        return 0
    if a.child:
        line = _CHILDREN[a.child](p, a)
        # this process's own peak (the wrapper's covers its children too,
        # nvcc's kernel build among them)
        line["self_peak_rss_gib"] = peak_rss_gib()
        _write_child(a.out, a.child, line)
        return 0

    try:
        with open(p["report"]) as fh:
            rep = json.load(fh)
    except (OSError, ValueError):
        rep = {}
    rep.update(pairs=a.pairs, device=a.device, world_name=a.world,
               world=recipe(a), first_level=a.first_level, batch=BATCH,
               sv_shards=a.sv_shards, cards=a.cards,
               share_card=bool(a.share_card))
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
            cmp = rep["compare"]
            if not (cmp["c_inline_identical"] and cmp["c_fanout_identical"]
                    and cmp.get("d_jax_identical", True)):
                print("[scale] compare: the VCF records differ", flush=True)
                return 1
            if not cmp.get("f_ops_identical", True):
                print(f"[scale] compare: {cmp['f_error']}", flush=True)
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
        if stage == "index" and line["rc"] == 0:
            idx = world.load_index(p["index"])
            line.update(first_level=idx.first_level_bases,
                        n_kmers=idx.n_kmers, n_unitigs=idx.n_unitigs)
        _save(rep, p["report"])
        if line["rc"] != 0:
            print(f"[scale] {stage} failed (rc={line['rc']})", flush=True)
            return 1
        if stage in ("aln", "aln_ops"):
            g = line["graphs"]
            print(f"[scale] {stage}: {line['reads']} reads at "
                  f"{line['reads_per_s']:.1f} reads/s "
                  f"({line['stream_reads_per_s']:.1f} after the index "
                  f"upload, {line['prof']['index_upload']:.1f} s); host "
                  f"fallback "
                  f"{line['fallback_share']:.4%} of the reads with a hit; "
                  f"launches {line['launches']}; CUDA graphs: "
                  f"{g['n_graph_capture']:.0f} captures in "
                  f"{g['graph_capture_s']:.3f} s, {g['n_graph_replay']:.0f} "
                  f"replays, {g['n_graph_evict']:.0f} evicted, at most "
                  f"{g['n_graph_held_max']:.0f} held; shape sets front "
                  f"{g['n_front_shape_sets']:.0f}, DP "
                  f"{g['n_dp_shape_sets']:.0f}; GPU peak "
                  f"{line['gpu_peak_mib']} MiB allocated, "
                  f"{line['gpu_reserved_mib']} reserved", flush=True)
            if line["fallback_share"] > MAX_FALLBACK:
                print(f"[scale] aln: host fallback over {MAX_FALLBACK:.0%}",
                      flush=True)
                return 1
        if stage == "aln_cards":
            fan, mesh = line["fanout"], line["mesh"]
            print(f"[scale] aln_cards ({line['measures']}): fan-out "
                  f"{fan['reads_per_s']:.1f} reads/s (split "
                  f"{fan['split_s']:.1f} s, workers {fan['workers_s']:.1f} s,"
                  f" merge {fan['merge_s']:.1f} s), mesh "
                  f"{mesh['reads_per_s']:.1f} reads/s; "
                  f"{fan['records']} BAM records equal aln.bam's in both",
                  flush=True)
        if stage == "sv":
            lo, hi = line["shard"]
            print(f"[scale] sv: {line['n_pass']} PASS of {line['regions']} "
                  f"regions through {line['fanout']['workers']} fan-out "
                  f"workers; the JAX fc_sv of (d) runs over -S {lo} -E {hi}",
                  flush=True)
    print(f"[scale] report: {p['report']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
