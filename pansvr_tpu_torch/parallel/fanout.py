"""Multiprocess fc_sv region fan-out (the driver analog of the
reference's per-chromosome bash fan-out, panSVR_run.sh:61-91).

The reference launches one fc_sv process per chromosome range and
concatenates the VCF parts; here the chromosomes (the BAM header's, in
order: the indices fc_sv's -S/-E select) are split into at most
`n_shards` contiguous ranges balanced by SV regions (shard_chromosomes),
one `pansvr_tpu_torch fc_sv -S lo -E hi --device D` subprocess per range
(inclusive ends), and the parts are merged in region order
(merge_vcf_parts): the VCF of one fc_sv over every region. Every worker
runs its contig DP on `device`: a few processes can share one card (each
launches its own chunks), and they share the kernel library in
build/kernels/, which _build.py writes by an atomic rename.
"""

from __future__ import annotations

import os
import subprocess
import sys


def shard_chromosomes(counts: list[int], n_shards: int) -> list[range]:
    """Contiguous, disjoint ranges of chromosome indices, one per fc_sv
    worker that has work, balanced by counts[i] (the SV regions on
    chromosome i): the -S lo -E hi-1 of each worker, whose ends fc_sv
    includes (generateVCFoptions' -S/-E select chromosome indices, as
    the reference's per-chromosome fan-out passes them). The JAX
    package splits the anchor-contig count instead: its workers get
    -S/-E ranges of contig ids that fc_sv reads as chromosome indices,
    so one worker takes every chromosome below the first cut and a
    chromosome at a cut goes to two workers (duplicate VCF records)."""
    total = max(sum(counts), 1)
    n_shards = max(1, n_shards)
    shard_of, cum = [], 0
    for c in counts:
        shard_of.append(min(n_shards - 1, cum * n_shards // total))
        cum += c
    out = []
    for k in range(n_shards):
        idx = [i for i, s in enumerate(shard_of) if s == k]
        if idx and sum(counts[i] for i in idx):
            out.append(range(idx[0], idx[-1] + 1))
    return out


def _region_id(line: str) -> int:
    """The SV region (anchor contig id) of an fc_sv VCF record: the first
    '_' field of its ID (the anchor name's new_ref_id)."""
    return int(line.split("\t", 3)[2].split("_", 1)[0])


def merge_vcf_parts(part_paths: list[str], out_path: str):
    """The per-shard VCF parts as one fc_sv over every region writes
    them: the first part's header, then the records in region order
    (stable), which is the order of an unsharded run's plans."""
    header, records = [], []
    for k, p in enumerate(part_paths):
        with open(p) as fh:
            for line in fh:
                if not line.startswith("#"):
                    records.append(line)
                elif k == 0:
                    header.append(line)
    records.sort(key=_region_id)
    with open(out_path, "w") as out:
        out.writelines(header)
        out.writelines(records)


def regions_per_chromosome(anchors_fa: str, bam: str) -> list[int]:
    """SV regions (anchor contigs) on each chromosome of the BAM header,
    by index; a contig whose chromosome the header lacks counts on
    chromosome 0, as fc_sv places it."""
    from ..anchor.builder import AnchorContig
    from ..io.bam import BamReader

    with BamReader(bam) as rd:
        names = list(rd.header.ref_names)
    index = {c: i for i, c in enumerate(names)}
    counts = [0] * max(len(names), 1)
    with open(anchors_fa) as fh:
        for line in fh:
            if line.startswith(">"):
                chrom = AnchorContig.parse_name(line[1:].split()[0]).chrom
                counts[index.get(chrom, 0)] += 1
    return counts


def _spawn(cmd, env):
    """Launch one fc_sv worker (separate for test injection)."""
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def run_sv_fanout(anchors_fa: str, bam: str, ref: str, out_vcf: str,
                  n_shards: int, status_file: str | None = None,
                  edge_len: int = 500, worker_env: dict | None = None,
                  timeout: float = 3600.0, max_retries: int = 1,
                  device: str = "cuda") -> str:
    """Run fc_sv over `n_shards` subprocesses and merge the VCF parts.
    Returns the merged VCF path.

    Failed or timed-out shards are RE-DISPATCHED up to `max_retries`
    times before the run raises — the elasticity analog SURVEY §2.2
    calls for (the reference's bash driver silently drops a failed
    chromosome and merges an empty part, panSVR_run.sh:78-91)."""
    shards = shard_chromosomes(regions_per_chromosome(anchors_fa, bam),
                               n_shards)
    env = dict(os.environ)
    if worker_env:
        env.update(worker_env)

    def shard_cmd(s, part):
        rng = shards[s]
        cmd = [sys.executable, "-m", "pansvr_tpu_torch", "fc_sv",
               anchors_fa, bam, ref, "-o", part,
               "-e", str(edge_len),
               "-S", str(rng.start), "-E", str(rng.stop - 1),
               "--device", device]
        if status_file:
            cmd += ["-r", status_file]
        return cmd

    parts = []
    procs = []
    for s in range(len(shards)):
        part = f"{out_vcf}.part{s}"
        parts.append(part)
        procs.append((s, part, _spawn(shard_cmd(s, part), env)))

    for attempt in range(max_retries + 1):
        failures = []
        for s, part, pr in procs:
            try:
                _, err = pr.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pr.kill()
                _, err = pr.communicate()
                failures.append((s, part, "timeout", err))
                continue
            if pr.returncode != 0:
                failures.append((s, part, f"rc={pr.returncode}", err))
        if not failures:
            break
        if attempt == max_retries:
            s, _, why, err = failures[0]
            tail = (err or b"").decode(errors="replace")[-2000:]
            raise RuntimeError(
                f"fc_sv shard {s} failed ({why}) after "
                f"{max_retries + 1} attempts; {len(failures)} shard(s) "
                f"failing.\n{tail}")
        procs = []
        for s, part, why, _ in failures:
            print(f"[fanout] re-dispatching fc_sv shard {s} ({why})",
                  file=sys.stderr, flush=True)
            if os.path.exists(part):
                os.unlink(part)
            procs.append((s, part, _spawn(shard_cmd(s, part), env)))

    merge_vcf_parts(parts, out_vcf)
    for p in parts:
        os.unlink(p)
    return out_vcf
