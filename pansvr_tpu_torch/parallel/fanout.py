"""Multiprocess fc_sv region fan-out (the driver analog of the
reference's per-chromosome bash fan-out, panSVR_run.sh:61-91).

The reference launches one fc_sv process per chromosome range and
concatenates the VCF parts; here the anchor-contig id space is split
into `n_shards` contiguous ranges (parallel.mesh.shard_sv_regions), one
`pansvr_tpu_torch fc_sv -S lo -E hi --device D` subprocess per range, and
the parts are merged with parallel.mesh.merge_vcf_parts. Every worker
runs its contig DP on `device`: a few processes can share one card (each
launches its own chunks), and they share the kernel library in
build/kernels/, which _build.py writes by an atomic rename.
"""

from __future__ import annotations

import os
import subprocess
import sys

from .mesh import merge_vcf_parts, shard_sv_regions


def count_anchor_contigs(anchors_fa: str) -> int:
    n = 0
    with open(anchors_fa) as fh:
        for line in fh:
            if line.startswith(">"):
                n += 1
    return n


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
    n_sv = count_anchor_contigs(anchors_fa)
    n_shards = max(1, min(n_shards, n_sv or 1))
    env = dict(os.environ)
    if worker_env:
        env.update(worker_env)

    def shard_cmd(s, part):
        rng = shard_sv_regions(n_sv, n_shards, s)
        cmd = [sys.executable, "-m", "pansvr_tpu_torch", "fc_sv",
               anchors_fa, bam, ref, "-o", part,
               "-e", str(edge_len),
               "-S", str(rng.start), "-E", str(rng.stop),
               "--device", device]
        if status_file:
            cmd += ["-r", status_file]
        return cmd

    parts = []
    procs = []
    for s in range(n_shards):
        if len(shard_sv_regions(n_sv, n_shards, s)) == 0:
            continue
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
