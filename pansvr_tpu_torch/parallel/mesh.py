"""Region sharding for SV calling across worker processes (the analog of
the reference's per-chromosome fc_sv fan-out, panSVR_run.sh:61-91):
contiguous anchor-contig ranges per worker, VCF parts concatenated.

The host half of pansvr_tpu/parallel/mesh.py. Its device half (the data
mesh and the sharded realignment front) belongs to the multi-GPU slice
of the port, which has not landed.
"""

from __future__ import annotations


def shard_sv_regions(n_sv: int, n_shards: int, shard_id: int) -> range:
    """Contiguous anchor-contig range for one fc_sv worker (the
    chromosome-range analog of generateVCFoptions' -S/-E options)."""
    per = (n_sv + n_shards - 1) // n_shards
    lo = shard_id * per
    return range(lo, min(lo + per, n_sv))


def merge_vcf_parts(part_paths: list[str], out_path: str):
    """Concatenate per-shard VCF parts (the driver's `cat vcfparts`
    merge, panSVR_run.sh:93-95 — with the `>`-vs-`>>` bug fixed)."""
    header_written = False
    with open(out_path, "w") as out:
        for p in part_paths:
            with open(p) as fh:
                for line in fh:
                    if line.startswith("#"):
                        if not header_written:
                            out.write(line)
                        continue
                    out.write(line)
            header_written = True
