"""Data parallelism over several devices, and region sharding for SV
calling across worker processes. Port of pansvr_tpu/parallel/mesh.py.

  - the data mesh: an ordered list of torch devices that plays the JAX
    Mesh's 'data' axis. Read rows (and DP problems) are cut into
    contiguous slices in mesh order, as shard_map's P("data") cuts them;
    the RdBG index is replicated once per distinct device; per-slice
    outputs are gathered in row order, and the one collective (the psum
    of the seed total) is a host sum, plus torch.distributed.all_reduce
    across processes when a process group is given. A mesh may repeat a
    device: ["cpu"] * 8 stands in for the JAX tests' 8 virtual CPU
    devices, [cuda:0, cuda:0] runs the sharded code on one card;
  - region sharding for SV calling (the analog of the reference's
    per-chromosome fc_sv fan-out, panSVR_run.sh:61-91): contiguous
    chromosome ranges per worker, balanced by SV regions; the VCF parts
    merged in region order.

The engine's sharded front, chain and DP (AlignEngine(mesh=...)) use the
same slicing; tests/test_torch_distributed.py runs sharded_realign_front
in two processes under torch.distributed (gloo).
"""

from __future__ import annotations

import torch

from ..index.builder import RdBGIndex
from ..index.device import (
    DeviceIndex,
    device_guard,
    resolve_device,
    to_device,
    upload,
)
from ..ops.seeding import DeviceSeeds, merge_expand_device3, seed_reads_flat


def make_data_mesh(n_devices: int | None = None, device="cuda") -> list:
    """The 'data' axis as a list of torch devices: every visible card
    (`device` "cuda"), or its first n_devices. A device with an index
    (or "cpu") gives n_devices copies of itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        return devs if n_devices is None else devs[:n_devices]
    return [dev] * (1 if n_devices is None else n_devices)


def canonical_mesh(mesh) -> list:
    """The mesh's entries as torch devices with an index (a bare "cuda"
    becomes the current card), so equal devices compare equal."""
    out = []
    for d in mesh:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("empty data mesh")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"data mesh mixes device types: {out}")
    return out


def row_shards(n: int, mesh) -> list:
    """[(device, lo, hi)]: n rows cut into contiguous slices of
    ceil(n / len(mesh)), one per mesh entry in order (P("data") when
    len(mesh) divides n); empty slices are left out."""
    per = -(-n // len(mesh))
    return [(d, s * per, min((s + 1) * per, n)) for s, d in enumerate(mesh)
            if s * per < n]


def index_replicas(mesh, idx: RdBGIndex, tr=None) -> dict:
    """{device: DeviceIndex}: the host index's tables derived once per
    distinct device of the mesh (to_device; `tr`, a utils.trace.Spans,
    takes its spans)."""
    out = {}
    for d in mesh:
        if d not in out:
            out[d] = to_device(idx, d, tr)
    return out


def gather(parts: list, dim: int, device) -> torch.Tensor:
    """Per-slice tensors concatenated along `dim` on `device`."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)


def front_stats(didx: DeviceIndex, words, lens, mask, S0: int, S: int,
                M: int, n_ext: int, nf_mult: int):
    """The uncompacted front on one device: seed_reads_flat +
    merge_expand_device3, and stats3 (3, rows) int32 [overflow, dropped,
    seed count]."""
    sb = seed_reads_flat(didx, words, lens, mask, S0=S0, n_ext_steps=n_ext,
                         M=M, nf_mult=nf_mult)
    es = merge_expand_device3(sb, didx, S=S)
    return es, torch.stack([sb.n_overflow, es.n_dropped,
                            es.valid.sum(1).to(torch.int32)])


def shard_front(mesh, replicas: dict, words, lens, mask, S0: int, S: int,
                M: int, n_ext: int, nf_mult: int) -> list:
    """The front per mesh entry on its row slice of the host arrays
    (each entry's flat lane pool is nf_mult x its own rows, as in the
    JAX shard_map program). Returns [(device, es, stats3)] in row
    order."""
    out = []
    for dev, lo, hi in row_shards(len(words), mesh):
        with device_guard(dev):
            w, ln, m = (upload(a[lo:hi], dev) for a in (words, lens, mask))
            out.append((dev, *front_stats(replicas[dev], w, ln, m, S0, S, M,
                                          n_ext, nf_mult)))
    return out


def sharded_realign_front(mesh, idx: RdBGIndex, S0: int, S: int, group=None, M=128,
                          n_ext=10, nf_mult=None):
    """Data-parallel front (seeding + merge/expand + stats) over a data
    mesh: rows sliced per entry, the index replicated per distinct
    device, per-entry seed counts summed into a global total (across the
    processes of `group` too, by all_reduce, when one is given). `idx`:
    the host RdBGIndex. M and n_ext default to the JAX
    function's (its non-flat seed_reads); the flat front's lane pool
    defaults to M lanes a row (nf_mult=None), so it does not cut a row
    that front keeps.

    Returns fn(words, lens, mask) -> (DeviceSeeds, stats3, total_seeds),
    the seeds and stats gathered in row order on the mesh's first
    device, the total a Python int."""
    mesh = canonical_mesh(mesh)
    replicas = index_replicas(mesh, idx)
    nf_mult = M if nf_mult is None else nf_mult

    def fn(words, lens, mask):
        parts = shard_front(mesh, replicas, words, lens, mask, S0, S, M,
                            n_ext, nf_mult)
        es = DeviceSeeds(*(gather([p[1][k] for p in parts], 0, mesh[0])
                           for k in range(len(DeviceSeeds._fields))))
        stats3 = gather([p[2] for p in parts], 1, mesh[0])
        total = torch.tensor([int(stats3[2].sum())], dtype=torch.int64)
        if group is not None:
            import torch.distributed as dist

            if dist.get_backend(group) == "nccl":
                total = total.to(mesh[0])
            dist.all_reduce(total, group=group)
        return es, stats3, int(total.item())

    return fn


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
