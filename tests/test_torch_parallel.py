"""The port's multi-process helpers and launch guard: the fc_sv fan-out's
chromosome shards and VCF merge (parallel/fanout.py), and the device
guard of the kernel launches. The fc_aln fan-out runs in
test_torch_aln_shard.py."""

import contextlib
import os

import torch

from pansvr_tpu.parallel.mesh import merge_vcf_parts as jax_merge_vcf_parts
from pansvr_tpu_torch.parallel.fanout import merge_vcf_parts, shard_chromosomes

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")


def test_shard_chromosomes_covers_each_chromosome_once():
    """Contiguous, disjoint ranges in chromosome order that together hold
    every chromosome with regions once, each shard's regions within one
    chromosome's of an even share; shards left without regions are left
    out."""
    counts = [5, 0, 30, 10, 10, 0, 25, 20, 0]
    total = sum(counts)
    assert shard_chromosomes(counts, 1) == [range(0, 9)]
    assert shard_chromosomes([4, 4], 2) == [range(0, 1), range(1, 2)]
    # the trailing empty chromosome lands in a shard with no regions
    assert shard_chromosomes([10, 0], 2) == [range(0, 1)]
    for n in range(1, 8):
        shards = shard_chromosomes(counts, n)
        assert 1 <= len(shards) <= n
        assert shards[0].start == 0
        for a, b in zip(shards, shards[1:]):
            assert a.stop == b.start
        held = [i for r in shards for i in r]
        assert len(held) == len(set(held))
        assert {i for i, c in enumerate(counts) if c} <= set(held)
        for r in shards:
            got = sum(counts[i] for i in r)
            assert 0 < got <= total / n + max(counts), (n, r, got)


def _vcf_part(path, regions):
    """An fc_sv VCF part: its header, then a record a region (the ID's
    first '_' field is the region)."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=9000>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for r in regions:
            fh.write(f"chr1\t{100 * r + 1}\t{r}_DEL_{r}\tN\t<DEL>\t.\t"
                     f"PASS\tSVTYPE=DEL;SVLEN=-{50 + r}\n")


def test_merge_vcf_parts_matches_jax(tmp_path):
    """The parts of contiguous region shards merge to the JAX package's
    bytes (one header, the records in part order); parts handed out of
    order still merge in region order."""
    parts = [str(tmp_path / f"p{k}.vcf") for k in range(3)]
    for path, regions in zip(parts, ([0, 3, 4], [7, 11], [12, 30, 31])):
        _vcf_part(path, regions)
    ours, theirs = str(tmp_path / "ours.vcf"), str(tmp_path / "jax.vcf")
    merge_vcf_parts(parts, ours)
    jax_merge_vcf_parts(parts, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        merged = a.read()
        assert merged == b.read()
    assert merged.count(b"#CHROM") == 1 and merged.count(b"_DEL_") == 8
    shuffled = str(tmp_path / "shuffled.vcf")
    merge_vcf_parts(parts[::-1], shuffled)
    with open(shuffled, "rb") as fh:
        assert fh.read() == merged


def test_kernel_launches_run_under_their_tensors_device(monkeypatch):
    """Every K1/K2 launch (both wrappers and both raw launchers) runs
    inside device_guard(device of its tensors): a stand-in kernel library
    records the guarded device at each launch."""
    from pansvr_tpu_torch import _build
    from pansvr_tpu_torch.ops import extd2_cuda as ec
    from pansvr_tpu_torch.ops.extd2 import Extd2Params, plan

    current, seen = [], []

    @contextlib.contextmanager
    def guard(dev):
        current.append(torch.device(dev))
        yield
        current.pop()

    class Lib:
        def pansvr_extd2_fwd(self, *args):
            seen.append(("fwd", current[-1] if current else None))
            return 0

        def pansvr_extd2_tb(self, *args):
            seen.append(("tb", current[-1] if current else None))
            return 0

    monkeypatch.setattr(ec, "device_guard", guard)
    monkeypatch.setattr(ec, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ec, "_stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "load_kernels", Lib)
    monkeypatch.setattr(_build, "check", lambda lib, rc, what: None)
    B, Q, T, W = 4, 48, 64, 64
    p = Extd2Params()
    q, t = torch.zeros((B, Q), dtype=torch.int32), torch.zeros((B, T), dtype=torch.int32)
    ql = tl = torch.ones(B, dtype=torch.int32)
    n_diag_pad = plan(Q, T, W)[1]
    dmat = torch.zeros((B, n_diag_pad, W), dtype=torch.uint8)
    ec.reset_launches()
    ec.extd2_fwd(q, ql, t, tl, p, W)
    ec.fwd_raw_launcher(q, ql, t, tl, p, W)()
    ec.extd2_traceback(dmat, ql, tl, ql, tl, p, W, n_diag_pad, T)
    ec.tb_raw_launcher(dmat, ql, tl, ql, tl, p, W, n_diag_pad, T)()
    cpu = torch.device("cpu")
    assert seen == [("fwd", cpu), ("fwd", cpu), ("tb", cpu), ("tb", cpu)]
    assert ec.LAUNCHES == {"extd2_fwd": 1, "extd2_tb": 1}
