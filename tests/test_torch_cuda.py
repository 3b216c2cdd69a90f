"""Port tests that need a CUDA card (marked `cuda`; they skip elsewhere).

This file imports neither jax nor the JAX package (the port's own host
modules build its worlds), so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax). The kernels are held
bit-exact against their plain PyTorch versions on the card, and the card
engine against the CPU engine and the NumPy host aligner: its device
collect, its depth-3 stream with the adaptive state after every batch,
and a whole batch without a stream sync; the per-batch CUDA graphs
(align/programs.py) against the same programs enqueued op by op; the
front, chain, collect and DP glue kernels (csrc/front.cu) against the
plain programs on the card, and the graph warm-ups' ATen op kinds
against the engine build's; the index tables derived on the card
against those derived on the CPU.
"""

import numpy as np
import pytest
import torch

from pansvr_tpu_torch.ops import extd2_cuda as ec
from pansvr_tpu_torch.ops.extd2 import Extd2Params, plan

ALN = Extd2Params()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problems(rng, Q, T, n):
    """Mutated copies, unrelated pairs and length-1 edges of a class."""
    q = np.zeros((n, Q), np.int32)
    t = np.zeros((n, T), np.int32)
    ql = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    for i in range(n):
        tlen = 1 if i % 7 == 0 else int(rng.integers(1, T + 1))
        tt = rng.integers(0, 4, tlen)
        if i % 3 == 0:
            qq = rng.integers(0, 4, 1 if i % 5 == 0 else int(rng.integers(1, Q + 1)))
        else:
            qq = tt[:Q].copy()
            m = rng.random(len(qq)) < 0.05
            qq[m] = (qq[m] + 1) % 4
        t[i, :tlen], q[i, : len(qq)] = tt, qq
        ql[i], tl[i] = len(qq), tlen
    return [torch.from_numpy(a) for a in (q, ql, t, tl)]


# a profile outside state_fits_int8: the forward kernel's int32 state
WIDE = Extd2Params(match=4, mismatch=-60, q=30, e=2, q2=60, e2=1, w=40,
                   zdrop=200)
SV = Extd2Params(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132,
                 zdrop=132)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T,W,params", [
    (48, 64, 64, ALN), (96, 128, 128, ALN), (176, 256, 256, ALN),
    (272, 352, 256, ALN), (576, 704, 192, SV), (96, 160, 96, WIDE),
    (176, 256, 128, WIDE)], ids=["48x64", "96x128", "176x256", "272x352",
                                 "sv_576x704", "int32_W96", "int32_W128"])
def test_kernels_match_plain(cuda_device, Q, T, W, params):
    q, ql, t, tl = _problems(np.random.default_rng(Q), Q, T, 512)
    cpu = ec.extd2_fwd(q, ql, t, tl, params, W)
    ec.reset_launches()
    # the dmat memory comes uninitialised: poison the allocator's blocks
    torch.full((1 << 26,), 0xA5, dtype=torch.uint8, device=cuda_device)
    gpu = ec.extd2_fwd(*(a.to(cuda_device) for a in (q, ql, t, tl)), params, W)
    for f in cpu._fields:
        assert torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()), f
    i0 = torch.where(~cpu.zdropped, tl - 1, cpu.max_t).to(torch.int32)
    j0 = torch.where(~cpu.zdropped, ql - 1, cpu.max_q).to(torch.int32)
    _, n_diag_pad, _, _ = plan(Q, T, W)
    want = ec.extd2_traceback(cpu.dmat, ql, tl, i0, j0, params, W,
                              n_diag_pad, T)
    got = ec.extd2_traceback(*(a.to(cuda_device) for a in
                               (gpu.dmat, ql, tl, i0, j0)),
                             params, W, n_diag_pad, T)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert ec.LAUNCHES == {"extd2_fwd": 1, "extd2_tb": 1}
    assert ec.LAUNCHES_BY_SHAPE == {("extd2_fwd", T, W, 512): 1,
                                    ("extd2_tb", T, W, 512): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T,W,params,B", [
    (48, 64, 64, ALN, 2048), (96, 128, 128, ALN, 512),
    (576, 704, 192, SV, 1001), (176, 256, 256, ALN, 128)],
    ids=["W64_B2048", "W128_B512", "W192_B1001", "W256_B128"])
def test_traceback_kernel_matches_plain(cuda_device, Q, T, W, params, B):
    """K2 against extd2_traceback_plain on random direction bytes (every
    state code and continuation bit) from five kinds of start: dead
    (-1, -1), half dead (-1, j), the problem's end, the class's last
    diagonal (the top chunk) and anywhere in the problem, whose walks
    leave the band (forced D/I) and, where the window slides (W = 192),
    start or run outside the window. B = 1001 is not a multiple of the
    warps per block."""
    rng = np.random.default_rng(W + B)
    _, n_diag_pad, _, _ = plan(Q, T, W)
    dmat = torch.from_numpy(rng.integers(0, 256, (B, n_diag_pad, W),
                                         dtype=np.uint8))
    kind = np.arange(B) % 5
    ql = np.where(kind == 3, Q, rng.integers(1, Q + 1, B)).astype(np.int32)
    tl = np.where(kind == 3, T, rng.integers(1, T + 1, B)).astype(np.int32)
    i0 = np.where((kind == 2) | (kind == 3), tl - 1,
                  (rng.random(B) * tl).astype(np.int32)).astype(np.int32)
    j0 = np.where((kind == 2) | (kind == 3), ql - 1,
                  (rng.random(B) * ql).astype(np.int32)).astype(np.int32)
    i0[kind <= 1] = -1
    j0[kind == 0] = -1
    ql, tl, i0, j0 = (torch.from_numpy(a) for a in (ql, tl, i0, j0))
    want = ec.extd2_traceback_plain(dmat, ql, tl, i0, j0, params, W,
                                    n_diag_pad, T)
    # the ops memory comes uninitialised: poison the allocator's blocks
    torch.full((1 << 26,), 0xA5, dtype=torch.uint8, device=cuda_device)
    got = ec.extd2_traceback(*(a.to(cuda_device) for a in
                               (dmat, ql, tl, i0, j0)),
                             params, W, n_diag_pad, T)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    steps = (want[0] != 3).sum(1)
    assert (steps[kind <= 1] == 0).all() and (steps[kind >= 2] > 0).all()


@pytest.mark.cuda
def test_forward_refuses_windows_it_has_no_instance_for(cuda_device):
    q, ql, t, tl = (a.to(cuda_device) for a in
                    _problems(np.random.default_rng(2), 48, 512, 4))
    with pytest.raises(ValueError, match="W % 32"):
        ec.extd2_fwd(q, ql, t, tl, ALN, 320)


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices(cuda_device):
    q, ql, t, tl = _problems(np.random.default_rng(1), 48, 64, 4)
    with pytest.raises(ValueError, match="devices"):
        ec.extd2_fwd(q.to(cuda_device), ql, t, tl, ALN, 64)


def _vmrss() -> int:
    """The process's current resident set (VmRSS), bytes."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) << 10
    raise RuntimeError("no VmRSS in /proc/self/status")


@pytest.mark.cuda
def test_to_device_card_matches_cpu_from_store(cuda_device, tmp_path):
    """to_device on the card over a memory-mapped store at first level 12
    (6,000,000 entries: 128 MiB of ent_pack, a 64 MiB first-level table)
    gives the CPU's tables field for field, and the process's resident
    set, sampled every 2 ms during the call, grows by no more than the
    two staging buffers and 64 MiB: the host holds no table. A first
    call on a small store loads the kernels it launches."""
    import dataclasses
    import threading
    import time

    from index_worlds import synthetic_index
    from pansvr_tpu_torch.index import device
    from pansvr_tpu_torch.index.store import load_index, save_index

    save_index(synthetic_index(56_000, level=10), str(tmp_path / "small"))
    save_index(synthetic_index(6_000_000), str(tmp_path / "big"))
    device.to_device(load_index(str(tmp_path / "small")), cuda_device)
    idx = load_index(str(tmp_path / "big"))
    peak, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _vmrss())
            time.sleep(0.002)

    before = _vmrss()
    th = threading.Thread(target=sample)
    th.start()
    try:
        got = device.to_device(idx, cuda_device)
    finally:
        stop.set()
        th.join()
    grew = max(peak[0], _vmrss()) - before
    assert grew <= 2 * device.STAGE_BYTES + (64 << 20), grew
    want = device.to_device(idx, "cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.device.type == "cuda" and a.dtype == b.dtype, f.name
            assert torch.equal(a.cpu(), b), f.name
        else:
            assert a == b, f.name


@pytest.mark.cuda
def test_engine_card_matches_cpu_and_host(cuda_device):
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset
    from pansvr_tpu_torch.align.engine import AlignEngine

    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    names = list(ds.genome)
    seqs = [r.seq1 for r in ds.reads] + [r.seq2 for r in ds.reads]
    oris = [OriResult(unmapped=True)] * len(seqs)
    cpu = AlignEngine(idx, ori_chrom_names=names, device="cpu")
    ec.reset_launches()
    gpu = AlignEngine(idx, ori_chrom_names=names, device=cuda_device)
    a = cpu.align_batch(seqs, oris)
    b = gpu.align_batch(seqs, oris)
    assert ec.LAUNCHES["extd2_fwd"] > 0 and ec.LAUNCHES["extd2_tb"] > 0
    n_with = 0
    for i, seq in enumerate(seqs):
        want = cpu.host.align_read(seq, oris[i])
        for x in (a[i], b[i]):
            assert [(r.align_score, r.chain_score, r.direction, r.ref_bg,
                     r.sv_id, r.mapq, r.cigar) for r in x.results] == \
                [(r.align_score, r.chain_score, r.direction, r.ref_bg,
                  r.sv_id, r.mapq, r.cigar) for r in want.results], i
        n_with += bool(want.results)
    assert n_with > len(seqs) // 3


@pytest.fixture(scope="module")
def small_world():
    from pansvr_tpu_torch.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    return idx, list(ds.genome), [s for r in ds.reads for s in (r.seq1, r.seq2)]


def _results(states):
    return [[(r.align_score, r.chain_score, r.direction, r.ref_bg, r.sv_id,
              r.mapq, r.cigar) for r in s.results] for s in states]


@pytest.mark.cuda
@pytest.mark.parametrize("comp,budget", [(0, None), (256, (16, 24))])
def test_collect_card_matches_cpu(cuda_device, small_world, comp, budget):
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.ops.chain import chain_batch, chain_extract_batch
    from pansvr_tpu_torch.ops.collect import select_and_paths

    idx, names, seqs = small_world
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu")
    prep = eng._prep_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    es, _, rid = eng._front(
        *(torch.from_numpy(prep[k]) for k in ("words", "lens2", "mask2")),
        S0=prep["S0"], S=32, M=32, n_ext=9, nf_mult=10, comp=comp)
    is_str = torch.from_numpy(prep["is_str2"])
    if rid is not None:
        is_str = is_str[rid.long().clamp(0, len(is_str) - 1)] & (rid < len(is_str))
    cr = chain_batch(es.read_begin, es.read_end, es.ref_begin, es.ref_end,
                     es.cov, es.seed_id, es.valid, is_str)
    args = [cr.read_begin, cr.read_end, cr.ref_begin, cr.ref_end, cr.pre,
            *chain_extract_batch(cr.dist, cr.pre, cr.valid),
            torch.from_numpy(prep["act_pad"]), rid]
    n_pad = prep["n_pad"]
    NC, NP = budget or (n_pad, 2 * n_pad)
    want = select_and_paths(*args, n_pad=n_pad, NC=NC, NP=NP)
    got = select_and_paths(*(None if a is None else a.to(cuda_device)
                             for a in args), n_pad=n_pad, NC=NC, NP=NP)
    for f in want._fields:
        assert torch.equal(getattr(want, f), getattr(got, f).cpu()), f
    assert bool(want.over.any()) == bool(budget)


@pytest.mark.cuda
def test_stream_card_matches_cpu(cuda_device, small_world):
    """align_stream at depth 3 (device collect) on the card: the CPU
    engine's batches, in order, and the same adaptive state."""
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.engine import AlignEngine

    idx, names, seqs = small_world
    batches = [(seqs[i : i + 48], [OriResult(unmapped=True)] * 48)
               for i in range(0, 240, 48)]
    out = []
    for dev in ("cpu", cuda_device):
        eng = AlignEngine(idx, ori_chrom_names=names, device=dev)
        got = [_results(s) for s in eng.align_stream(iter(batches))]
        c = eng.cfg
        out.append((got, (eng._k_spec, eng._comp_cap, c.nf_mult,
                          c.mem_slots, c.collect_mult)))
    a, b = out
    assert a == b
    assert sum(map(len, sum(a[0], []))) > 50


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["device", "host"])
def test_engine_batch_makes_no_stream_sync(cuda_device, small_world, collect):
    """A whole batch (front, chain, collect, DP) with the sync debug mode
    set to raise: no pageable copy, .cpu(), .item() or data-dependent
    shape waits for the stream; only the engine's two event waits do."""
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig

    idx, names, seqs = small_world
    oris = [OriResult(unmapped=True)] * len(seqs)
    eng = AlignEngine(idx, ori_chrom_names=names, device=cuda_device,
                      config=EngineConfig(collect=collect))
    eng.align_batch(seqs, oris)      # warm-up (kernel build, K growth)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.align_batch(seqs, oris)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert any(s.results for s in got)
    assert eng.prof["n_event_waits"] >= 4


@pytest.mark.cuda
def test_host_memory_counters_on_card(cuda_device, small_world):
    """A capture of a tiny program adds its warm-up's VmRSS growth
    (warmup_rss_gib, at least 0: its op's module loads); after a short
    stream on the card the pinned host allocator owns blocks, at least as
    many bytes as were ever checked out at once where this torch counts
    those (utils.memory.pinned_host)."""
    from collections import defaultdict

    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.programs import GraphCache

    if not hasattr(torch.cuda, "host_memory_stats"):
        pytest.skip("this torch has no torch.cuda.host_memory_stats")
    prof = defaultdict(float)
    cache = GraphCache(cuda_device, prof)
    x = torch.arange(4096, dtype=torch.int64, device=cuda_device)
    got = cache.run(("tiny",), lambda inp: {"y": torch.cumsum(inp["x"] * 3, 0)},
                    {"x": x})
    assert torch.equal(got["y"].cpu(), torch.cumsum(x.cpu() * 3, 0))
    assert prof["n_graph_capture"] == 1 and prof["warmup_rss_gib"] >= 0
    assert "capture_rss_gib" in prof

    idx, names, seqs = small_world
    eng = AlignEngine(idx, ori_chrom_names=names, device=cuda_device)
    batches = [(seqs[i : i + 48], [OriResult(unmapped=True)] * 48)
               for i in range(0, 144, 48)]
    assert len(list(eng.align_stream(iter(batches)))) == 3
    p = eng.prof
    assert p["pinned_host_gib"] > 0 and p["n_pinned_blocks"] > 0
    if "pinned_active_peak_gib" in p:
        assert p["pinned_host_gib"] >= p["pinned_active_peak_gib"] > 0
    assert p["warmup_rss_gib"] >= 0
    assert p["rss_end_lib_gib"] > 0


@pytest.mark.cuda
def test_contig_dp_batcher_card_matches_cpu(cuda_device):
    """ContigDpBatcher on the card (K1 + K2 at 576x704/W192, the fc_sv
    profile) gives the results of its plain CPU run, field for field,
    and launches each kernel once a chunk."""
    from dataclasses import astuple

    from pansvr_tpu_torch.assembly.sv_call import ContigDpBatcher

    rng = np.random.default_rng(9)
    pairs = []
    for i in range(70):
        t = rng.integers(0, 4, int(rng.integers(20, 705))).astype(np.uint8)
        if i % 3:
            q = t[int(rng.integers(0, 10)):][:576].copy()
            m = rng.random(len(q)) < 0.03
            q[m] = (q[m] + 1) % 4
        else:
            q = rng.integers(0, 4, int(rng.integers(1, 600))).astype(np.uint8)
        pairs.append((q, t))
    out = []
    for dev in ("cpu", cuda_device):
        b = ContigDpBatcher(device=dev)
        b.CHUNK = 32
        ids = [b.request(q, t) for q, t in pairs]
        ec.reset_launches()
        b.run()
        out.append([astuple(b.result(k)) for k in ids])
        assert b.prof["chunks"] == [32, 32, len(pairs) - 64 - b.prof["n_scalar"]]
    assert ec.LAUNCHES == {"extd2_fwd": 3, "extd2_tb": 3}
    assert out[0] == out[1]


@pytest.mark.cuda
def test_onchip_self_check_on_card(cuda_device):
    from pansvr_tpu_torch.ops.onchip_check import run_onchip_parity

    out = run_onchip_parity(quick=False, device=cuda_device)
    assert out["extd2_aln"] == 48 and out["extd2_sv"] > 0


@pytest.mark.cuda
def test_sv_fanout_workers_share_the_card(cuda_device, tmp_path):
    """run --sv-shards: two fc_sv worker processes, one a chromosome, run
    their contig DP on one card and merge to the VCF of one fc_sv
    process."""
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_sv
    from pansvr_tpu_torch.io.fasta import write_fasta
    from pansvr_tpu_torch.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu_torch.parallel.fanout import (
        regions_per_chromosome, run_sv_fanout, shard_chromosomes)
    from pansvr_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from pansvr_tpu_torch.utils.simulate import make_dataset, write_sim_bam

    ds = make_dataset(seed=77, n_sv=4, n_pairs=400, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 100_000, "chr2": 100_000},
                      err_rate=0.0)
    genome, vcf, bam = (str(tmp_path / f) for f in ("g.fa", "s.vcf", "s.bam"))
    write_fasta(genome, ds.genome.items(), width=60)
    w = VCFWriter(vcf, minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, bam)
    work = tmp_path / "work"
    run_pipeline(vcf, genome, bam, str(work),
                 PipelineConfig(first_level_bases=11), device="cpu")
    args = [str(work / "anchors.fa"), str(work / "realigned.bam"), genome]
    single = str(tmp_path / "single.vcf")
    run_fc_sv(parse_args(["fc_sv", *args, "-o", single, "-r",
                          str(work / "status.txt"), "--device", "cpu"]))
    assert shard_chromosomes(regions_per_chromosome(
        args[0], args[1]), 2) == [range(0, 1), range(1, 2)]
    merged = run_sv_fanout(*args, str(tmp_path / "fan.vcf"), n_shards=2,
                           status_file=str(work / "status.txt"), device="cuda")
    assert "\tPASS\t" in open(single).read()
    assert open(merged).read() == open(single).read()


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_aln_fanout_workers_share_the_card(cuda_device, tmp_path):
    """run_aln_fanout: two fc_aln workers on one card merge to the BAM
    records of one fc_aln process."""
    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_aln
    from pansvr_tpu_torch.parallel.aln_shard import run_aln_fanout

    w = world.build_bench_world(str(tmp_path / "w"), n_pairs=3000)
    single = str(tmp_path / "single.bam")
    run_fc_aln(parse_args(["fc_aln", w["index"], w["signal"], w["header"],
                           "-o", single, "-r", w["status"], "-b", "1024"]))
    merged = run_aln_fanout(w["index"], w["signal"], w["header"],
                            str(tmp_path / "fan.bam"), n_shards=2,
                            status_file=w["status"], batch=1024)
    recs = world.bam_records(single)
    assert recs and world.bam_records(merged) == recs


@pytest.fixture(scope="module")
def front_batches():
    """The index of a simulated SV world on the card, a prepared batch of
    its 8,192 reads (n_pad 8,192, the cells' batch), STR repeats and
    unrelated reads among them, and a batch with no k-mer hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.index.device import to_device
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=41, n_sv=8, n_pairs=4096,
                      types=("DEL", "INS", "DUP"),
                      chrom_lengths={"chr1": 200_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cpu")
    rng = np.random.default_rng(41)
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    for i in range(5, len(seqs), 97):
        seqs[i] = ("CA" * 40 + seqs[i])[:150]
    for i in range(7, len(seqs), 89):
        seqs[i] = "".join(rng.choice(list("ACGT"), 150))
    noise = ["".join(rng.choice(list("ACGT"), 150)) for _ in range(300)]
    preps = {name: eng._prep_batch(s, [OriResult(unmapped=True)] * len(s))
             for name, s in (("reads", seqs), ("empty", noise))}
    assert preps["reads"]["is_str2"].any()
    return to_device(idx, "cuda"), preps


# S, M, nf_mult, compacted rows, K, collect lane budgets (NC, NP) in
# n_pad (None: the host collect)
FRONT_CASES = {
    "genome40k": (32, 32, 10, 0, 16, (1, 2)),
    "chrom2k": (32, 32, 10, 0, 32, (4, 8)),
    "compacted": (32, 32, 10, 12288, 32, (1, 2)),
    "compaction_budget_overflow": (32, 32, 10, 4096, 16, (4, 8)),
    "host_collect_k8": (32, 32, 10, 0, 8, None),
    "host_collect_compacted": (32, 32, 10, 12288, 16, None),
    "lane_overflow": (32, 32, 1, 0, 32, (1, 2)),
    "widened": (64, 64, 20, 0, 32, (2, 4)),
    "collect_overflow": (32, 32, 10, 0, 32, (1 / 16, 1 / 8)),
    "empty": (32, 32, 10, 0, 8, (1, 2)),
}


def _assert_same(name, got, want):
    """got == want bit for bit; else the first differing entries."""
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (name, got.dtype, want.dtype, tuple(got.shape), tuple(want.shape))
    bad = (got != want).nonzero()
    assert not len(bad), (name, len(bad), [
        (tuple(i.tolist()), got[tuple(i)].item(), want[tuple(i)].item())
        for i in bad[:6]])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_front_program_kernels_match_plain(cuda_device, front_batches, case):
    """front_program on the card (the kernels of csrc/front.cu) against
    front_program_plain (PyTorch ops) on the card, every output bit for
    bit at both cells' shape sets, compacted and not, over the lane,
    compaction and collect budgets, and with no hit at all; then the
    re-chain at full width the engine makes when K misses, on the
    front's own seeds."""
    from pansvr_tpu_torch.align import programs

    didx, preps = front_batches
    p = preps["empty" if case == "empty" else "reads"]
    S, M, nf_mult, comp, K, budget = FRONT_CASES[case]
    n_pad = p["n_pad"]
    NC, NP = (0, 0) if budget is None else \
        (int(budget[0] * n_pad), int(budget[1] * n_pad))
    shapes = dict(L=p["L"], n_pad=n_pad, S0=p["S0"], S=S, M=M,
                  n_ext=max(9, -(-(p["L"] - 20) // 16)), nf_mult=nf_mult,
                  comp=comp, K=K, NC=NC, NP=NP)
    inputs = {k: torch.from_numpy(p[k]).to(cuda_device)
              for k in ("words", "lens2", "mask2", "is_str2", "act_pad")}
    if case == "empty":
        # unrelated reads with every seed position screened out
        inputs["mask2"] = torch.zeros_like(inputs["mask2"])
    want = programs.front_program_plain(didx, inputs, shapes)
    got = programs.front_program(didx, inputs, shapes)
    assert sorted(want) == sorted(got)
    for k in want:
        _assert_same(k, got[k], want[k])
    _, es, is_str, rid, active = programs.front_parts(want)
    K2 = min(S, 32)
    w2 = programs.chain_program_plain(es, is_str, rid, active, K2, n_pad,
                                      NC, NP)
    g2 = programs.chain_program(es, is_str, rid, active, K2, n_pad, NC, NP)
    for k in w2:
        _assert_same(f"rechain {k}", g2[k], w2[k])
    ov, dropped, seeds = want["chain/stats3"].cpu()
    if case == "empty":
        assert not seeds.any()
        return
    assert seeds.any()
    flags = {"lane_overflow": lambda: (ov & (1 << 20)) != 0,
             "compaction_budget_overflow": lambda: (ov & (1 << 21)) != 0,
             "collect_overflow": lambda: want["chain/over"].cpu() != 0}
    if case in flags:
        assert flags[case]().any(), case


@pytest.mark.cuda
@pytest.mark.parametrize("cq,ct,W", [(96, 128, 128), (176, 256, 256)])
def test_dp_program_kernels_match_plain(cuda_device, cq, ct, W):
    """dp_program on the card (fill, K1, walk start, K2, packing, no ATen
    op between them) against dp_program_plain (PyTorch glue around the
    same K1 / K2) on the card, bit for bit: reversed rows, queries at
    the codes' ends, targets before the reference's start and past its
    end, and metadata read in place from a column slice."""
    from pansvr_tpu_torch.align import programs

    rng = np.random.default_rng(cq + W)
    rows, L, size, n_words = 300, 256, 192, 2048
    tru = n_words * 16 - 37
    codes = torch.from_numpy(rng.integers(0, 4, rows * L).astype(np.uint8))
    ref = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n_words,
                                        dtype=np.int64).astype(np.int32))
    qa = rng.integers(1, cq + 1, size)
    meta = np.stack([rng.integers(-5, rows * L - qa + 3, size), qa,
                     rng.integers(-60, tru + 30, size),
                     rng.integers(1, ct + 1, size),
                     rng.integers(0, 2, size)]).astype(np.int32)
    wide = torch.from_numpy(np.concatenate([meta, meta], 1)).to(cuda_device)
    dc, dr = codes.to(cuda_device), ref.to(cuda_device)
    kw = dict(cq=cq, ct=ct, W=W, size=size, params=ALN, tru_len=tru)
    for m in (wide[:, :size].contiguous(), wide[:, size:]):
        want = programs.dp_program_plain(dc, dr, m, **kw)
        got = programs.dp_program(dc, dr, m, **kw)
        for k in ("ops", "packed"):
            _assert_same(k, got[k], want[k])
    assert (want["packed"][2] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["device", "host"])
def test_graph_warmups_dispatch_no_op_kind_the_build_did_not(
        cuda_device, small_world, collect):
    """A short stream with graphs: the warm-ups of its front and DP
    captures dispatch no ATen op kind on the card that the engine build
    did not (n_warmup_new_op_kinds 0), so they load no libtorch CUDA
    module of their own."""
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu_torch.align.host_align import OriResult

    idx, names, seqs = small_world
    eng = AlignEngine(idx, ori_chrom_names=names, device=cuda_device,
                      config=EngineConfig(collect=collect), op_kinds=True)
    batches = [(seqs[i : i + 48], [OriResult(unmapped=True)] * 48)
               for i in range(0, 192, 48)]
    assert len(list(eng.align_stream(iter(batches)))) == 4
    assert eng.prof["n_graph_capture"] >= 2
    warm = eng._programs.warmup_ops
    assert warm.kinds and not warm.new_since(eng.build_ops), \
        warm.new_since(eng.build_ops)
    assert eng.prof["n_warmup_new_op_kinds"] == 0


@pytest.mark.cuda
def test_launches_run_with_their_device_current(cuda_device, monkeypatch):
    """device_guard(cuda:i) is torch.cuda.device(i) and makes card i
    current; every K1/K2 launch on a tensor of card i (both wrappers and
    both raw launchers) runs with card i current, while card 0 stays
    current around it."""
    from pansvr_tpu_torch import _build
    from pansvr_tpu_torch.index.device import device_guard

    lib = _build.load_kernels()
    seen = []

    class Recorder:
        def pansvr_extd2_fwd(self, *args):
            seen.append(("fwd", torch.cuda.current_device()))
            return lib.pansvr_extd2_fwd(*args)

        def pansvr_extd2_tb(self, *args):
            seen.append(("tb", torch.cuda.current_device()))
            return lib.pansvr_extd2_tb(*args)

        def __getattr__(self, name):
            return getattr(lib, name)

    monkeypatch.setattr(_build, "load_kernels", Recorder)
    Q, T, W = 48, 64, 64
    q, ql, t, tl = _problems(np.random.default_rng(11), Q, T, 64)
    n_diag_pad = plan(Q, T, W)[1]
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        guard = device_guard(dev)
        assert isinstance(guard, torch.cuda.device)
        with guard:
            assert torch.cuda.current_device() == i
        assert torch.cuda.current_device() == 0
        seen.clear()
        args = [a.to(dev) for a in (q, ql, t, tl)]
        out = ec.extd2_fwd(*args, ALN, W)
        ec.fwd_raw_launcher(*args, ALN, W)()
        tb = (out.dmat, args[1], args[3], args[3] - 1, args[1] - 1, ALN, W,
              n_diag_pad, T)
        ec.extd2_traceback(*tb)
        ec.tb_raw_launcher(*tb)()
        torch.cuda.synchronize(dev)
        assert seen == [("fwd", i), ("fwd", i), ("tb", i), ("tb", i)]
        assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_engine_and_kernels_on_second_card(two_cards, small_world):
    """K1/K2 and the engine on cuda:1 (a device other than the current
    one): the plain versions' output and the engine's results on
    cuda:0."""
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.engine import AlignEngine

    d0, d1 = two_cards
    q, ql, t, tl = _problems(np.random.default_rng(5), 176, 256, 256)
    cpu = ec.extd2_fwd(q, ql, t, tl, ALN, 256)
    gpu = ec.extd2_fwd(*(a.to(d1) for a in (q, ql, t, tl)), ALN, 256)
    assert torch.cuda.current_device() == 0
    for f in cpu._fields:
        assert torch.equal(getattr(cpu, f), getattr(gpu, f).cpu()), f
    idx, names, seqs = small_world
    oris = [OriResult(unmapped=True)] * len(seqs)
    want = _results(AlignEngine(idx, ori_chrom_names=names,
                                device=d0).align_batch(seqs, oris))
    assert _results(AlignEngine(idx, ori_chrom_names=names,
                                device=d1).align_batch(seqs, oris)) == want


@pytest.mark.cuda
def test_traceback_over_48k_shared_memory_on_two_cards(two_cards):
    """K2 at W = 256 asks for more than 48 KiB of shared memory a block:
    the limit is raised on the device of each launch, so a launch on the
    second card after one on the first still runs (and equals the plain
    version)."""
    Q, T, W = 176, 256, 256
    assert ec.tb_plan(W)[2] > 48 * 1024
    rng = np.random.default_rng(7)
    _, n_diag_pad, _, _ = plan(Q, T, W)
    B = 64
    dmat = torch.from_numpy(rng.integers(0, 256, (B, n_diag_pad, W),
                                         dtype=np.uint8))
    ql = torch.full((B,), Q, dtype=torch.int32)
    tl = torch.full((B,), T, dtype=torch.int32)
    args = (dmat, ql, tl, tl - 1, ql - 1)
    want = ec.extd2_traceback_plain(*args, ALN, W, n_diag_pad, T)
    for dev in two_cards:
        got = ec.extd2_traceback(*(a.to(dev) for a in args), ALN, W,
                                 n_diag_pad, T)
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu())


@pytest.fixture(scope="module")
def graph_worlds(tmp_path_factory):
    """A small bench world, its overflow world (widening and batch
    retries) and its uniform world (compaction): (world, -b) each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pansvr_tpu_torch import world

    d = tmp_path_factory.mktemp("graphs")
    w = world.build_bench_world(str(d / "bench"), n_pairs=6000)
    return dict(
        bench=(w, 1024),
        overflow=(world.build_overflow_world(w, str(d / "ovf"),
                                             n_reads=8192), 2048),
        uniform=(world.build_uniform_world(w, str(d / "uni"),
                                           n_pairs=4096), 512))


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth", [("bench", 3), ("bench", 1),
                                        ("overflow", 3), ("uniform", 3)])
def test_graphs_match_op_by_op(cuda_device, graph_worlds, tmp_path, name,
                               depth):
    """fc_aln with the per-batch CUDA graphs (fuse_chain, the default) and
    op by op (fuse_chain=False) on the card: identical BAM records and
    the same K1/K2 launches by DP shape; the graphs were captured and
    replayed."""
    import os

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.align.engine import EngineConfig
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_aln

    w, batch = graph_worlds[name]
    out = {}
    for fuse in (True, False):
        tune = os.path.join(w["index"], "engine_tune.json")
        if os.path.exists(tune):
            os.remove(tune)
        bam = str(tmp_path / f"{fuse}.bam")
        ec.reset_launches()
        eng = run_fc_aln(parse_args([
            "fc_aln", w["index"], w["signal"], w["header"], "-o", bam,
            "-r", w["status"], "-b", str(batch)]),
            config=EngineConfig(fuse_chain=fuse, stream_depth=depth))
        out[fuse] = (world.bam_records(bam), dict(ec.LAUNCHES_BY_SHAPE),
                     eng.prof)
    (a, la, p), (b, lb, q) = out[True], out[False]
    assert a and a == b
    assert la == lb and la
    assert p["n_graph_capture"] > 0 and p["n_graph_replay"] > p["n_graph_capture"]
    assert not q["n_graph_capture"] and not q["n_graph_replay"]
    for k in ("n_batches", "n_dp_chunks", "n_rechain", "n_widen", "n_retry",
              "n_compacted", "n_fallback"):
        assert p[k] == q[k], k
    if name == "overflow":
        assert p["n_widen"] and p["n_retry"]
    if name == "uniform":
        assert p["n_compacted"]


@pytest.mark.cuda
def test_replayed_batch_makes_no_stream_sync(cuda_device, small_world):
    """A batch that only replays graphs (front + chain + collect, every DP
    chunk) with the sync debug mode set to raise."""
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.align.engine import AlignEngine

    idx, names, seqs = small_world
    oris = [OriResult(unmapped=True)] * len(seqs)
    eng = AlignEngine(idx, ori_chrom_names=names, device=cuda_device)
    for _ in range(3):      # K settles, every shape set captured
        eng.align_batch(seqs, oris)
    n_cap, n_rep, n_dp = (eng.prof[k] for k in (
        "n_graph_capture", "n_graph_replay", "n_dp_chunks"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.align_batch(seqs, oris)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert any(s.results for s in got)
    assert eng.prof["n_graph_capture"] == n_cap
    assert eng.prof["n_graph_replay"] - n_rep == \
        1 + eng.prof["n_dp_chunks"] - n_dp


@pytest.mark.cuda
def test_dp_graph_with_k2_over_48k_matches_eager(cuda_device):
    """A DP chunk at 176x256 / W256 (K2 raises its shared-memory limit
    over 48 KiB before the launch, inside the capture) as a CUDA graph:
    equal to the eager program at every replay, on new metadata each
    time; its K1 and K2 launches counted once per replay."""
    from collections import defaultdict

    from pansvr_tpu_torch.align.programs import GraphCache, dp_program

    rng = np.random.default_rng(9)
    L, rows, size = 256, 512, 128
    codes = torch.from_numpy(rng.integers(0, 4, rows * L).astype(np.uint8))
    ref = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 4096,
                                        dtype=np.int64).astype(np.int32))
    tru = 4096 * 16 - 100

    def meta():
        qa = rng.integers(1, 177, size)
        tl = rng.integers(1, 257, size)
        return torch.from_numpy(np.stack([
            rng.integers(0, rows, size) * L + rng.integers(0, L - qa + 1),
            qa, rng.integers(0, tru, size), tl,
            rng.integers(0, 2, size)]).astype(np.int32))

    dev_codes, dev_ref = codes.to(cuda_device), ref.to(cuda_device)
    prof = defaultdict(float)
    cache = GraphCache(cuda_device, prof)
    kw = dict(cq=176, ct=256, W=256, size=size, params=ALN, tru_len=tru)
    fn = lambda inputs: dp_program(dev_codes, dev_ref, inputs["meta"], **kw)  # noqa: E731
    ec.reset_launches()
    for i in range(3):
        m = meta()
        got = cache.run(("dp",), fn, {"meta": m.to(cuda_device)},
                        fixed=(dev_codes, dev_ref))
        want = dp_program(codes, ref, m, **kw)
        for k in ("ops", "packed"):
            assert torch.equal(got[k].cpu(), want[k]), (i, k)
    assert prof["n_graph_capture"] == 1 and prof["n_graph_replay"] == 3
    assert ec.LAUNCHES == {"extd2_fwd": 3, "extd2_tb": 3}


@pytest.mark.cuda
def test_graphs_capture_widening_and_retry_mid_stream(cuda_device):
    """A depth-3 stream whose last batches overflow the flat lane pool of
    nf_mult 1 after earlier batches replayed their graphs (and compacted):
    the engine widens and retries those batches mid-stream, capturing the
    new front shape sets while earlier downloads are in flight, without
    error; one capture a shape set, none evicted; its BAM records equal
    fuse_chain=False's, which keys the same shape sets."""
    from pansvr_tpu_torch.align.bam_out import EmitContext
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import AnchorConfig, build_anchor_contigs
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.io.bam import BamHeader
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    kw = dict(seed=41, n_sv=5, types=("DEL", "INS"),
              chrom_lengths={"chr1": 300_000}, err_rate=0.02)
    uni = make_dataset(n_pairs=1800, sv_region_reads=False, **kw)
    hot = make_dataset(n_pairs=150, **kw)
    contigs = list(build_anchor_contigs(
        uni.vcf_records, DictGenome(uni.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    seqs = [s for r in uni.reads for s in (r.seq1, r.seq2)] \
        + [s for r in hot.reads for s in (r.seq1, r.seq2)]
    batches = []
    for b0 in range(0, len(seqs), 300):
        x = seqs[b0 : b0 + 300]
        batches.append((x, [OriResult(unmapped=True)] * len(x),
                        ([f"r{(b0 + i) // 2}" for i in range(len(x))],
                         ["I" * len(y) for y in x], [""] * len(x))))
    names = list(uni.genome)
    lens = [len(x) for x in uni.genome.values()]
    got = {}
    for fuse in (True, False):
        eng = AlignEngine(idx, ori_chrom_names=names, device=cuda_device,
                          config=EngineConfig(nf_mult=1, stream_depth=3,
                                              fuse_chain=fuse))
        eng.set_native_emit(EmitContext(eng.host, BamHeader(
            text="@HD\tVN:1.6\n", ref_names=names, ref_lens=lens),
            max_isize=600, min_isize=200, normal_read_len=150))
        got[fuse] = (list(eng.align_stream(iter(batches))), eng)
    (recs, g), (want, o) = got[True], got[False]
    assert recs == want and sum(map(len, recs)) > 10_000
    p = g.prof
    assert p["n_widen"] >= 1 and p["n_retry"] >= 1 and p["n_compacted"] > 0
    assert g.shape_sets == o.shape_sets
    nf = {k[7] for k in g.shape_sets["front"]}
    assert len(nf) >= 2, g.shape_sets["front"]      # a widening's new keys
    n_sets = len(g.shape_sets["front"]) + len(g.shape_sets["dp"])
    assert p["n_graph_capture"] == n_sets and not p["n_graph_evict"]
    assert p["n_graph_replay"] > p["n_graph_capture"]
    for k in ("n_batches", "n_widen", "n_retry", "n_compacted", "n_rechain",
              "n_fallback", "n_dp_chunks"):
        assert p[k] == o.prof[k], k


@pytest.mark.cuda
def test_capture_reserves_the_warm_up_temporaries_once(cuda_device):
    """A capture's eager warm-up allocates the program's temporaries (at
    least 128 MiB here) on the cache's side stream, the capture the same
    in the graph pool. The warm-up's blocks are released before the capture:
    the capture reserves the temporaries once at its peak (not warm-up
    and pool together), and after it no block of the side stream stays
    reserved outside the pool."""
    from collections import defaultdict

    from pansvr_tpu_torch.align.programs import GraphCache

    cache = GraphCache(cuda_device, defaultdict(float))
    x = (torch.arange(1 << 20, device=cuda_device) % 1000).to(torch.int32)

    def prog(inputs):
        big = inputs["x"].repeat(32)            # 128 MiB and more
        return {"y": big.view(32, -1).sum(0)}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    out = cache.run(("big",), prog, {"x": x})
    torch.cuda.synchronize()
    assert torch.equal(out["y"], x.to(torch.int64) * 32)
    segs = torch.cuda.memory_snapshot()
    pool = sum(s["total_size"] for s in segs
               if any(s.get("segment_pool_id", (0, 0))))
    side = cache._stream.cuda_stream
    left = [(s["total_size"], s["allocated_size"]) for s in segs
            if s["stream"] == side and not any(s.get("segment_pool_id",
                                                     (0, 0)))]
    peak = torch.cuda.max_memory_reserved() - base
    assert pool >= 128 << 20, (pool, segs)
    assert sum(t for t, _ in left) < 32 << 20, left
    # the capture's peak is its pool (the temporaries once) and the
    # inputs, not the warm-up's blocks beside the pool
    assert peak < pool + (64 << 20), (peak >> 20, pool >> 20)


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """A program that reads a device value back cannot be captured: the
    cache raises and keeps no graph (the engine has no op-by-op
    fallback). Last in the file: a failed capture may leave its memory
    pool marked as capturing."""
    from collections import defaultdict

    from pansvr_tpu_torch.align.programs import GraphCache

    prof = defaultdict(float)
    cache = GraphCache(cuda_device, prof)
    x = torch.arange(8, device=cuda_device)

    def reads_back(inputs):
        return {"y": inputs["x"] * int(inputs["x"].sum().item())}

    with pytest.raises(RuntimeError):
        cache.run(("reads_back",), reads_back, {"x": x})
    assert len(cache) == 0 and not prof["n_graph_capture"]
    assert not prof["n_graph_replay"]
