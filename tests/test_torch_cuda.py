"""Port tests that need a CUDA card (marked `cuda`; they skip elsewhere).

This file imports neither jax nor the JAX package (the port's own host
modules build its worlds), so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax). The kernels are held
bit-exact against their plain PyTorch versions on the card, and the card
engine against the CPU engine and the NumPy host aligner: its device
collect, its depth-3 stream with the adaptive state after every batch,
and a whole batch without a stream sync.
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
    """run --sv-shards: two fc_sv worker processes run their contig DP on
    one card and merge to the VCF of one fc_sv process."""
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_sv
    from pansvr_tpu_torch.io.fasta import write_fasta
    from pansvr_tpu_torch.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu_torch.parallel.fanout import run_sv_fanout
    from pansvr_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from pansvr_tpu_torch.utils.simulate import make_dataset, write_sim_bam

    ds = make_dataset(seed=77, n_sv=3, n_pairs=400, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 100_000}, err_rate=0.0)
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
    merged = run_sv_fanout(*args, str(tmp_path / "fan.vcf"), n_shards=2,
                           status_file=str(work / "status.txt"), device="cuda")
    assert "\tPASS\t" in open(single).read()
    assert open(merged).read() == open(single).read()
