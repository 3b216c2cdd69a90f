"""The port's adaptive pipeline vs the JAX engine, batch by batch, on the
CPU (plain kernel versions): the same adaptive state after every batch
(speculative chain width with its misses, the compaction budget, lane
and collect budgets), the same alignments, and align_stream at depth 1
and 3 yielding the JAX stream's batches in order."""

import numpy as np
import pytest

from pansvr_tpu.align.engine import AlignEngine as JaxEngine
from pansvr_tpu.align.host_align import OriResult
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.utils.simulate import DictGenome, make_dataset
from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig


def _state(eng):
    c = eng.cfg
    return (eng._k_spec, eng._comp_cap, c.mem_slots, c.max_seeds,
            c.chain_bucket, c.nf_mult, c.collect_mult)


def _results(states):
    return [[(r.align_score, r.chain_score, r.ref_bg, r.read_bg, r.direction,
              r.sv_id, r.mapq, r.cigar) for r in s.results] for s in states]


def _many_mem_reads(contigs, rng, n, L=250, gap=25):
    """Anchor windows with a base inserted every `gap` bases: about
    L / gap MEMs on shifted diagonals (so they do not merge), more seeds
    than the first speculative width."""
    out = []
    for _ in range(n):
        seq = contigs[int(rng.integers(len(contigs)))].seq
        p = int(rng.integers(0, len(seq) - L))
        parts = [seq[q : q + gap - 1] + "ACGT"[int(rng.integers(4))]
                 for q in range(p, p + L, gap - 1)]
        out.append("".join(parts)[:L])
    return out


def test_trajectory_and_compaction_match_jax():
    """Reads drawn uniformly over the genome (sv_region_reads=False), so
    most rows hit no anchor k-mer: the compaction budget engages; eight
    many-MEM reads in the first batch make the speculative chain width
    miss (and grow, then shrink eight batches later). After every batch
    the port's adaptive state equals the JAX engine's, and its
    alignments equal both the JAX engine's and an uncompacted port
    engine's (tests/test_engine.py's compaction test, held against the
    JAX engine)."""
    ds = make_dataset(seed=41, n_sv=5, n_pairs=2200, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 300_000}, err_rate=0.02,
                      sv_region_reads=False)
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    seqs = _many_mem_reads(contigs, np.random.default_rng(5), 8) \
        + [s for r in ds.reads for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True)] * len(seqs)
    names = list(ds.genome)
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu")
    off = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(compact_div=1))
    jeng = JaxEngine(idx, ori_chrom_names=names)
    B = 512
    trail = []
    n_compacted = 0
    for b0 in range(0, len(seqs), B):
        sl = slice(b0, b0 + B)
        got = _results(eng.align_batch(seqs[sl], oris[sl]))
        assert got == _results(jeng.align_batch(seqs[sl], oris[sl])), b0
        if eng._comp_cap:       # this batch ran compacted
            assert got == _results(off.align_batch(seqs[sl], oris[sl])), b0
            n_compacted += 1
        assert _state(eng) == _state(jeng), b0
        assert list(eng._act_window) == list(jeng._act_window), b0
        trail.append(_state(eng))
    assert n_compacted >= 2 and off._comp_cap == 0, trail
    assert eng.prof["n_rechain"] > 0, "the speculative width never missed"
    assert trail[0][0] > 8 and trail[-1][0] == 8, trail   # grew, shrank


@pytest.fixture(scope="module")
def stream_world():
    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    batches = [(seqs[i : i + 32], [OriResult(unmapped=True)] * 32)
               for i in range(0, 128, 32)]
    jeng = JaxEngine(idx, ori_chrom_names=list(ds.genome))
    want = [_results(s) for s in jeng.align_stream(iter(batches))]
    return idx, list(ds.genome), batches, want, _state(jeng)


@pytest.mark.parametrize("depth,order,collect", [
    (3, "late", "auto"), (1, "late", "host"), (1, "early", "auto")])
def test_align_stream_matches_jax_stream(stream_world, depth, order, collect):
    idx, names, batches, want, jstate = stream_world
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(stream_depth=depth,
                                          pipe_order=order, collect=collect))
    got = [_results(s) for s in eng.align_stream(iter(batches))]
    assert len(got) == len(batches)
    assert got == want
    assert _state(eng) == jstate
    assert sum(map(len, sum(got, []))) > 30
