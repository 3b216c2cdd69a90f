"""The port's per-batch programs (pansvr_tpu_torch/align/programs.py)
against the JAX engine's fused programs, on the CPU:

  (a) front_program against _device_front + _collect_fused (device
      collect) and _device_front + _chain_body_fused (host collect),
      compacted and not, every array exact;
  (b) dp_program against _device_dp_pallas_meta in interpret mode, on
      real DP chunks of each class, exact;
  (c) the engine through a replay emulator (a program cache that runs
      each program eagerly into the same output tensors on every call, as
      a CUDA graph's replay writes them) at stream depth 1 and 3, over a
      stream that re-chains, engages the compaction budget and widens
      with batch retries: the BAM records equal the JAX engine's; and
      over tests/test_parallel.py's engine world, whose first batch
      re-chains after the next two batches replayed its front program:
      the alignments equal the op-by-op engine's and the JAX engine's. A
      tensor the engine read after a later replay of its graph would
      change them;
  (d) the cache: one capture per shape set, its bound, its counters and
      the launches a capture records, counted again at every replay.

The CUDA graphs themselves are held on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from pansvr_tpu.align import engine as je
from pansvr_tpu.align.bam_out import EmitContext as JaxEmit
from pansvr_tpu.align.engine import AlignEngine as JaxEngine
from pansvr_tpu.align.engine import EngineConfig as JaxConfig
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.index.device import to_device as jax_to_device
from pansvr_tpu.io.bam import BamHeader as JaxHeader
from pansvr_tpu.ops.extd2_jax import Extd2Params as JaxParams
from pansvr_tpu.ops.extd2_pallas import BLK
from pansvr_tpu.utils.simulate import DictGenome, make_dataset
from pansvr_tpu_torch.align import programs as pg
from pansvr_tpu_torch.align.bam_out import EmitContext
from pansvr_tpu_torch.align.engine import (
    AlignEngine,
    EngineConfig,
    chain_unpack,
)
from pansvr_tpu_torch.align.host_align import LEN_KMER, OriResult
from pansvr_tpu_torch.io.bam import BamHeader
from pansvr_tpu_torch.ops import extd2_cuda as ec

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")


class ReplayEmulator(pg.ProgramCache):
    """A CUDA graph's replay on the CPU: the capture runs the program
    once and keeps copies of its outputs as the program's output tensors;
    every replay runs it eagerly again and writes the same tensors."""

    def _capture(self, fn, inputs):
        with ec.record_launches() as launches:
            out = fn(inputs)
        return fn, {k: v.clone() for k, v in out.items()}, list(launches)

    def _replay(self, p):
        # a replay runs no Python: the cache counts the capture's launches
        with ec.record_launches():
            res = p.handle(p.inputs)
        for k, v in res.items():
            p.out[k].copy_(v)


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (what, a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.fixture(scope="module")
def world():
    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cpu")
    seqs = [s for r in ds.reads[:100] for s in (r.seq1, r.seq2)]
    prep = eng._prep_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    return eng, jax_to_device(idx), prep, seqs


@pytest.mark.parametrize("comp,collect", [
    (0, "device"), (256, "device"), (0, "host"), (256, "host")],
    ids=["rows-device", "rid-device", "rows-host", "rid-host"])
def test_front_program_matches_jax(world, comp, collect):
    eng, jd, prep, _ = world
    L, S0, n_pad = prep["L"], prep["S0"], prep["n_pad"]
    B2 = 2 * n_pad
    n_ext = max(9, -(-(L - LEN_KMER) // 16))
    M = max(32, (S0 + 1 + 15) // 16 * 16)
    S, K = 32, 16
    NC, NP = (n_pad, 2 * n_pad) if collect == "device" else (0, 0)
    shapes = dict(L=L, n_pad=n_pad, S0=S0, S=S, M=M, n_ext=n_ext,
                  nf_mult=10, comp=comp, K=K, NC=NC, NP=NP)
    assert set(shapes) == set(pg.FRONT_SHAPES)
    out = pg.front_program(eng.didx, {
        k: torch.from_numpy(prep[k])
        for k in ("words", "lens2", "mask2", "is_str2", "act_pad")}, shapes)

    mask_w = je._pack_mask_host(prep["mask2"])
    front = je._device_front(jd, prep["words"], prep["lens2"], mask_w,
                             S0=S0, S=S, M=M, n_ext=n_ext, nf_mult=10,
                             compact=comp)
    es, stats3 = front[:2]
    rid = front[2] if comp else None
    R = int(rid.shape[0]) if comp else 0
    assert ("rid" in out) == bool(comp)
    if comp:
        _eq(rid, out["rid"].numpy(), "rid")
        assert (np.asarray(rid) >= B2).any()      # empty compacted slots
    for f in pg.ES_FIELDS:
        _eq(getattr(es, f), out[f"es/{f}"].numpy(), f"es.{f}")
    _eq(je._unpack_codes(prep["words"], L), out["codes"].numpy(), "codes")

    chain = {k[6:]: v.numpy() for k, v in out.items()
             if k.startswith("chain/")}
    if collect == "device":
        buf = je._collect_fused(
            stats3, es, prep["is_str2"], K=K, rid=rid,
            active_words=je._pack_mask_host(prep["act_pad"][None, :]).ravel(),
            n_pad=n_pad, NC=NC, NP=NP)
        want = je._collect_unpack(np.asarray(buf), B2, K, n_pad, NC, NP, R)
        names = ("stats3", "over", "scal", "chain_meta", "path_a", "path_b",
                 "path_dfe")
        assert set(chain) == set(names)
        assert int(chain["scal"][0]) > 0
    else:
        buf = je._chain_body_fused(stats3, es, prep["is_str2"], K=K, rid=rid)
        want = je._chain_unpack(np.asarray(buf), B2, K, R)
        names = ("stats3", "s_fb", "p16", "pre", "hits8", "hscore")
        chain = dict(stats3=chain["stats3"],
                     **dict(zip(names[1:], chain_unpack(chain, B2, K))))
        assert (chain["hits8"][0] >= 0).any()
    for name, a in zip(names, want):
        _eq(a, chain[name], name)


@pytest.fixture(scope="module")
def dp_chunks(world):
    """The DP chunks of one batch through the port's engine: (codes,
    meta, cq, ct, W, size) per chunk."""
    eng, _, _, seqs = world
    got = []
    run_dp = eng._run_dp

    def keep(codes, meta, cq, ct, W, size):
        got.append((codes.clone(), meta.clone(), cq, ct, W, size))
        return run_dp(codes, meta, cq, ct, W, size)

    eng._run_dp = keep
    try:
        eng.align_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    finally:
        del eng._run_dp
    return got


@pytest.mark.parametrize("cls", [0, 1, 2], ids=["48x64", "96x128",
                                                "176x256"])
def test_dp_program_matches_jax(world, dp_chunks, cls):
    eng, jd, _, _ = world
    cq, ct, W, _, _ = EngineConfig().dp_classes(160)[cls]
    codes, meta, _, _, _, _ = next(c for c in dp_chunks
                                   if c[2:5] == (cq, ct, W))
    B = BLK    # the Pallas kernels take whole blocks of problems
    meta = meta[:, :B].contiguous()
    got = pg.dp_program(codes, eng.didx.ref_words, meta, cq, ct, W, B,
                        params=eng.dp_params, tru_len=eng._tru_ref_len)
    m = meta.numpy()
    buf = je._device_dp_pallas_meta(
        codes.numpy(), np.asarray(jd.ref_words), m[0], m[1], m[2], m[3],
        m[4], np.array([eng._tru_ref_len], np.int32),
        params=JaxParams(**eng.dp_params._asdict()), W=W, interpret=True,
        cq=cq, ct=ct)
    ops, packed = je._dp_unpack(np.asarray(buf), B)
    _eq(packed, got["packed"].numpy(), "packed")
    _eq(ops[:, : got["ops"].shape[1]], got["ops"].numpy(), "ops")
    assert (ops[:, got["ops"].shape[1]:] == 3).all()
    assert (m[1] > 1).sum() >= 4            # real problems, not padding


def _many_mem_reads(contigs, rng, n, L=250, gap=25):
    """Anchor windows with a base inserted every `gap` bases: more MEMs
    on shifted diagonals than the first speculative chain width."""
    out = []
    for _ in range(n):
        seq = contigs[int(rng.integers(len(contigs)))].seq
        p = int(rng.integers(0, len(seq) - L))
        parts = [seq[q : q + gap - 1] + "ACGT"[int(rng.integers(4))]
                 for q in range(p, p + L, gap - 1)]
        out.append("".join(parts)[:L])
    return out


@pytest.fixture(scope="module")
def churn_world():
    """Nine batches of 300 reads (n_pad 512): reads uniform over the
    genome (most rows hit no anchor: the compaction budget engages at
    the fifth or sixth batch); in the first batch four many-MEM reads
    and 40 reads of the SV regions (the speculative chain width misses:
    the whole batch is chained again at full width, after the next two
    batches' fronts replayed the same program at depth 3); last, the
    remaining 260 SV-region reads (the flat lane pool of nf_mult 1
    overflows: two widenings with batch retries)."""
    kw = dict(seed=41, n_sv=5, types=("DEL", "INS"),
              chrom_lengths={"chr1": 300_000}, err_rate=0.02)
    uni = make_dataset(n_pairs=1800, sv_region_reads=False, **kw)
    hot = make_dataset(n_pairs=150, **kw)
    contigs = list(build_anchor_contigs(
        uni.vcf_records, DictGenome(uni.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    hot_seqs = [s for r in hot.reads for s in (r.seq1, r.seq2)]
    seqs = _many_mem_reads(contigs, np.random.default_rng(5), 4) \
        + hot_seqs[:40]
    seqs += [s for r in uni.reads[:1178] for s in (r.seq1, r.seq2)]
    seqs += hot_seqs[40:]
    batches = []
    for b0 in range(0, len(seqs), 300):
        s = seqs[b0 : b0 + 300]
        names = [f"r{(b0 + i) // 2}" for i in range(len(s))]
        quals = ["I" * len(x) for x in s]
        batches.append((s, [OriResult(unmapped=True)] * len(s),
                        (names, quals, [""] * len(s))))
    names = list(uni.genome)
    lens = [len(s) for s in uni.genome.values()]
    # the JAX engine at its default lane budgets and uncompacted: the
    # records depend on neither (reads over a budget take the exact host
    # path), and each widening or compaction budget would compile its
    # programs again
    jeng = JaxEngine(idx, ori_chrom_names=names,
                     config=JaxConfig(compact_div=1))
    jeng.set_native_emit(JaxEmit(jeng.host, JaxHeader(
        text="@HD\tVN:1.6\n", ref_names=names, ref_lens=lens),
        max_isize=600, min_isize=200, normal_read_len=150))
    want = list(jeng.align_stream(iter(batches)))
    return idx, names, lens, batches, want


# one read class for every batch (the many-MEM reads are 250 long), so the
# batches share their front programs; 128-problem DP chunks keep the plain
# kernels' padded work small
GRAPH_CFG = dict(dp_chunk=128, read_classes=(256, 1600))


def _results(states):
    return [[(r.align_score, r.chain_score, r.direction, r.ref_bg, r.sv_id,
              r.mapq, r.cigar) for r in s.results] for s in states]


@pytest.fixture(scope="module")
def graph_world():
    """tests/test_parallel.py's engine world, its 160 reads in five
    batches of 32, four many-MEM reads first: the first batch's
    speculative chain width misses, and at depth 3 the next two batches
    replay its front program before its re-chain. Returns (index, names,
    batches, the JAX engine's alignments)."""
    ds = make_dataset(seed=44, n_sv=4, n_pairs=80, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 120_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=11)
    seqs = [r.seq1 for r in ds.reads] + [r.seq2 for r in ds.reads]
    seqs = _many_mem_reads(contigs, np.random.default_rng(5), 4) + seqs[:156]
    batches = [(seqs[i : i + 32], [OriResult(unmapped=True)] * 32)
               for i in range(0, 160, 32)]
    names = list(ds.genome)
    jeng = JaxEngine(idx, ori_chrom_names=names, config=JaxConfig(**GRAPH_CFG))
    want = [_results(s) for s in jeng.align_stream(iter(batches))]
    return idx, names, batches, want


def _graph_world_through_emulator(graph_world, depth):
    idx, names, batches, want = graph_world
    cfg = dict(GRAPH_CFG, stream_depth=depth)
    got, engs = {}, {}
    for graphs in (True, False):
        eng = engs[graphs] = AlignEngine(idx, ori_chrom_names=names,
                                         device="cpu",
                                         config=EngineConfig(**cfg))
        if graphs:
            eng._programs = ReplayEmulator(eng.device, eng.prof)
        got[graphs] = [_results(s) for s in eng.align_stream(iter(batches))]
        assert eng.prof["n_rechain"] > 0
    assert got[True] == got[False] == want
    assert sum(bool(r) for b in want for r in b) >= 40
    g, o = engs[True].prof, engs[False].prof
    for k in ("n_batches", "n_dp_chunks", "n_rechain", "n_fallback"):
        assert g[k] == o[k], k
    assert g["n_graph_capture"] == len(engs[True]._programs)
    assert g["n_graph_replay"] == g["n_batches"] + g["n_dp_chunks"]
    assert not g["n_graph_evict"] and not o["n_graph_capture"]


@pytest.mark.parametrize("name,depth", [
    pytest.param("churn", 1, id="1"), pytest.param("churn", 3, id="3"),
    pytest.param("graph", 1, id="graph-1"),
    pytest.param("graph", 3, id="graph-3")])
def test_engine_through_replay_emulator_matches_jax(request, name, depth):
    if name == "graph":
        _graph_world_through_emulator(request.getfixturevalue("graph_world"),
                                      depth)
        return
    idx, names, lens, batches, want = request.getfixturevalue("churn_world")
    # one read class for every batch (the many-MEM reads are 250 long),
    # so the first batches share their front program
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(nf_mult=1, stream_depth=depth,
                                          read_classes=(256, 1600)))
    eng._programs = ReplayEmulator(eng.device, eng.prof)
    eng.set_native_emit(EmitContext(eng.host, BamHeader(
        text="@HD\tVN:1.6\n", ref_names=names, ref_lens=lens),
        max_isize=600, min_isize=200, normal_read_len=150))
    got = list(eng.align_stream(iter(batches)))
    assert len(got) == len(want) == len(batches)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"batch {i}: BAM records differ"
    p = eng.prof
    keys = list(eng._programs._progs)
    comps = {k[8] for k in keys if k[0] == "front"}
    assert p["n_rechain"] > 0 and p["n_widen"] > 0 and p["n_retry"] > 0, p
    assert len(comps) >= 2 and p["n_compacted"] > 0, keys
    assert p["n_graph_capture"] == len(keys) and not p["n_graph_evict"]
    assert p["n_graph_replay"] > p["n_graph_capture"]
    assert sum(map(len, got)) > 10_000


def test_stream_keys_one_capture_a_shape_set_as_op_by_op(churn_world):
    """The churn stream (re-chain, compaction, widenings with batch
    retries mid-stream) at depth 3 through the replay emulator and op by
    op: both key the same front and DP shape sets, in the same order;
    with the emulator each is captured once, none is evicted, and the
    most held at once is their count. The stream's own counters say how
    many of each it keyed."""
    idx, names, lens, batches, want = churn_world
    cfg = dict(nf_mult=1, stream_depth=3, read_classes=(256, 1600))
    engines = {}
    for graphs in (True, False):
        eng = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                          config=EngineConfig(**cfg))
        if graphs:
            eng._programs = ReplayEmulator(eng.device, eng.prof)
        eng.set_native_emit(EmitContext(eng.host, BamHeader(
            text="@HD\tVN:1.6\n", ref_names=names, ref_lens=lens),
            max_isize=600, min_isize=200, normal_read_len=150))
        assert list(eng.align_stream(iter(batches))) == want
        engines[graphs] = eng
    g, o = engines[True], engines[False]
    assert g.shape_sets == o.shape_sets
    n_front, n_dp = (len(g.shape_sets[k]) for k in ("front", "dp"))
    p = g.prof
    assert p["n_widen"] >= 2 and p["n_retry"] >= 2 and p["n_compacted"] > 0
    assert n_front >= 4 and n_dp >= 3
    assert (p["n_front_shape_sets"], p["n_dp_shape_sets"]) == (n_front, n_dp)
    assert (o.prof["n_front_shape_sets"], o.prof["n_dp_shape_sets"]) == \
        (n_front, n_dp)
    assert p["n_graph_capture"] == n_front + n_dp == len(g._programs)
    assert p["n_graph_held_max"] == n_front + n_dp
    assert not p["n_graph_evict"] and not o.prof["n_graph_capture"]
    assert set(g._programs._progs) == g.shape_sets["front"] | \
        g.shape_sets["dp"]


def test_program_cache_captures_once_per_shape_set(world):
    """One capture per key, replays into the same output tensors, the
    LRU bound, the counters, fixed inputs held to their storage, and the
    launches recorded at the capture counted at every replay."""
    prof = defaultdict(float)
    cache = ReplayEmulator("cpu", prof, max_programs=2)
    runs = []

    def prog(n):
        def fn(inputs):
            runs.append(n)
            # a wrapper's launch count, as K1 makes it on a card
            ec._count("extd2_fwd", 64, 64, n, ())
            return {"y": inputs["x"] * 2 + n}
        return fn

    ec.reset_launches()
    x = torch.arange(4, dtype=torch.int32)
    try:
        out = cache.run(("a",), prog(1), {"x": x})
        assert out["y"].tolist() == [1, 3, 5, 7]
        again = cache.run(("a",), prog(1), {"x": x + 1})
        assert again["y"] is out["y"] and out["y"].tolist() == [3, 5, 7, 9]
        assert prof["n_graph_capture"] == 1 and prof["n_graph_replay"] == 2
        assert prof["graph_capture_s"] > 0
        # the capture's launch is counted once per replay, never for the
        # capture itself
        assert ec.LAUNCHES["extd2_fwd"] == 2
        assert ec.LAUNCHES_BY_SHAPE == {("extd2_fwd", 64, 64, 1): 2}
        with pytest.raises(ValueError, match="input x"):
            cache.run(("a",), prog(1), {"x": torch.arange(5)})
        cache.run(("b",), prog(2), {"x": x})
        cache.run(("c",), prog(3), {"x": x})
        assert len(cache) == 2 and prof["n_graph_evict"] == 1
        assert prof["n_graph_held_max"] == 2
        cache.run(("a",), prog(1), {"x": x})     # evicted: captured again
        assert prof["n_graph_capture"] == 4 and len(cache) == 2

        buf = torch.zeros(4, dtype=torch.int32)
        fn = lambda inputs: {"y": buf + inputs["x"]}   # noqa: E731
        cache.run(("f",), fn, {"x": x}, fixed=(buf,))
        buf += 10
        assert cache.run(("f",), fn, {"x": x}, fixed=(buf,))["y"].tolist() \
            == [10, 11, 12, 13]
        with pytest.raises(RuntimeError, match="moved"):
            cache.run(("f",), fn, {"x": x}, fixed=(buf.clone(),))
    finally:
        ec.reset_launches()

    with pytest.raises(ValueError, match="CUDA device"):
        pg.GraphCache("cpu", prof)
    # the CPU runs the programs op by op whatever fuse_chain says
    eng, _, _, _ = world
    for fuse in (True, False):
        e = AlignEngine(eng.idx, device="cpu",
                        config=EngineConfig(fuse_chain=fuse))
        assert e._programs is None
