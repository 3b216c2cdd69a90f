"""The front, chain, collect and DP glue kernels (csrc/front.cu) against
the plain PyTorch programs they stand in for on a card, on the CPU.

csrc/front.cu keeps one thread an item and shares nothing between
threads but its scans, so a host build (g++ with PANSVR_HOST) runs each
kernel as a loop over its threads; ops/front_cuda.py drives it with CPU
tensors exactly as it drives the card's build. Every output must equal
the plain program's bit for bit, the rows the engine sends to the host
path (lane pool, M and S overflow, compaction budget) included, since
their lanes still take collect budget. The card's own build is held to
the same programs by tests/test_torch_cuda.py.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pansvr_tpu_torch.align import programs
from pansvr_tpu_torch.align.host_align import OriResult
from pansvr_tpu_torch.index.builder import build_index
from pansvr_tpu_torch.index.device import to_device
from pansvr_tpu_torch.ops import front_cuda
from pansvr_tpu_torch.ops.seeding import SEED_STEP, pack_reads
from pansvr_tpu_torch.utils import dna
from pansvr_tpu_torch.utils.simulate import random_genome

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pansvr_tpu_torch", "csrc", "front.cu")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/front.cu built for the host, bound as the card's library."""
    import ctypes

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of csrc/front.cu")
    out = str(tmp_path_factory.mktemp("front") / "libfront_host.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-fPIC",
                    "-shared", "-DPANSVR_HOST", "-o", out, CSRC],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    front_cuda.bind(lib)
    return lib


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(30)
    contigs = list(random_genome(rng, {f"c{i}": 2500 for i in range(4)}).items())
    # an exact repeat across two contigs: unitigs with pos_n > 1
    rep = contigs[0][1][500:900]
    c1 = contigs[1][1]
    contigs[1] = (contigs[1][0], c1[:1000] + rep + c1[1400:])
    idx = build_index(contigs, first_level_bases=10)
    return to_device(idx, device="cpu"), contigs


def _batch(world, seed, n=48, L=150, cls=160):
    """Packed rows of a batch (fwd then rev halves, as the engine lays
    them out): mutated copies, unrelated reads, short reads, STR-masked
    seed positions and STR rows."""
    _, contigs = world
    rng = np.random.default_rng(seed)
    codes = []
    for _ in range(n):
        _, seq = contigs[int(rng.integers(len(contigs)))]
        p = int(rng.integers(0, len(seq) - L))
        c = dna.encode(seq[p : p + L])
        m = rng.random(L) < 0.03
        c[m] = (c[m] + 1) % 4
        codes.append(c)
    codes = np.stack(codes)
    codes[::7] = rng.integers(0, 4, codes[::7].shape).astype(np.uint8)
    codes = np.concatenate([codes, (3 - codes)[:, ::-1]])
    B = len(codes)
    lens = np.full(B, L, np.int32)
    lens[::5] = 120
    S0 = (cls - 20) // SEED_STEP + 1
    padded = np.zeros((B, cls), np.uint8)
    padded[:, :L] = codes
    mask = np.ones((B, S0), bool)
    mask[3, ::3] = False
    mask[B // 2 + 4, 1::2] = False
    is_str = rng.random(B) < 0.2
    act = rng.random(B // 2) < 0.9
    return dict(words=torch.from_numpy(pack_reads(padded)),
                lens2=torch.from_numpy(lens), mask2=torch.from_numpy(mask),
                is_str2=torch.from_numpy(is_str),
                act_pad=torch.from_numpy(act), S0=S0, L=cls, n_pad=B // 2,
                n_ext=max(9, -(-(cls - 20) // 16)))


def _plain_front(didx, b, S, M, nf_mult, comp):
    es, stats3, rid = programs.front_seeds(
        didx, b["words"], b["lens2"], b["mask2"], b["S0"], S, M,
        b.get("n_ext", 9), nf_mult, comp)
    is_str = b["is_str2"]
    if rid is not None:
        B = b["words"].shape[0]
        is_str = is_str[rid.long().clamp(0, B - 1)] & (rid < B)
    return es, stats3, rid, is_str, programs.unpack_codes(b["words"], b["L"])


FRONTS = {  # S, M, nf_mult, comp
    "fits": (32, 32, 10, 0),
    "m_overflow": (32, 8, 4, 0),
    "flat_overflow": (32, 32, 1, 0),
    "s_dropped": (1, 32, 10, 0),
    "compact": (32, 32, 10, 64),
    "over_budget": (32, 32, 10, 16),
    "compact_flat_overflow": (32, 32, 1, 64),
    "class256_wide": (64, 64, 10, 0),
    "class1600_widest": (128, 320, 10, 0),
}
CLASS = {"class256_wide": (250, 256), "class1600_widest": (1500, 1600)}


@pytest.mark.parametrize("case", list(FRONTS))
def test_front_kernels_match_plain(host_lib, world, case):
    S, M, nf_mult, comp = FRONTS[case]
    didx = world[0]
    L, cls = CLASS.get(case, (150, 160))
    b = _batch(world, 35, n=48 if cls < 1600 else 8, L=L, cls=cls)
    want = _plain_front(didx, b, S, M, nf_mult, comp)
    got = front_cuda.front(didx, b["words"], b["lens2"], b["mask2"],
                           b["is_str2"], b["S0"], S, M, b["n_ext"], nf_mult,
                           comp, b["L"], lib=host_lib)
    for f in front_cuda.ES_FIELDS:
        assert torch.equal(getattr(want[0], f), getattr(got[0], f)), f
    # uncompacted, the chain rows' is_str is the batch's own
    got = (*got[:3], b["is_str2"] if got[3] is None else got[3], got[4])
    for name, w, g in zip(("stats3", "rid", "is_str", "codes"), want[1:],
                          got[1:]):
        if w is None:
            assert g is None, name
        else:
            assert w.dtype == g.dtype and torch.equal(w, g), name
    ov = want[1][0]
    assert want[0].valid.any()
    flag = {"m_overflow": (ov > 0) & (ov < (1 << 20)),
            "flat_overflow": (ov & (1 << 20)) != 0,
            "s_dropped": want[1][1] > 0,
            "over_budget": (ov & (1 << 21)) != 0}.get(case)
    if flag is not None:
        assert flag.any(), case


CHAINS = {  # front case, K, NC / NP as multiples of n_pad (0: host collect)
    "host_k8": ("fits", 8, None),
    "host_k32_compact": ("compact", 32, None),
    "device": ("fits", 32, (1, 2)),
    "device_k8_compact": ("compact", 8, (1, 2)),
    "device_tiny_budget": ("fits", 32, (16, 24)),
    "device_tiny_budget_compact": ("compact", 16, (16, 24)),
    "device_flat_overflow": ("flat_overflow", 32, (1, 2)),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_chain_and_collect_kernels_match_plain(host_lib, world, case):
    front, K, budget = CHAINS[case]
    S, M, nf_mult, comp = FRONTS[front]
    didx = world[0]
    b = _batch(world, 36)
    n_pad = b["n_pad"]
    es, _, rid, is_str, _ = _plain_front(didx, b, S, M, nf_mult, comp)
    if budget is None:
        NC = NP = 0
    elif budget[0] > 2:
        NC, NP = budget
    else:
        NC, NP = budget[0] * n_pad, budget[1] * n_pad
    active = b["act_pad"]
    want = programs.chain_program(es, is_str, rid, active, K, n_pad, NC, NP)
    got = front_cuda.chain_program(es, is_str, rid, active, K, n_pad, NC, NP,
                                   lib=host_lib)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
    if NC:
        assert (want["chain_meta"][:, 0] >= 0).any()
        if case.startswith("device_tiny"):
            assert want["over"].any()
    else:
        assert (want["hits8"][0] >= 0).any()


def test_chain_kernel_on_an_engine_batch(host_lib):
    """A prepared batch of simulated SV reads (the engine's own rows,
    STR screen included) through the kernels' front, chain and device
    collect, against the plain programs."""
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.anchor.builder import (AnchorConfig,
                                                 build_anchor_contigs)
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cpu")
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    prep = eng._prep_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    b = {k: torch.from_numpy(prep[k]) for k in
         ("words", "lens2", "mask2", "is_str2", "act_pad")}
    b.update(S0=prep["S0"], L=prep["L"], n_pad=prep["n_pad"])
    n_pad = b["n_pad"]
    for comp in (0, 256):
        want = _plain_front(eng.didx, b, 32, 32, 10, comp)
        got = front_cuda.front(eng.didx, b["words"], b["lens2"], b["mask2"],
                               b["is_str2"], b["S0"], 32, 32, 9, 10, comp,
                               b["L"], lib=host_lib)
        for f in front_cuda.ES_FIELDS:
            assert torch.equal(getattr(want[0], f), getattr(got[0], f)), f
        got = (*got[:3], b["is_str2"] if got[3] is None else got[3], got[4])
        for w, g in zip(want[1:], got[1:]):
            assert (w is None and g is None) or torch.equal(w, g)
        es, _, rid, is_str, _ = want
        for K, NC, NP in ((32, n_pad, 2 * n_pad), (16, 0, 0)):
            w = programs.chain_program(es, is_str, rid, b["act_pad"], K,
                                       n_pad, NC, NP)
            g = front_cuda.chain_program(es, is_str, rid, b["act_pad"], K,
                                         n_pad, NC, NP, lib=host_lib)
            for k in w:
                assert torch.equal(w[k], g[k]), (comp, K, k)
        if comp == 0:
            assert int(w["hits8"][0].ge(0).sum()) > n_pad // 2


def test_kept_engine_batch_matches_plain_and_counts_launches(host_lib):
    """align.kernel_table on the CPU: the batch an engine ran, kept by
    keep_batch, through the kernels' front_program, host-collect pack
    and full-width re-chain equals the plain programs; each entry point
    counts its launches, and a launch recorded at a graph's capture
    counts at each replay instead."""
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.align.kernel_table import check_batch, keep_batch
    from pansvr_tpu_torch.anchor.builder import (AnchorConfig,
                                                 build_anchor_contigs)
    from pansvr_tpu_torch.ops import extd2_cuda as ec
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=43, n_sv=5, n_pairs=120, types=("DEL", "DUP"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cpu")
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    with keep_batch() as kept:
        eng.align_batch(seqs, [OriResult(unmapped=True)] * len(seqs))
    assert kept["shapes"]["n_pad"] >= len(seqs) // 2 and "dp" in kept
    ec.reset_launches()
    n = check_batch(kept, lib=host_lib)
    assert set(n) == {"front_program", "host_collect", "rechain"}
    collects = 2 if kept["shapes"]["NC"] else 0
    assert ec.FRONT_LAUNCHES == {"pansvr_front": 1, "pansvr_chain": 3,
                                 **({"pansvr_collect": collects}
                                    if collects else {})}
    assert ec.LAUNCHES == {"extd2_fwd": 0, "extd2_tb": 0}
    with ec.record_launches() as record:
        check_batch(kept, lib=host_lib)
    assert ec.FRONT_LAUNCHES["pansvr_front"] == 1
    ec.count_launches(record)
    ec.count_launches(record)
    assert ec.FRONT_LAUNCHES["pansvr_front"] == 3
    assert ec.FRONT_LAUNCHES["pansvr_chain"] == 9
    ec.reset_launches()
    assert ec.FRONT_LAUNCHES == {}


def test_dp_fill_and_pack_kernels_match_plain(host_lib):
    """The DP chunk's fill from request metadata (reversed rows, targets
    past the reference's end and before its start) and the walk start
    and packing around K1 / K2, against programs.dp_fill_meta and
    dp_chunk's arithmetic."""
    rng = np.random.default_rng(7)
    size, cq, ct = 96, 48, 64
    codes = torch.from_numpy(rng.integers(0, 4, 4000).astype(np.uint8))
    ref = torch.from_numpy(rng.integers(-2**31, 2**31, 300, dtype=np.int64)
                           .astype(np.int32))
    tru_len = 300 * 16 - 37
    meta = np.stack([rng.integers(-5, 3990, size),
                     rng.integers(1, cq + 1, size),
                     rng.integers(-40, tru_len + 20, size),
                     rng.integers(1, ct + 1, size),
                     rng.integers(0, 2, size)]).astype(np.int32)
    wide = torch.from_numpy(np.concatenate([meta, meta], 1))
    for m in (torch.from_numpy(meta), wide[:, size:]):
        qc, ql, tc, tl = programs.dp_fill_meta(codes, ref, m[0], m[1], m[2],
                                               m[3], m[4], tru_len, cq, ct)
        g = [torch.empty((size, cq), dtype=torch.uint8),
             torch.empty((size, ct), dtype=torch.uint8),
             torch.empty(size, dtype=torch.int32),
             torch.empty(size, dtype=torch.int32)]
        front_cuda._call(host_lib, "pansvr_dp_fill", torch.device("cpu"),
                         (codes, ref, m, *g),
                         [size, cq, ct, 4000, 300, tru_len, m.stride(0)])
        for w, x in zip((qc, tc, ql, tl), (g[0], g[1], g[2], g[3])):
            assert torch.equal(w.to(torch.int32), x.to(torch.int32))
    out9 = torch.from_numpy(rng.integers(-3, 40, (9, size)).astype(np.int32))
    fin = torch.from_numpy(rng.integers(-1, 40, (2, size)).astype(np.int32))
    i0, j0, packed = (torch.empty(size, dtype=torch.int32),
                      torch.empty(size, dtype=torch.int32),
                      torch.empty((8, size), dtype=torch.int32))
    cpu = torch.device("cpu")
    front_cuda._call(host_lib, "pansvr_dp_start", cpu,
                     (out9, ql, tl, i0, j0), [size])
    front_cuda._call(host_lib, "pansvr_dp_pack", cpu, (out9, fin, packed),
                     [size])
    zd, mq, mt = out9[8] > 0, out9[6], out9[7]
    assert torch.equal(i0, torch.where(~zd, tl - 1,
                                       torch.where(mt >= 0, mt, -1)))
    assert torch.equal(j0, torch.where(~zd, ql - 1,
                                       torch.where(mq >= 0, mq, -1)))
    assert torch.equal(packed, torch.stack(
        [out9[0], out9[1], out9[5], out9[6], out9[7], zd.to(torch.int32),
         fin[0], fin[1]]))
