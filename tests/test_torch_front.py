"""Port device front (index tensors, seed_reads_flat, merge_expand_device3)
vs the JAX package on numpy-seeded reads: bit-exact against both JAX
probes (bisect and sort-merge join), with small lane budgets forcing the
overflow flags."""

import os

import numpy as np
import pytest
import torch

from pansvr_tpu.align.host_align import SEED_STEP
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.index.device import to_device as jax_to_device
from pansvr_tpu.ops import seeding as js
from pansvr_tpu.utils import dna
from pansvr_tpu.utils.simulate import random_genome
from pansvr_tpu_torch.index.device import to_device
from pansvr_tpu_torch.ops import seeding as ts

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

SB_FIELDS = ("uid", "read_pos", "uni_pos_off", "length", "pos_n", "valid")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(30)
    contigs = list(random_genome(rng, {f"c{i}": 2500 for i in range(4)}).items())
    # an exact repeat across two contigs: unitigs with pos_n > 1
    rep = contigs[0][1][500:900]
    c1 = contigs[1][1]
    contigs[1] = (contigs[1][0], c1[:1000] + rep + c1[1400:])
    idx = build_index(contigs, first_level_bases=10)
    return idx, jax_to_device(idx), to_device(idx, device="cpu"), contigs


def test_to_device_takes_the_card_unless_asked(world, monkeypatch):
    """to_device defaults to the card and raises without one; the CPU is
    taken only when asked for."""
    idx, _, cpu, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        to_device(idx)
    again = to_device(idx, "cpu")
    assert again.ent_key.device.type == "cpu"
    assert torch.equal(again.ent_key, cpu.ent_key)


def _reads(contigs, rng, n, L=150, err=0.03):
    out = []
    for _ in range(n):
        _, seq = contigs[int(rng.integers(len(contigs)))]
        p = int(rng.integers(0, len(seq) - L))
        codes = dna.encode(seq[p : p + L])
        m = rng.random(L) < err
        codes[m] = (codes[m] + 1) % 4
        out.append(codes)
    return np.stack(out)


def _batch(world, seed, n=40):
    idx, _, _, contigs = world
    rng = np.random.default_rng(seed)
    codes = _reads(contigs, rng, n)
    # unrelated reads: rows without any k-mer hit
    codes[::7] = rng.integers(0, 4, codes[::7].shape).astype(np.uint8)
    L = codes.shape[1]
    lens = np.full(len(codes), L, np.int32)
    lens[::5] = 120
    S0 = (L - idx.search_k) // SEED_STEP + 1
    mask = np.ones((len(codes), S0), bool)
    mask[3, ::3] = False
    return js.pack_reads(codes), lens, mask, S0


def test_index_tensors_match(world):
    _, jd, td, _ = world
    for f in ("uni_posp", "uni_pos", "ref_words", "ent_run", "ent_pack",
              "uni_words_pad"):
        assert np.array_equal(np.asarray(getattr(jd, f)),
                              getattr(td, f).numpy()), f
    for f in ("search_k", "first_level_bases", "n_kmer", "n_uni"):
        assert getattr(jd, f) == getattr(td, f), f
    key = td.ent_key.numpy()
    assert np.array_equal(
        key, (np.asarray(jd.ent_bucket).astype(np.int64) << 32)
        | np.asarray(jd.ent_res).astype(np.int64))
    assert (np.diff(key) >= 0).all()


@pytest.mark.parametrize("probe", ["bisect", "sortjoin"])
@pytest.mark.parametrize("M,nf_mult", [(32, 32), (32, 1), (8, 4)])
def test_seed_reads_flat_matches_jax(world, probe, M, nf_mult):
    _, jd, td, _ = world
    words, lens, mask, S0 = _batch(world, 35)
    j = js.seed_reads_flat(jd, words, lens, mask, S0=S0, M=M,
                           nf_mult=nf_mult, probe=probe)
    t = ts.seed_reads_flat(td, torch.from_numpy(words),
                           torch.from_numpy(lens), torch.from_numpy(mask),
                           S0=S0, M=M, nf_mult=nf_mult)
    jov = np.asarray(j.n_overflow)
    assert np.array_equal(jov, t.n_overflow.numpy())
    # rows cut by the lane pool take the host path: their lanes are
    # undefined in both fronts, every other row is bit-exact
    ok = jov < ts.FLAT_OVERFLOW
    for f in SB_FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert np.array_equal(a[ok], b[ok]), f
    assert np.asarray(j.valid)[ok].any()
    if nf_mult == 32:
        assert ok.all()
    if nf_mult == 1:
        assert (jov >= ts.FLAT_OVERFLOW).any()
    if M == 8:
        assert ((jov > 0) & (jov < ts.FLAT_OVERFLOW)).any()


@pytest.mark.parametrize("R,nf_mult", [(96, 32), (16, 32), (96, 1)],
                         ids=["fits", "over_budget", "flat_overflow"])
def test_seed_reads_flat_compact_matches_jax(world, R, nf_mult):
    """compact_rows=R: the rid row map, BUDGET_OVERFLOW rows past the
    budget and every per-row field equal the JAX front's."""
    _, jd, td, _ = world
    words, lens, mask, S0 = _batch(world, 38, n=80)
    j, j_rid, j_over = js.seed_reads_flat(
        jd, words, lens, mask, S0=S0, M=32, nf_mult=nf_mult,
        probe="sortjoin", compact_rows=R)
    t, t_rid, t_over = ts.seed_reads_flat(
        td, torch.from_numpy(words), torch.from_numpy(lens),
        torch.from_numpy(mask), S0=S0, M=32, nf_mult=nf_mult,
        compact_rows=R)
    rid = np.asarray(j_rid)
    assert np.array_equal(rid, t_rid.numpy())
    assert np.array_equal(np.asarray(j_over), t_over.numpy())
    jov = np.asarray(j.n_overflow)
    assert np.array_equal(jov, t.n_overflow.numpy())
    ok = jov < ts.FLAT_OVERFLOW
    for f in SB_FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert np.array_equal(a[ok], b[ok]), f
    n_act = int((rid < len(words)).sum())
    assert 0 < n_act <= R
    if R == 16:
        assert np.asarray(j_over).any() and n_act == R
    else:
        assert not np.asarray(j_over).any() and (rid[n_act:] == len(words)).all()
    if nf_mult == 1:
        assert (jov >= ts.FLAT_OVERFLOW).any()


def _as_torch_sb(sb):
    return ts.SeedBatch(*(torch.from_numpy(np.array(a)) for a in sb))


@pytest.mark.parametrize("S", [32, 64])
def test_merge_expand_matches_jax(world, S):
    _, jd, td, _ = world
    words, lens, mask, S0 = _batch(world, 36)
    sb = js.seed_reads_flat(jd, words, lens, mask, S0=S0, M=32, nf_mult=32)
    rng = np.random.default_rng(37)
    B2, M = 64, 32
    sb_rand = js.SeedBatch(
        uid=rng.integers(0, 50, (B2, M)).astype(np.int32),
        read_pos=rng.integers(0, 140, (B2, M)).astype(np.int32),
        uni_pos_off=rng.integers(0, 4000, (B2, M)).astype(np.int32),
        length=rng.integers(20, 60, (B2, M)).astype(np.int32),
        pos_n=rng.choice([1, 2, 3, 600, 9000], (B2, M)).astype(np.int32),
        valid=rng.random((B2, M)) < 0.7,
        n_overflow=np.zeros(B2, np.int32),
    )
    for batch in (sb, sb_rand):
        e1 = js.merge_expand_device3(batch, jd, S=S)
        e2 = ts.merge_expand_device3(_as_torch_sb(batch), td, S=S)
        for f in e1._fields:
            assert np.array_equal(np.asarray(getattr(e1, f)),
                                  getattr(e2, f).numpy()), f"S={S} {f}"


def test_front_at_scale_matches_jax():
    """tests/test_parallel.py's production-size world (8,192 rows of
    160) with a flat lane pool of 3 lanes a row: the engine's
    uncompacted front (programs.front_stats) equals the JAX package's
    seed_reads_flat + merge_expand_device3 in every field, and its stats
    rows equal JAX's overflow flags, drop counts and seed counts; the
    pool is small enough that some rows overflow and others do not."""
    from pansvr_tpu_torch.align.programs import front_stats

    rng = np.random.default_rng(81)
    contigs = list(random_genome(
        rng, {f"c{i}": 20_000 for i in range(4)}).items())
    idx = build_index(contigs, first_level_bases=9)
    B, L = 8192, 160
    codes = np.zeros((B, L), np.uint8)
    for b in range(B):
        _, seq = contigs[b % len(contigs)]
        p = int(rng.integers(0, len(seq) - L))
        codes[b] = dna.encode(seq[p : p + L])
    m = rng.random((B, L)) < 0.02
    codes[m] = (codes[m] + 1) % 4
    words, lens = js.pack_reads(codes), np.full(B, L, np.int32)
    S0 = (L - 20) // SEED_STEP + 1
    mask = np.ones((B, S0), bool)
    S, M, n_ext, nf_mult = 32, 32, 9, 3

    es, stats3 = front_stats(
        to_device(idx, "cpu"), *(torch.from_numpy(a) for a in
                                 (words, lens, mask)), S0, S, M, n_ext,
        nf_mult)
    jd = jax_to_device(idx)
    sb = js.seed_reads_flat(jd, words, lens, mask, S0=S0, M=M,
                            n_ext_steps=n_ext, nf_mult=nf_mult)
    j_es = js.merge_expand_device3(sb, jd, S=S)
    for f in j_es._fields:
        assert np.array_equal(getattr(es, f).numpy(),
                              np.asarray(getattr(j_es, f))), f
    want = np.stack([np.asarray(sb.n_overflow), np.asarray(j_es.n_dropped),
                     np.asarray(j_es.valid).sum(1)]).astype(np.int32)
    assert np.array_equal(stats3.numpy(), want)
    assert (want[0] > 0).any(), "the world must reach the lane pool"
    assert (want[0] == 0).any() and want[2].sum() > 0
