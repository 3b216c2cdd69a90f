"""The benchmark's generator: seeded, and statistically the port's own
recipe (world.build_chrom_world, then fc_signal -U -D)."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, tiny_config
from portbench import check, feed, gen


def _mix(name):
    with open(os.path.join(BENCH, "mixes", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("mix", ["regions", "offtarget90"])
def test_same_seed_same_bytes_other_seed_other_reads(tiny_db, mix):
    path, _ = tiny_db
    db_dir = os.path.join(path, "cache", "tiny")
    cfg = tiny_config()
    a = feed.make_pool(db_dir, cfg, _mix(mix), 2 ** 31 + 11, 4000, workers=2)
    b = feed.make_pool(db_dir, cfg, _mix(mix), 2 ** 31 + 11, 4000, workers=2)
    c = feed.make_pool(db_dir, cfg, _mix(mix), 2 ** 31 + 12, 4000, workers=2)
    assert a[0] == b[0] and (a[1] == b[1]).all()
    seqs = lambda pool: {r[1] for r in gen.parse_fastq(pool.decode())}
    assert len(seqs(a[0]) & seqs(c[0])) < 0.01 * len(seqs(a[0]))
    # every pair parses back into two records of one name, with the
    # comment fields fc_aln reads
    n = len(a[1]) - 1
    for i in (0, n // 2, n - 1):
        (n1, s1, q1, c1), (n2, s2, q2, c2) = check.parse_pair(
            feed.pair_text(a[0], a[1], i))
        assert n1 == n2 and len(s1) == len(q1) == 150 == len(s2)
        check.parse_ori(c1), check.parse_ori(c2)
    # a later cycle renames the pair, nothing else
    t0, t1 = feed.pair_text(a[0], a[1], 0), feed.pair_text(a[0], a[1], n)
    assert t1 == t0.replace("c0 ", "c1 ") and t1 != t0


def _signal_stats(comments, n_pairs):
    cig = [c.split("_CIGAR_")[1].split("_")[0] for c in comments]
    return (len(comments) / n_pairs, sum("S" in x for x in cig) / len(cig),
            sum(x == "" for x in cig) / len(cig))


def test_regions_sample_matches_the_port_world(tmp_path):
    """200 DEL/INS/DUP SVs on 3.5 Mbp and 40,000 pairs, through the
    port's world builder and fc_signal -U -D, against the generator's
    regions sample of the same recipe. Tolerances: signal reads per
    pair within 6% and the clipped and unmapped shares within 0.03. The
    two come from different SV placements and draws (200 SVs: the share
    of each SV type, which sets how many alt reads clip or fall inside
    an insertion, moves by about 1/sqrt(200 / 3) ~ 12% of itself), a
    region's pairs are Poisson here and multinomial there, and the
    insert-size quantiles of the keep rule come from Manta's region
    sampling there and from the first chunk's pairs here (seeds 11 and
    12 read 0.617 / 0.616 against 0.629 / 0.631 signal reads a pair)."""
    from pansvr_tpu_torch import world

    lens = {"chr1": 2_000_000, "chr2": 1_500_000}
    p = world.build_chrom_world(str(tmp_path / "w"), n_pairs=40_000,
                                workers=1, seed=11, n_sv=200,
                                chrom_lengths=lens)
    with open(p["signal"]) as fh:
        port = _signal_stats([line.split(" ", 1)[1] for i, line in
                              enumerate(fh) if i % 4 == 0], 40_000)
    cfg = tiny_config(n_sv=200, seed=11, chrom_lengths=lens)
    cfg["sample"]["pairs"] = 40_000
    smp = gen.Sampler(gen.make_database(cfg), cfg, _mix("regions"), 11)
    recs = gen.parse_fastq(b"".join(smp.fastq(smp.chunk(k), k)[0] for k in
                                    range(len(smp.chunks))).decode())
    mine = _signal_stats([r[3] for r in recs], 40_000)
    assert mine[0] == pytest.approx(port[0], rel=0.06)
    assert mine[1] == pytest.approx(port[1], abs=0.03)
    assert mine[2] == pytest.approx(port[2], abs=0.03)


def test_offtarget_share_and_clips(tiny_db):
    path, _ = tiny_db
    db = feed.dbmod.load(os.path.join(path, "cache", "tiny"))
    mix = _mix("offtarget90")
    smp = gen.Sampler(db, tiny_config(), mix, 5)
    prs = [smp.chunk(k) for k in range(len(smp.chunks))]
    n = sum(len(p.tid) for p in prs)
    off = sum(int(((p.clip_l + p.clip_r) >= mix["off_target_clip"][0]).any(1)
                  .sum()) for p in prs)
    # off-target pairs (one mate clipped 20-60 bp) are 90% of the pairs,
    # on-target ones clip too at a breakpoint: at least 90%, not 100%
    assert 0.89 <= off / n < 0.99
    for p in prs:
        assert (p.key[1:] >= p.key[:-1]).all()      # position order


def test_warmup_is_cut_from_all_over_the_pool():
    offs = np.arange(0, 1001 * 10, 10)          # 1,000 pairs of 10 bytes
    pieces = feed.warmup_pieces(offs, 4, 100)   # 4 batches of 50 pairs
    assert pieces == [(0, 500), (2500, 3000), (5000, 5500), (7500, 8000)]
    # a pool of fewer pairs than the warm-up: the pieces wrap round
    pieces = feed.warmup_pieces(offs[:61], 2, 100)
    assert pieces == [(0, 500), (300, 600), (0, 200)]
