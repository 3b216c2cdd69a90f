"""The chromosome-scale world and scale_run on the CPU, at a tiny size of
the same recipe (two chromosomes, DEL/INS/DUP, error 0.01, auto first
level): the world's files against the JAX package's functions byte for
byte, and the port's fc_aln and fc_sv of scale_run against the JAX
package's on that world."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from pansvr_tpu_torch import scale_run, world

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the chromosome recipe cut to a test's size: 12 SVs on 150 + 100 kbp
RECIPE = dict(n_sv=12, chrom_lengths={"chr1": 150_000, "chr2": 100_000})
PAIRS = 3000
WORLD_FILES = ("svs.vcf", "genome.fa", "header.sam", "sim.bam", "anchors.fa",
               "signal.fq", "status.sam")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _index_files(d):
    return sorted(f for f in os.listdir(d) if f != "engine_tune.json")


@pytest.fixture(scope="module")
def chrom(tmp_path_factory):
    d = tmp_path_factory.mktemp("chrom")
    p = world.build_chrom_world(str(d / "port"), n_pairs=PAIRS, workers=2,
                                **RECIPE)
    return d, p


@pytest.fixture(scope="module")
def scaled(chrom):
    """scale_run on the CPU over a tiny world's GEN outputs: every stage
    after gen, each in its own process. Returns (dir, exit code,
    report)."""
    import json

    d, _ = chrom
    out = d / "scale"
    world.gen_chrom_world(str(out), PAIRS, 2, **RECIPE)
    rc = scale_run.main(["--out", str(out), "--pairs", str(PAIRS),
                         "--device", "cpu", "--stages",
                         ",".join(scale_run.STAGES[1:])])
    with open(out / "report.json") as fh:
        return out, rc, json.load(fh)


def test_chrom_world_matches_jax_recipe(chrom):
    """build_chrom_world writes the files tools/chrom_scale_run.py's
    recipe writes through the JAX package's functions, byte for byte
    (sim.bam from two record workers)."""
    from pansvr_tpu.anchor.builder import run_anchor_ref
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.index.store import save_index
    from pansvr_tpu.io.fasta import Faidx, read_fasta, write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.signal.extract import SignalOptions, extract_signal
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    d, p = chrom
    j = d / "jax"
    j.mkdir()
    ds = make_dataset(seed=99, n_sv=12, n_pairs=PAIRS,
                      types=("DEL", "INS", "DUP"),
                      chrom_lengths=RECIPE["chrom_lengths"], err_rate=0.01)
    write_fasta(str(j / "genome.fa"), ds.genome.items(), width=60)
    w = VCFWriter(str(j / "svs.vcf"),
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    with open(j / "header.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    write_sim_bam(ds, str(j / "sim.bam"))
    with open(j / "anchors.fa", "w") as fh:
        run_anchor_ref(str(j / "svs.vcf"), Faidx(str(j / "genome.fa")), fh)
    idx = build_index(list(read_fasta(str(j / "anchors.fa")).items()),
                      first_level_bases="auto")
    save_index(idx, str(j / "rdbg"))
    with open(j / "signal.fq", "w") as fh:
        stats = extract_signal(str(j / "sim.bam"), fh, opts=SignalOptions(
            discard_both_full_match=True, not_using_filter=True))
    with open(j / "status.sam", "w") as fh:
        fh.write(stats.status_file_text())

    assert {s.sv_type for s in ds.svs} == {"DEL", "INS", "DUP"}
    assert {s.chrom for s in ds.svs} == {"chr1", "chr2"}
    port_dir = os.path.dirname(p["vcf"])
    for f in WORLD_FILES:
        assert _bytes(j / f) == _bytes(os.path.join(port_dir, f)), f
    names = _index_files(j / "rdbg")
    assert names == _index_files(p["index"]) and "manifest.json" in names
    for f in names:
        assert _bytes(j / "rdbg" / f) == _bytes(os.path.join(p["index"], f)), f
    assert p["first_level"] == idx.first_level_bases
    assert p["n_kmers"] == idx.n_kmers > 0


def test_chrom_index_at_full_recipe_matches_jax(tmp_path):
    """The whole recipe's state (100 Mbp, 2,000 SVs; no reads): anchors
    and index store byte-identical to the JAX package's functions, and
    the device index (~2.3M k-mers, padded to 2^22 entries) equal to the
    JAX package's to_device, the int32 casts and the packed clips
    included. No entry reaches the off_r clip (2047) or the pos_n clip
    (2^21 - 1) at this population."""
    import numpy as np

    from pansvr_tpu.anchor.builder import run_anchor_ref
    from pansvr_tpu.index.builder import build_index
    from pansvr_tpu.index.device import to_device as jax_to_device
    from pansvr_tpu.io.fasta import Faidx, read_fasta
    from pansvr_tpu_torch.index.device import to_device

    p = world.gen_chrom_world(str(tmp_path / "w"), 0, 1)
    world.anchor_chrom_world(p)
    idx = world.index_chrom_world(p)
    with open(tmp_path / "anchors.fa", "w") as fh:
        run_anchor_ref(p["vcf"], Faidx(p["genome"]), fh)
    assert _bytes(tmp_path / "anchors.fa") == _bytes(p["anchors"])
    jidx = build_index(list(read_fasta(p["anchors"]).items()),
                       first_level_bases="auto")
    assert idx.first_level_bases == jidx.first_level_bases
    for f in ("hash_g", "kmer_g", "off_g", "uni_seqf", "uni_posp", "uni_pos",
              "uni_codes", "ref_codes"):
        assert np.array_equal(getattr(idx, f), getattr(jidx, f)), f
    assert idx.n_kmers > 2_000_000 and idx.n_unitigs > 3000

    d, j = to_device(idx, "cpu"), jax_to_device(jidx)
    assert d.n_kmer == j.n_kmer == 1 << 22 and d.n_uni == j.n_uni
    assert np.array_equal(d.ent_pack.numpy(), np.asarray(j.ent_pack))
    key = (np.asarray(j.ent_bucket).astype(np.int64) << 32) \
        | np.asarray(j.ent_res).astype(np.int64)
    assert np.array_equal(d.ent_key.numpy(), key)
    for f in ("uni_posp", "uni_pos", "ref_words", "ent_run", "uni_words_pad"):
        assert np.array_equal(getattr(d, f).numpy(),
                              np.asarray(getattr(j, f))), f
    off_r = np.asarray(j.ent_off_r)[: idx.n_kmers]
    pos_n = np.asarray(j.ent_pos_n)[: idx.n_kmers]
    assert off_r.max() < 2047 and pos_n.max() < (1 << 21) - 1


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_write_sim_bam_parallel_matches_write_sim_bam(tmp_path, workers):
    """The records made by `workers` processes and merged by position
    give write_sim_bam's bytes, with (tid, pos) ties across the slices."""
    from pansvr_tpu_torch.io.bam import BamReader
    from pansvr_tpu_torch.utils.simulate import make_dataset, write_sim_bam

    ds = make_dataset(seed=5, n_sv=6, n_pairs=4200,
                      types=("DEL", "INS", "DUP"),
                      chrom_lengths={"chr1": 60_000, "chr2": 40_000},
                      err_rate=0.01)
    write_sim_bam(ds, str(tmp_path / "serial.bam"))
    world.write_sim_bam_parallel(ds, str(tmp_path / "par.bam"), workers)
    assert _bytes(tmp_path / "par.bam") == _bytes(tmp_path / "serial.bam")
    assert not [f for f in os.listdir(tmp_path) if ".part" in f]
    # the slices share positions, so the merge's tie order is exercised
    with BamReader(str(tmp_path / "serial.bam")) as rd:
        keys = [(r.tid, r.pos) for r in rd]
    assert len(keys) - len(set(keys)) > 100


def test_scale_run_stages_on_cpu(chrom, scaled):
    """Every stage ends with rc 0 and its line in the report; the
    anchor, index and signal subcommands write build_chrom_world's
    bytes; fc_aln's line holds the engine's counters, the fallback share,
    the device index's bytes and the tuning file; parity (a) and (b) and
    compare (c) hold."""
    _, p = chrom
    out, rc, rep = scaled
    assert rc == 0
    assert rep["device"] == "cpu" and rep["pairs"] == PAIRS
    for stage in scale_run.STAGES[1:-1]:
        line = rep["stages"][stage]
        assert line["rc"] == 0 and line["wall_s"] > 0, stage
        assert line["peak_rss_gib"] > 0, stage
    for f in ("anchors.fa", "signal.fq", "status.sam"):
        assert _bytes(out / f) == _bytes(os.path.join(
            os.path.dirname(p["vcf"]), f)), f
    names = _index_files(p["index"])
    assert _index_files(out / "rdbg") == names
    for f in names:
        assert _bytes(out / "rdbg" / f) == _bytes(os.path.join(p["index"], f))
    aln = rep["stages"]["aln"]
    assert aln["reads"] == rep["signal_reads"] // 2 * 2 > 1000
    assert aln["reads_per_s"] > 0 and aln["pass_s"] > 0
    for k in ("n_widen", "n_retry", "n_fallback", "n_budget_fallback",
              "n_hit_reads", "host_submit", "dp_dispatch"):
        assert k in aln["prof"], k
    assert aln["prof"]["n_hit_reads"] > aln["reads"] // 2   # on target
    assert 0 <= aln["fallback_share"] <= scale_run.MAX_FALLBACK
    assert aln["device_index_bytes"] > 0 and aln["gpu_peak_mib"] is None
    assert aln["kernels"] == [] and aln["launches"]["extd2_fwd"] == 0
    assert set(aln["engine_tune"]) >= {"nf_mult", "mem_slots", "k_spec"}
    rss = aln["rss_steps"]
    assert rss["end"]["VmRSS"] > rss["start"]["VmRSS"] > 0
    sv = rep["stages"]["sv"]
    assert sv["regions"] == 12 and sv["n_pass"] > 0
    assert sv["dp"]["n_requests"] > 0 and sv["dp"]["chunks"]
    assert rep["stages"]["sv_inline"]["n_pass"] == sv["n_pass"]
    par = rep["stages"]["parity"]
    assert par["a_reads"] == min(scale_run.N_BAM_PARITY, aln["reads"])
    assert par["a_records"] > 0
    assert len(par["a_runs"]) == len(scale_run.CONFIGS) + 1 == 4
    assert par["b_reads"] == scale_run.N_HOST_PARITY
    assert par["b_reads_with_alignments"] > 0
    cmp = rep["compare"]
    assert cmp["c_inline_identical"] and "d_jax_identical" not in cmp
    assert cmp["records"] == 12 and cmp["f1_all"]["truth"] == 12
    assert 0.5 < cmp["f1_all"]["f1"] <= 1.0


def check_aln_ops_and_cards(rep, out):
    """aln_ops and aln_cards of a scale_run report on the CPU: the op-by-op
    pass keys the shape sets of aln's (both op by op on the CPU, from the
    default budgets), compare (f) held its records to aln.bam's, and the
    fan-out's and the mesh's records equal aln.bam's."""
    aln, ops = rep["stages"]["aln"], rep["stages"]["aln_ops"]
    assert aln["config"] == scale_run.CONFIGS[0][0] and aln["fuse_chain"]
    assert ops["config"] == scale_run.OPS_CONFIG[0] and not ops["fuse_chain"]
    assert ops["rc"] == 0 and ops["reads"] == aln["reads"]
    assert "to_device" in aln and "to_device" not in ops
    for line in (aln, ops):
        g = line["graphs"]
        assert set(scale_run.GRAPH_COUNTERS) <= set(g)
        # the CPU keys its shape sets and captures nothing
        assert g["n_front_shape_sets"] >= 1 and g["n_dp_shape_sets"] >= 1
        assert g["n_graph_capture"] == g["n_graph_evict"] == 0
        assert len(g["shape_set_keys"]["front"]) == g["n_front_shape_sets"]
        assert line["gpu_reserved_mib"] is None
    assert aln["graphs"]["shape_set_keys"] == ops["graphs"]["shape_set_keys"]
    n = world.bam_records(str(out / "aln.bam"))
    assert n and n == world.bam_records(str(out / "aln_ops.bam"))
    assert rep["compare"]["f_ops_identical"]
    assert rep["compare"]["f_records"] == len(n)
    cards = rep["stages"]["aln_cards"]
    assert cards["rc"] == 0 and cards["cards"] == 2
    assert not cards["share_card"] and cards["measures"] == "2 cpu entries"
    assert cards["reads"] == aln["reads"]
    fan, mesh = cards["fanout"], cards["mesh"]
    assert fan["workers"] == 2 and fan["records"] == len(n)
    assert min(fan[k] for k in ("split_s", "workers_s", "merge_s")) > 0
    assert mesh["entries"] == ["cpu", "cpu"] and mesh["records"] == len(n)
    assert mesh["prof"]["n_reads"] == aln["reads"]
    assert mesh["graphs"]["n_front_shape_sets"] >= 2   # one key an entry
    for f in ("aln_fanout.bam", "aln_mesh.bam"):
        assert world.bam_records(str(out / f)) == n


def test_scale_run_aln_ops_and_cards_on_cpu(scaled):
    out, rc, rep = scaled
    assert rc == 0
    check_aln_ops_and_cards(rep, out)


def test_aln_cards_mesh_and_pins(monkeypatch):
    """--cards N on cards: N distinct cards, the fan-out's workers pinned
    by CUDA_VISIBLE_DEVICES={shard}; with fewer visible it raises (where
    make_data_mesh would return the cards there are); --share-card puts
    every entry and worker on the first card."""
    from argparse import Namespace

    from pansvr_tpu_torch.parallel.mesh import make_data_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = [torch.device("cuda", i) for i in range(4)]
    for have in (1, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
        a = Namespace(cards=2, device="cuda", share_card=False)
        if have == 1:
            assert make_data_mesh(2) == cuda[:1]     # quietly short
            with pytest.raises(RuntimeError, match="2 cards.*1 visible"):
                scale_run.card_mesh(a)
        else:
            assert scale_run.card_mesh(a) == (
                cuda[:2], {"CUDA_VISIBLE_DEVICES": "{shard}"}, "2 cards")
        a.share_card = True
        mesh, env, what = scale_run.card_mesh(a)
        assert mesh == [cuda[0]] * 2 and env is None
        assert what.startswith("host overlap")
    a = Namespace(cards=3, device="cpu", share_card=False)
    assert scale_run.card_mesh(a) == ([torch.device("cpu")] * 3, None,
                                      "3 cpu entries")


def test_fc_aln_of_scale_run_matches_jax(scaled):
    """The JAX package's fc_aln on the same world and index (the CLI,
    JAX on the CPU, -b 8192) writes scale_run's BAM records."""
    out, _, _ = scaled
    idx = out / "jax_rdbg"
    shutil.copytree(out / "rdbg", idx,
                    ignore=shutil.ignore_patterns("engine_tune.json*"))
    bam = out / "jax_aln.bam"
    r = subprocess.run(
        [sys.executable, "-m", "pansvr_tpu", "fc_aln", "-o", str(bam),
         "-b", str(scale_run.BATCH), "-r", str(out / "status.sam"),
         str(idx), str(out / "signal.fq"), str(out / "header.sam")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    got = world.bam_records(str(out / "aln.bam"))
    assert got and got == world.bam_records(str(bam))


def test_fc_sv_of_scale_run_matches_jax(scaled):
    """The JAX package's fc_sv (host DP) over scale_run's sorted BAM gives
    result.vcf's records; compare's (d) holds with that VCF as
    result_jax.vcf and fails on one with a record left out."""
    from pansvr_tpu.assembly.sv_call import (
        SVRefSequence, SvCallOptions, run_sv_calling)
    from pansvr_tpu.io.fasta import Faidx, read_fasta
    from pansvr_tpu.signal.extract import SignalStats

    out, _, _ = scaled
    anchors = read_fasta(str(out / "anchors.fa"))
    sf = SVRefSequence(list(anchors), anchors, Faidx(str(out / "genome.fa")),
                       world.header_names(str(out / "header.sam")))
    stats = SignalStats.parse_status_text(open(out / "status.sam").read())
    _, recs = run_sv_calling(str(out / "aln.sorted.bam"), sf, SvCallOptions(
        normal_read_len=stats.read_len or 150,
        ave_read_depth=max(stats.ave_read_depth, 1.0)))
    lines = [r.to_line() for r in recs]
    assert lines and lines == world.vcf_body(str(out / "result.vcf"))
    for keep, want_rc in ((lines, 0), (lines[1:], 1)):
        with open(out / "result_jax.vcf", "w") as fh:
            fh.write("##fileformat=VCFv4.2\n")
            fh.writelines(line + "\n" for line in keep)
        rc = scale_run.main(["--out", str(out), "--device", "cpu",
                             "--stages", "compare"])
        assert rc == want_rc
    os.remove(out / "result_jax.vcf")
