"""The genome world and scale_run --world genome on the CPU, at a tiny cut
of the recipe (24 chromosomes of 40 kbp, 48 DEL/INS/DUP SVs, 2,000 read
pairs, error 0.01): the world's files against the JAX package's
functions byte for byte, the device index against the JAX package's
to_device at several first levels, fc_aln's answers across first levels,
and scale_run's fc_aln and fc_sv against the JAX package's. The
reference's first level, 14, allocates a 4^14-entry table (1 GiB) per
process, so here the index runs at levels up to 12; chip_smoke.py holds
level 14 on the card."""

import os
import shutil
import subprocess
import sys
import tracemalloc
from collections import defaultdict

import numpy as np
import pytest
import torch

from index_worlds import synthetic_index
from pansvr_tpu_torch import scale_run, world

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = dict(n_sv=48, chrom_lengths={f"chr{i}": 40_000
                                      for i in range(1, 25)})
PAIRS = 2000
LEVEL = 10          # the tiny world's fixed first level (its auto: 8)
WORLD_FILES = ("svs.vcf", "genome.fa", "header.sam", "sim.bam")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    p = world.build_genome_world(str(d / "port"), n_pairs=PAIRS, workers=2,
                                 first_level=LEVEL, **RECIPE)
    return d, p


@pytest.fixture(scope="module")
def scaled(tmp_path_factory):
    """scale_run --world genome on the CPU over the tiny world's GEN
    outputs: every stage after gen, each in its own process, the fc_sv
    fan-out over 4 workers. Returns (dir, exit code, report)."""
    import json

    out = tmp_path_factory.mktemp("genome_scale")
    world.gen_genome_world(str(out), PAIRS, 2, **RECIPE)
    rc = scale_run.main([
        "--out", str(out), "--world", "genome", "--pairs", str(PAIRS),
        "--svs", str(RECIPE["n_sv"]), "--first-level", str(LEVEL),
        "--sv-shards", "4", "--device", "cpu",
        "--stages", ",".join(scale_run.STAGES[1:])])
    with open(out / "report.json") as fh:
        return out, rc, json.load(fh)


def test_genome_world_matches_jax_recipe(genome):
    """gen_genome_world writes the bytes of the JAX package's make_dataset
    and writers for the same recipe (seed 2024, DEL/INS/DUP, error 0.01)."""
    from pansvr_tpu.io.fasta import write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam

    d, p = genome
    j = d / "jax"
    j.mkdir()
    ds = make_dataset(seed=2024, n_sv=48, n_pairs=PAIRS,
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

    assert len(ds.svs) == 48 and {s.sv_type for s in ds.svs} == {
        "DEL", "INS", "DUP"}
    assert len({s.chrom for s in ds.svs}) > 16
    port_dir = os.path.dirname(p["vcf"])
    for f in WORLD_FILES:
        assert _bytes(j / f) == _bytes(os.path.join(port_dir, f)), f
    assert p["first_level"] == LEVEL and p["n_kmers"] > 40_000


@pytest.mark.parametrize("recipe", [
    dict(seed=2024, n_sv=48, types=("DEL", "INS", "DUP"),
         chrom_lengths=RECIPE["chrom_lengths"]),
    dict(seed=3, n_sv=300, types=("DEL", "INS", "DUP", "INV"),
         chrom_lengths={f"chr{i}": 400_000 for i in range(1, 5)})],
    ids=["genome_cut", "dense_inv"])
def test_sim_bam_records_fast_matches_copy(recipe):
    """The bisecting mapper gives the header and the encoded records of
    utils.simulate.sim_bam_records, alt reads across every breakpoint
    kind (inversions too) included."""
    from pansvr_tpu_torch.io.bam import _encode_record
    from pansvr_tpu_torch.utils.simulate import make_dataset, sim_bam_records

    ds = make_dataset(n_pairs=3000, err_rate=0.01, **recipe)
    h0, r0 = sim_bam_records(ds)
    h1, r1 = world.sim_bam_records_fast(ds)
    assert h1.ref_names == h0.ref_names and h1.ref_lens == h0.ref_lens
    assert len(r1) == len(r0) == 6000
    assert [_encode_record(r) for r in r1] == [_encode_record(r) for r in r0]
    # alt reads clipped at breakpoints and unmapped (inside insertions)
    assert sum(any(op == "S" for op, _ in r.cigar) for r in r0) > 100
    assert any(not r.cigar for r in r0)


def _jax_device_arrays(j):
    key = (np.asarray(j.ent_bucket).astype(np.int64) << 32) \
        | np.asarray(j.ent_res).astype(np.int64)
    return dict(ent_pack=np.asarray(j.ent_pack), ent_key=key, **{
        f: np.asarray(getattr(j, f)) for f in (
            "uni_posp", "uni_pos", "ref_words", "ent_run", "uni_words_pad")})


def _assert_device_equal(idx, d=None):
    """The port's tables `d` (default: to_device(idx, "cpu")) equal the
    JAX package's to_device(idx), values, dtypes and padded sizes."""
    from pansvr_tpu.index.device import to_device as jax_to_device
    from pansvr_tpu_torch.index.device import to_device

    d = d or to_device(idx, "cpu")
    j = jax_to_device(idx)
    assert d.n_kmer == j.n_kmer and d.n_uni == j.n_uni
    assert d.first_level_bases == idx.first_level_bases
    for f, want in _jax_device_arrays(j).items():
        got = getattr(d, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("level", [8, 10, 12])
def test_to_device_matches_jax_at_first_level(genome, level):
    """The port's to_device (bucket_of by bisection) gives the JAX
    package's arrays at first levels 8, 10 and 12 over the same anchors
    (tables with empty buckets)."""
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.io.fasta import read_fasta

    _, p = genome
    idx = build_index(list(read_fasta(p["anchors"]).items()),
                      first_level_bases=level)
    sizes = np.diff(idx.hash_g)
    assert len(sizes) == 4 ** level and (sizes == 0).sum() > 1000
    _assert_device_equal(idx)


@pytest.mark.parametrize("n_k", [56_000, 2_000_000])
def test_to_device_matches_jax_on_synthetic_buckets(n_k):
    """Synthetic tables at first level 12 with runs of empty buckets, the
    first and the last included: the port's to_device gives the JAX
    package's arrays, and its host allocations stay within the tensors
    it returns plus 32 bytes an entry and 32 MB (the JAX package's
    bucket-start expansion alone takes 20 bytes a bucket of the 4^12
    table, its int64 per-entry columns ~180 bytes an entry)."""
    from pansvr_tpu_torch.index.device import to_device

    idx = synthetic_index(n_k)
    sizes = np.diff(idx.hash_g)
    assert sizes[:5000].sum() == 0 and sizes[-7000:].sum() == 0
    assert idx.hash_g[-1] == n_k
    tracemalloc.start()
    d = to_device(idx, "cpu")
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    out = sum(t.numel() * t.element_size() for t in (
        d.ent_pack, d.ent_key, d.ent_run, d.uni_posp, d.uni_pos,
        d.ref_words, d.uni_words_pad))
    assert peak < out + 32 * n_k + (32 << 20), (peak, out)
    _assert_device_equal(idx)


def _store(idx, path):
    """`idx` saved as an index store and reopened memory-mapped."""
    from pansvr_tpu_torch.index.store import load_index, save_index

    save_index(idx, str(path))
    m = load_index(str(path))
    assert isinstance(m.hash_g, np.memmap)
    return m


@pytest.mark.parametrize("level", [10, 12])
def test_to_device_from_store_matches_jax(tmp_path, monkeypatch, level):
    """The tables derived from a memory-mapped index store, read through
    staging buffers of 5,000 bytes (reads and copies cross buffers and
    elements), equal the JAX package's to_device over the same index
    held in memory, at first levels with runs of empty buckets at both
    ends; index_read_bytes counts the source arrays' bytes, and the host
    makes no NumPy allocation of the tables' size."""
    from pansvr_tpu_torch.index import device
    from pansvr_tpu_torch.utils.trace import Spans

    idx = synthetic_index(56_000, level=level)
    sizes = np.diff(idx.hash_g)
    assert sizes[:5000].sum() == 0 and sizes[-7000:].sum() == 0
    m = _store(idx, tmp_path)
    monkeypatch.setattr(device, "STAGE_BYTES", 5000)
    prof = defaultdict(float)
    tracemalloc.start()
    d = device.to_device(m, "cpu", Spans(prof))
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 1 << 20, peak
    assert prof["index_read_bytes"] == sum(
        getattr(idx, f).nbytes for f in device.SOURCES)
    assert prof["index_read_s"] > 0 and prof["index_derive_s"] > 0
    _assert_device_equal(idx, d)


def _mapped_rss_kib(names):
    """{name: Rss kB} of this process's mappings of <name>.npy files."""
    from pansvr_tpu_torch.utils.memory import mappings

    out = {}
    with open("/proc/self/smaps") as fh:
        for path, kib in mappings(fh.read()):
            base = os.path.basename(path)
            if base.endswith(".npy") and base[:-4] in names:
                out[base[:-4]] = out.get(base[:-4], 0) + kib
    return out


def test_to_device_leaves_store_mappings_out_of_rss(tmp_path):
    """to_device reads the store's files, not its mappings: afterwards
    none of the source arrays' mappings has a resident page (the 4^12
    first-level table is 64 MiB), where one read through the mapping
    makes hash_g's resident."""
    from pansvr_tpu_torch.index import device

    m = _store(synthetic_index(56_000), tmp_path)
    device.to_device(m, "cpu")
    rss = _mapped_rss_kib(device.SOURCES)
    assert set(rss) == set(device.SOURCES), rss
    assert all(v == 0 for v in rss.values()), rss
    assert int(np.asarray(m.hash_g).max()) == 56_000
    assert _mapped_rss_kib({"hash_g"})["hash_g"] > 60_000


def test_fc_aln_same_records_at_two_first_levels(genome, tmp_path):
    """fc_aln --device cpu over the same anchors indexed at first levels
    10 and 12 writes identical BAM records: the level changes the
    probe's table, not its answers."""
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_aln
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.index.store import save_index
    from pansvr_tpu_torch.io.fasta import read_fasta

    _, p = genome
    contigs = list(read_fasta(p["anchors"]).items())
    recs = []
    for level in (10, 12):
        d = str(tmp_path / f"rdbg{level}")
        save_index(build_index(contigs, first_level_bases=level), d)
        bam = str(tmp_path / f"fl{level}.bam")
        run_fc_aln(parse_args(["fc_aln", d, p["signal"], p["header"], "-o",
                               bam, "-r", p["status"], "-b", "1024",
                               "--device", "cpu"]))
        recs.append(world.bam_records(bam))
    assert len(recs[0]) > 300 and recs[0] == recs[1]


def test_scale_run_genome_on_cpu(scaled):
    """Every stage after gen ends with rc 0; the index is at the run's
    first level; the fan-out ran over several workers; parity (a), (b),
    (e) and compare (c) hold; the fan-out's VCF equals the VCF of one
    unsharded fc_sv over every region."""
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_sv

    out, rc, rep = scaled
    assert rc == 0
    assert rep["world_name"] == "genome" and rep["world"]["n_sv"] == 48
    assert rep["first_level"] == LEVEL and rep["sv_shards"] == 4
    for stage in scale_run.STAGES[1:-1]:
        assert rep["stages"][stage]["rc"] == 0, stage
    ix = rep["stages"]["index"]
    assert ix["first_level"] == LEVEL and ix["n_kmers"] > 40_000
    aln = rep["stages"]["aln"]
    assert aln["index"]["first_level"] == LEVEL
    by = aln["device_index_bytes_by_tensor"]
    assert set(by) >= {"ent_key", "ent_pack", "ent_run"}
    assert sum(by.values()) == aln["device_index_bytes"] \
        == aln["to_device"]["bytes"]
    assert by["ent_key"] == 8 * aln["index"]["n_kmer_padded"]
    assert aln["to_device"]["seconds"] > 0 and aln["prof"]["index_upload"] > 0
    assert aln["stream_reads_per_s"] > aln["reads_per_s"]
    assert set(aln["front_share"]) == {"host_submit", "sync_chain"}
    assert 0 <= aln["fallback_share"] <= scale_run.MAX_FALLBACK
    sv = rep["stages"]["sv"]
    assert sv["regions"] == 48 and sv["fanout"]["workers"] == 4
    assert sv["n_pass"] > 0 and sv["shard_regions"] < 48
    assert rep["stages"]["sv_inline"]["shard"] == sv["shard"]
    par = rep["stages"]["parity"]
    assert par["a_records"] > 0 and par["b_reads_with_alignments"] > 0
    assert par["e"]["levels"] == [LEVEL, 8]
    assert par["e"]["records"] == par["a_records"]
    cmp = rep["compare"]
    assert cmp["c_inline_identical"] and cmp["c_fanout_identical"]
    assert cmp["records"] == sv["n_pass"] and cmp["f1_all"]["truth"] == 48
    assert cmp["f1_shard"]["card"]["truth"] == sv["shard_regions"]

    single = str(out / "single.vcf")
    run_fc_sv(parse_args(["fc_sv", str(out / "anchors.fa"),
                          str(out / "aln.sorted.bam"), str(out / "genome.fa"),
                          "-o", single, "-r", str(out / "status.sam"),
                          "--device", "cpu"]))
    assert _bytes(out / "result.vcf") == _bytes(single)


def test_scale_run_genome_aln_ops_and_cards(scaled):
    """The genome world's aln_ops and aln_cards on the CPU: the op-by-op
    pass and the fan-out over two workers give aln.bam's records
    (test_torch_scale.check_aln_ops_and_cards)."""
    from test_torch_scale import check_aln_ops_and_cards

    out, rc, rep = scaled
    assert rc == 0
    assert rep["stages"]["aln_ops"]["index"]["first_level"] == LEVEL
    check_aln_ops_and_cards(rep, out)


def test_scale_run_genome_matches_jax(scaled):
    """The JAX package's fc_aln (the CLI, JAX on the CPU) on the same
    index writes scale_run's BAM records, and its fc_sv over the inline
    shard's -S/-E, handed to compare as result_jax.vcf, gives (d)."""
    import json

    out, _, rep = scaled
    idx = out / "jax_rdbg"
    shutil.copytree(out / "rdbg", idx,
                    ignore=shutil.ignore_patterns("engine_tune.json*"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pansvr_tpu", "fc_aln", "-o",
         str(out / "jax_aln.bam"), "-b", str(scale_run.BATCH), "-r",
         str(out / "status.sam"), str(idx), str(out / "signal.fq"),
         str(out / "header.sam")], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    got = world.bam_records(str(out / "aln.bam"))
    assert got and got == world.bam_records(str(out / "jax_aln.bam"))

    lo, hi = rep["stages"]["sv"]["shard"]
    r = subprocess.run(
        [sys.executable, "-m", "pansvr_tpu", "fc_sv", str(out / "anchors.fa"),
         str(out / "aln.sorted.bam"), str(out / "genome.fa"), "-o",
         str(out / "result_jax.vcf"), "-r", str(out / "status.sam"),
         "-S", str(lo), "-E", str(hi)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    try:
        assert scale_run.main(["--out", str(out), "--world", "genome",
                               "--device", "cpu", "--stages",
                               "compare"]) == 0
        with open(out / "report.json") as fh:
            cmp = json.load(fh)["compare"]
        assert cmp["d_jax_identical"]
        assert cmp["f1_shard"]["jax"] == cmp["f1_shard"]["card"]
    finally:
        os.remove(out / "result_jax.vcf")
