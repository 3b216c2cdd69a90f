"""The fc_aln benchmark world, materialized on disk, and reading it back.

Same recipe and parameters as bench.py's build_bench_world (seed 123,
64 DEL/INS SVs on a 2 Mbp chr1, 250,000 read pairs at error rate 0.02,
first-level 12 index, signal FASTQ extracted as the reference's
fc_signal -D -U does: about 379k signal reads), built by the port's
copies of the same host functions (anchor, index, signal, simulate). The
index is written as a store directory (the fc_aln INDEX_DIR positional).

The chromosome-scale world (build_chrom_world) is the stand-in for a
deployment: tools/chrom_scale_run.py's recipe (seed 99, 2,000
DEL/INS/DUP SVs on chr1 60 Mbp + chr2 40 Mbp, 5,000,000 read pairs at
error rate 0.01, index at the auto first level), about 100% of its
signal reads on target.

Two derived worlds drive the engine's adaptive paths:
  build_overflow_world  every read on target (a window of an anchor
                        contig): ~27 k-mer hits per read overflow the
                        default flat-lane pool, so the engine widens its
                        budgets and retries the batch;
  build_uniform_world   reads drawn uniformly over the genome: almost no
                        row hits an anchor k-mer, so the active-row
                        compaction budget engages.
"""

from __future__ import annotations

import heapq
import os
import shutil
import struct

import numpy as np

# tools/chrom_scale_run.py's GEN_SRC recipe, read pairs apart
CHROM_WORLD = dict(seed=99, n_sv=2000, types=("DEL", "INS", "DUP"),
                   chrom_lengths={"chr1": 60_000_000, "chr2": 40_000_000},
                   err_rate=0.01)
CHROM_PAIRS = 5_000_000


def build_bench_world(out_dir: str, n_pairs: int = 250_000) -> dict:
    """Write the BAM, index, header, status and signal files, the genome
    and the anchor contigs (the fc_sv inputs) into out_dir; returns their
    paths. A smaller n_pairs gives a quick world of the same shape for
    rehearsals on the CPU."""
    from .anchor.builder import AnchorConfig, build_anchor_contigs
    from .index.builder import build_index
    from .index.store import save_index
    from .io.fasta import write_fasta
    from .signal.extract import SignalOptions, compute_stats, extract_signal
    from .utils.simulate import DictGenome, make_dataset, write_sim_bam

    os.makedirs(out_dir, exist_ok=True)
    p = {k: os.path.join(out_dir, f) for k, f in (
        ("bam", "sim.bam"), ("index", "rdbg"), ("header", "header.sam"),
        ("status", "status.sam"), ("signal", "signal.fq"),
        ("genome", "genome.fa"), ("anchors", "anchors.fa"))}
    ds = make_dataset(
        seed=123, n_sv=64, n_pairs=n_pairs, types=("DEL", "INS"),
        chrom_lengths={"chr1": 2_000_000}, err_rate=0.02)
    write_sim_bam(ds, p["bam"])
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    write_fasta(p["genome"], ds.genome.items(), width=60)
    write_fasta(p["anchors"], ((c.name, c.seq) for c in contigs), width=70)
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases=12)
    save_index(idx, p["index"])
    with open(p["header"], "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    stats = compute_stats(p["bam"])
    with open(p["status"], "w") as fh:
        fh.write(stats.status_file_text())
    with open(p["signal"], "w") as fh:
        extract_signal(p["bam"], fh, stats=stats,
                       opts=SignalOptions(discard_both_full_match=True,
                                          not_using_filter=True))
    p["n_kmers"] = idx.n_kmers
    p["n_unitigs"] = idx.n_unitigs
    return p


def chrom_paths(out_dir: str) -> dict:
    """The files of a chromosome-scale world in out_dir."""
    return {k: os.path.join(out_dir, f) for k, f in (
        ("vcf", "svs.vcf"), ("genome", "genome.fa"), ("header", "header.sam"),
        ("bam", "sim.bam"), ("anchors", "anchors.fa"), ("index", "rdbg"),
        ("signal", "signal.fq"), ("status", "status.sam"))}


def gen_chrom_world(out_dir: str, n_pairs: int = CHROM_PAIRS,
                    workers: int | None = None, **recipe) -> dict:
    """GEN stage of the chromosome-scale world: make_dataset with
    CHROM_WORLD (updated by `recipe`) and n_pairs read pairs, then
    genome.fa, svs.vcf, header.sam and sim.bam in out_dir, the bytes
    tools/chrom_scale_run.py's GEN_SRC writes. The BAM's records are
    made by `workers` processes (default: one per CPU), see
    write_sim_bam_parallel. Returns chrom_paths(out_dir) with the
    seconds of its three steps (gen_seconds)."""
    from .io.fasta import write_fasta
    from .io.vcf import VCFWriter, minimal_header
    from .utils.simulate import make_dataset

    import time

    os.makedirs(out_dir, exist_ok=True)
    p = chrom_paths(out_dir)
    t0 = time.perf_counter()
    ds = make_dataset(n_pairs=n_pairs, **{**CHROM_WORLD, **recipe})
    t1 = time.perf_counter()
    write_fasta(p["genome"], ds.genome.items(), width=60)
    w = VCFWriter(p["vcf"], minimal_header(
        [(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    with open(p["header"], "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    t2 = time.perf_counter()
    write_sim_bam_parallel(ds, p["bam"], workers or os.cpu_count() or 1)
    p["gen_seconds"] = dict(make_dataset=t1 - t0, fasta_vcf=t2 - t1,
                            sim_bam=time.perf_counter() - t2)
    return p


def _sim_bam_part(genome, svs, reads, path) -> int:
    """Worker of write_sim_bam_parallel: the encoded records of `reads`
    in sim_bam_records' order, written to path; returns their count."""
    from .io.bam import _encode_record
    from .utils.simulate import SimDataset, sim_bam_records

    _, records = sim_bam_records(SimDataset(genome, svs, {}, reads))
    with open(path, "wb") as fh:
        for r in records:
            fh.write(_encode_record(r))
    return len(records)


def _encoded_records(path: str):
    """((tid, pos), record bytes) of a _sim_bam_part file, in order."""
    with open(path, "rb") as fh:
        while True:
            head = fh.read(12)
            if not head:
                return
            n, tid, pos = struct.unpack("<Iii", head)
            yield (tid, pos), head + fh.read(n - 8)


def write_sim_bam_parallel(ds, path: str, workers: int) -> None:
    """utils.simulate.write_sim_bam(ds, path), byte for byte, with the
    records made by `workers` processes. sim_bam_records maps every read
    pair on its own (the alt reads scan their chromosome's segment list:
    ~1 ms a pair at 2,000 SVs, the bulk of the chromosome world's
    generation) and then sorts all records by (tid, pos), stably. Here
    each worker maps and sorts one contiguous slice of ds.reads and
    writes the encoded records to a file; the slices are merged by
    (tid, pos), ties in slice order, which is that stable sort, and each
    record goes to the BAM writer in one write, as write_sim_bam's
    BamWriter.write does. Workers are spawned (the caller may hold
    threads), so each is sent its slice and the genome."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from .io.bam import BamWriter
    from .utils.simulate import SimDataset, sim_bam_records, write_sim_bam

    n = len(ds.reads)
    workers = max(1, min(workers, n // 1024))
    if workers == 1:
        write_sim_bam(ds, path)
        return
    header, _ = sim_bam_records(SimDataset(ds.genome, ds.svs, {}, []))
    cuts = [n * k // workers for k in range(workers + 1)]
    parts = [f"{path}.part{k}" for k in range(workers)]
    try:
        with ProcessPoolExecutor(workers,
                                 mp_context=get_context("spawn")) as pool:
            futs = [pool.submit(_sim_bam_part, ds.genome, ds.svs,
                                ds.reads[lo:hi], part)
                    for lo, hi, part in zip(cuts, cuts[1:], parts)]
            for f in futs:
                f.result()
        with BamWriter(path, header) as w:
            for _, rec in heapq.merge(*map(_encoded_records, parts),
                                      key=lambda kr: kr[0]):
                w.write_blob(rec)
    finally:
        for part in parts:
            if os.path.exists(part):
                os.remove(part)


def anchor_chrom_world(p: dict) -> None:
    """ANCHOR stage: anchors.fa from svs.vcf and genome.fa (what
    `fc_anchor_ref genome.fa svs.vcf > anchors.fa` writes)."""
    from .anchor.builder import run_anchor_ref
    from .io.fasta import Faidx

    with open(p["anchors"], "w") as fh:
        run_anchor_ref(p["vcf"], Faidx(p["genome"]), fh)


def index_chrom_world(p: dict):
    """INDEX stage: the index store of anchors.fa at the auto first level
    (`fc_index anchors.fa rdbg`); returns the host index."""
    from .index.builder import build_index
    from .index.store import save_index
    from .io.fasta import read_fasta

    idx = build_index(list(read_fasta(p["anchors"]).items()),
                      first_level_bases="auto")
    save_index(idx, p["index"])
    return idx


def signal_chrom_world(p: dict) -> None:
    """SIGNAL stage: signal.fq and status.sam of sim.bam, as the
    reference's fc_signal -D -U extracts them (`fc_signal sim.bam -o
    signal.fq -s status.sam -U -D`)."""
    from .signal.extract import SignalOptions, extract_signal

    with open(p["signal"], "w") as fh:
        stats = extract_signal(
            p["bam"], fh, opts=SignalOptions(discard_both_full_match=True,
                                             not_using_filter=True))
    with open(p["status"], "w") as fh:
        fh.write(stats.status_file_text())


def build_chrom_world(out_dir: str, n_pairs: int = CHROM_PAIRS,
                      workers: int | None = None, **recipe) -> dict:
    """The chromosome-scale world in out_dir, stage after stage in this
    process (scale_run runs each stage as a process of its own): GEN,
    ANCHOR, INDEX, SIGNAL. `recipe` overrides CHROM_WORLD's fields (a
    smaller genome or fewer SVs for tests); n_pairs alone cuts the
    world's reads. Returns chrom_paths(out_dir) with the index's k-mer
    and unitig counts and its first level."""
    p = gen_chrom_world(out_dir, n_pairs, workers, **recipe)
    del p["gen_seconds"]
    anchor_chrom_world(p)
    idx = index_chrom_world(p)
    signal_chrom_world(p)
    return dict(p, n_kmers=idx.n_kmers, n_unitigs=idx.n_unitigs,
                first_level=idx.first_level_bases)


def write_signal(template_fq: str, dst: str, seqs: list[str]) -> int:
    """Signal FASTQ of `seqs` (mates adjacent), each record taking the
    name, comment and quality (cut or padded to the read's length) of
    the template's records in order, cycled."""
    from .pipeline import read_signal_fastq

    tmpl = list(read_signal_fastq(template_fq))
    tmpl = tmpl[: len(tmpl) // 2 * 2]
    with open(dst, "w") as fo:
        for i, seq in enumerate(seqs[: len(seqs) // 2 * 2]):
            name, _, qual, comment = tmpl[i % len(tmpl)]
            qual = (qual * (len(seq) // max(len(qual), 1) + 1))[: len(seq)]
            fo.write(f"@{name}.{i // 2} {comment}\n{seq}\n+\n{qual}\n")
    return len(seqs) // 2 * 2


def _copy_index(src: str, dst: str) -> None:
    """A private copy of an index directory (without the engine tuning
    file a run on the source left there)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "engine_tune.json*"))


def build_overflow_world(bench: dict, out_dir: str, n_reads: int = 32_768,
                         seed: int = 7, err: float = 0.005) -> dict:
    """On-target reads over the bench world's index: each read a 150 bp
    window of an anchor contig (half of them reverse-complemented, base
    substitutions at rate `err`). Every read's hitting row has ~27 k-mer
    hits, so a batch needs ~13.5 flat lanes per row against the default
    pool of 10: the first batch overflows it for far more reads than
    max(64, active / 8). Returns the bench paths with this world's
    index copy and signal FASTQ."""
    from .utils import dna

    os.makedirs(out_dir, exist_ok=True)
    idx = load_index(bench["index"])
    rng = np.random.default_rng(seed)
    contigs = [idx.contig_seq_codes(c) for c in range(len(idx.chr_names))]
    contigs = [c for c in contigs if len(c) >= 150]
    seqs = []
    for _ in range(n_reads):
        c = contigs[int(rng.integers(len(contigs)))]
        p = int(rng.integers(0, len(c) - 150 + 1))
        codes = np.where(c[p : p + 150] >= 4, 0, c[p : p + 150]).astype(np.uint8)
        sub = rng.random(150) < err
        codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        if rng.random() < 0.5:
            codes = (codes[::-1] ^ 3).astype(np.uint8)
        seqs.append(dna.decode(codes))
    p = dict(bench, index=os.path.join(out_dir, "rdbg"),
             signal=os.path.join(out_dir, "signal.fq"))
    _copy_index(bench["index"], p["index"])
    write_signal(bench["signal"], p["signal"], seqs)
    return p


def build_uniform_world(bench: dict, out_dir: str, n_pairs: int = 12_288,
                        seed: int = 41) -> dict:
    """Read pairs simulated uniformly over a genome of the bench world's
    shape (64 DEL/INS on a 2 Mbp chr1, error 0.02, sv_region_reads
    False), every read written as a signal record, over that genome's
    own anchor index. Only the few reads near an SV hit an anchor k-mer,
    so active-row compaction engages. Header and status are the bench
    world's (same contig name and length)."""
    from .anchor.builder import AnchorConfig, build_anchor_contigs
    from .index.builder import build_index
    from .index.store import save_index
    from .utils.simulate import DictGenome, make_dataset

    os.makedirs(out_dir, exist_ok=True)
    ds = make_dataset(
        seed=seed, n_sv=64, n_pairs=n_pairs, types=("DEL", "INS"),
        chrom_lengths={"chr1": 2_000_000}, err_rate=0.02,
        sv_region_reads=False)
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    p = dict(bench, index=os.path.join(out_dir, "rdbg"),
             signal=os.path.join(out_dir, "signal.fq"))
    save_index(build_index([(c.name, c.seq) for c in contigs],
                           first_level_bases=12), p["index"])
    write_signal(bench["signal"], p["signal"],
                 [s for r in ds.reads for s in (r.seq1, r.seq2)])
    return p


def head_signal(src: str, dst: str, n_reads: int) -> int:
    """Copy the first n_reads records (pair-aligned) of a signal FASTQ."""
    n = 0
    with open(src) as fi, open(dst, "w") as fo:
        while n < n_reads // 2 * 2:
            rec = [fi.readline() for _ in range(4)]
            if not rec[0]:
                break
            fo.writelines(rec)
            n += 1
    return n


def read_batch(signal_fq: str, n_reads: int):
    """(seqs, oris) of the first n_reads signal records, oris parsed from
    the records' comments."""
    from .pipeline import parse_signal_comment, read_signal_fastq

    seqs, oris = [], []
    for rec in read_signal_fastq(signal_fq):
        if len(seqs) == n_reads:
            break
        seqs.append(rec[1])
        oris.append(parse_signal_comment(rec[3])[0])
    return seqs, oris


def host_parity(eng, seqs, oris) -> int:
    """An engine's alignments of a batch against its NumPy host aligner's,
    field by field (raises on the first difference); returns the number
    of reads with alignments."""
    got = eng.align_batch(seqs, oris)
    n_with = 0
    for i, (seq, ori) in enumerate(zip(seqs, oris)):
        exp = eng.host.align_read(seq, ori)
        if len(exp.results) != len(got[i].results):
            raise AssertionError(f"read {i}: {len(got[i].results)} results, "
                                 f"host aligner {len(exp.results)}")
        for k, (a, b) in enumerate(zip(exp.results, got[i].results)):
            for f in ("align_score", "chain_score", "direction", "ref_bg",
                      "sv_id", "mapq", "cigar"):
                if getattr(a, f) != getattr(b, f):
                    raise AssertionError(
                        f"read {i} result {k} {f}: {getattr(b, f)} vs host "
                        f"{getattr(a, f)}")
        n_with += bool(exp.results)
    return n_with


def vcf_body(path: str) -> list[str]:
    """The record lines of a VCF file."""
    with open(path) as fh:
        return [line.rstrip("\n") for line in fh if not line.startswith("#")]


def header_names(header_sam: str) -> list[str]:
    from .io.bam import BamHeader

    return BamHeader.from_sam_text(open(header_sam).read()).ref_names


def load_index(index_dir: str):
    from .index.store import load_any

    return load_any(index_dir)


def bam_records(path: str) -> list:
    """Comparable tuples of every record of a BAM file."""
    from .io.bam import BamReader

    return [(r.name, r.flag, r.tid, r.pos, r.mapq, tuple(r.cigar),
             tuple(map(tuple, r.tags))) for r in BamReader(path)]
