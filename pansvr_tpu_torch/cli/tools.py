"""Analysis toolbox (the reference's `tools` subcommands, src/analysis.cpp):
bam2Fastq, isize_count, bamDump, getReverseStr, ref_split, vcf_dump,
randomGenerateSV, combine_sort_vcf, gz_head, read_ACGT_analysis."""

from __future__ import annotations

import gzip
import sys


def bam2fastq(args):
    """[input.bam, output.fq] (analysis.cpp bam2Fastq)."""
    from ..io.bam import BamReader
    from ..utils import dna

    inp, outp = args[0], args[1]
    with BamReader(inp) as rd, open(outp, "w") as out:
        for rec in rd:
            seq, qual = rec.seq, rec.qual or "I" * len(rec.seq)
            if not rec.is_unmapped and rec.is_reverse:
                seq = dna.revcomp(seq)
                qual = qual[::-1]
            out.write(f"@{rec.name}\n{seq}\n+\n{qual}\n")


def isize_count(args):
    """[input.bam] — insert-size histogram to stdout."""
    from ..io.bam import BamReader

    hist: dict[int, int] = {}
    with BamReader(args[0]) as rd:
        for rec in rd:
            isz = abs(rec.isize)
            if 0 < isz < 3000:
                hist[isz] = hist.get(isz, 0) + 1
    for k in sorted(hist):
        print(f"{k}\t{hist[k]}")


def bam_dump(args):
    """[input.bam, output.bam, N] — first N records."""
    from ..io.bam import BamReader, BamWriter

    n = int(args[2])
    with BamReader(args[0]) as rd:
        with BamWriter(args[1], rd.header) as w:
            for i, rec in enumerate(rd):
                if i >= n:
                    break
                w.write(rec)


def get_reverse_str(args):
    from ..utils import dna

    print(dna.revcomp(args[0]))


def ref_split(args):
    """[input.fa] — one FASTA per contig."""
    from ..io.fasta import iter_fasta, write_fasta

    for name, seq in iter_fasta(args[0]):
        write_fasta(f"{name}.fa", [(name, seq)])


def vcf_dump(args):
    """[in_vcf, out_vcf, sample_ID, SV_TYPE, chrID] — filter records
    (analysis.cpp:702); 'ALL' disables a filter."""
    from ..io.vcf import VCFReader

    inp, outp = args[0], args[1]
    sample = args[2] if len(args) > 2 else "ALL"
    svtype = args[3] if len(args) > 3 else "ALL"
    chrom = args[4] if len(args) > 4 else "ALL"
    with VCFReader(inp) as rd, open(outp, "w") as out:
        for line in rd.header_lines:
            out.write(line + "\n")
        for rec in rd:
            if sample not in ("ALL", "all") and rec.sample_tag != sample:
                continue
            if svtype not in ("ALL", "all") and rec.sv_type != svtype:
                continue
            if chrom not in ("ALL", "all") and rec.chrom != chrom:
                continue
            out.write(rec.to_line() + "\n")


def random_generate_sv(args):
    """[ref.fa, seed, n_sv] — synthetic SV VCF to stdout
    (analysis.cpp randomGenerateSV equivalent over our simulator)."""
    import numpy as np

    from ..io.fasta import read_fasta
    from ..io.vcf import minimal_header
    from ..utils.simulate import DictGenome, plant_svs

    genome = read_fasta(args[0])
    seed = int(args[1]) if len(args) > 1 else 0
    n_sv = int(args[2]) if len(args) > 2 else 20000
    rng = np.random.default_rng(seed)
    svs = plant_svs(rng, genome, n_sv, types=("DEL", "INS"))
    for line in minimal_header([(c, len(s)) for c, s in genome.items()]):
        print(line)
    for i, sv in enumerate(svs):
        print(sv.to_vcf_record(i).to_line())


def combine_sort_vcf(args):
    """[out_vcf, in1.vcf, in2.vcf, ...] — merge + position-sort."""
    from ..io.vcf import VCFReader

    outp = args[0]
    records = []
    header = None
    for path in args[1:]:
        with VCFReader(path) as rd:
            if header is None:
                header = rd.header_lines
            records.extend(list(rd))
    records.sort(key=lambda r: (r.chrom, r.pos1))
    with open(outp, "w") as out:
        for line in header or []:
            out.write(line + "\n")
        for rec in records:
            out.write(rec.to_line() + "\n")


def gz_head(args):
    """[input.gz, N, P] — N chars from offset P."""
    n = int(args[1])
    p = int(args[2]) if len(args) > 2 else 0
    with gzip.open(args[0], "rb") as fh:
        fh.read(p)
        sys.stdout.write(fh.read(n).decode(errors="replace"))


def read_acgt_analysis(args):
    """[input.fq(.gz)] — base composition counts."""
    opener = gzip.open if args[0].endswith(".gz") else open
    counts = {c: 0 for c in "ACGTN"}
    with opener(args[0], "rt") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                for c in line.strip():
                    counts[c if c in counts else "N"] += 1
    for c, n in counts.items():
        print(f"{c}\t{n}")


def vcf_compare(args):
    """[truth.vcf query.vcf [pos_tol [min_size_sim]]] — tolerance-aware
    SV call-set comparison; prints recall/precision/F1 + divergence
    classes and each MISSED/EXTRA call."""
    from ..io.vcf_compare import compare_vcfs

    pos_tol = int(args[2]) if len(args) > 2 else 500
    mss = float(args[3]) if len(args) > 3 else 0.7
    res = compare_vcfs(args[0], args[1], pos_tol=pos_tol, min_size_sim=mss)
    for line in res.summary_lines():
        print(line)


_TOOLS = {
    "vcf_compare": vcf_compare,
    "bam2Fastq": bam2fastq,
    "isize_count": isize_count,
    "bamDump": bam_dump,
    "getReverseStr": get_reverse_str,
    "ref_split": ref_split,
    "vcf_dump": vcf_dump,
    "randomGenerateSV": random_generate_sv,
    "combine_sort_vcf": combine_sort_vcf,
    "gz_head": gz_head,
    "read_ACGT_analysis": read_acgt_analysis,
}


def dispatch(tool: str, args: list):
    if tool not in _TOOLS:
        print(f"unknown tool {tool}; available: {', '.join(_TOOLS)}",
              file=sys.stderr)
        sys.exit(1)
    _TOOLS[tool](args)
