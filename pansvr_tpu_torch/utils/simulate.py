"""Synthetic data generation for tests and benchmarks.

Plays the role of the reference's `tools randomGenerateSV`
(src/analysis.cpp:2122-2228): fabricate a random genome, plant DEL/INS/DUP
SVs (INS content copied from elsewhere in the genome, as the reference
does), derive alt haplotypes, and simulate paired-end reads with sequencing
errors from a mixture of haplotypes. Everything is seeded NumPy — fully
deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.vcf import VCFRecord
from . import dna

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, lengths: dict[str, int]) -> dict[str, str]:
    return {
        name: BASES[rng.integers(0, 4, size=n)].tobytes().decode()
        for name, n in lengths.items()
    }


class DictGenome:
    """Adapter giving a dict {name: seq} the Faidx fetch interface."""

    def __init__(self, seqs: dict[str, str]):
        self.seqs = seqs
        self.names = list(seqs)

    def seq_len(self, name: str) -> int:
        return len(self.seqs[name])

    def fetch(self, name: str, start: int, end: int) -> str:
        s = self.seqs[name]
        start = max(0, min(start, len(s)))
        end = max(start, min(end, len(s)))
        return s[start:end]


@dataclass
class PlantedSV:
    chrom: str
    pos1: int          # 1-based POS (VCF convention, anchor base included)
    sv_type: str       # DEL | INS | DUP
    length: int        # SV length (bases deleted/inserted/duplicated)
    ref: str
    alt: str

    def to_vcf_record(self, idx: int) -> VCFRecord:
        end = self.pos1 + len(self.ref) - 1
        svlen = -self.length if self.sv_type == "DEL" else self.length
        return VCFRecord(
            chrom=self.chrom,
            pos1=self.pos1,
            id=f"sim.{self.sv_type}.{idx}",
            ref=self.ref,
            alts=[self.alt],
            qual=".",
            filter="PASS",
            info={"SVTYPE": self.sv_type, "END": str(end), "SVLEN": str(svlen)},
        )


def plant_svs(
    rng: np.random.Generator,
    genome: dict[str, str],
    n_sv: int,
    min_len: int = 50,
    max_len: int = 500,
    types: tuple[str, ...] = ("DEL", "INS"),
    min_gap: int = 2000,
) -> list[PlantedSV]:
    """Place non-overlapping SVs; positions sorted per chromosome."""
    svs: list[PlantedSV] = []
    chroms = list(genome)
    total = sum(len(genome[c]) for c in chroms)
    occupied: dict[str, list[tuple[int, int]]] = {c: [] for c in chroms}
    attempts = 0
    while len(svs) < n_sv and attempts < n_sv * 100:
        attempts += 1
        c = chroms[int(rng.integers(len(chroms)))]
        seq = genome[c]
        L = int(rng.integers(min_len, max_len + 1))
        pos0 = int(rng.integers(1000, max(1001, len(seq) - L - 1000)))
        if any(abs(pos0 - s) < min_gap + L for s, e in occupied[c]):
            continue
        t = types[int(rng.integers(len(types)))]
        anchor = seq[pos0 - 1]
        if t == "DEL":
            ref = seq[pos0 - 1 : pos0 + L]   # anchor + deleted bases
            alt = anchor
        elif t == "INS":
            # insertion content copied from a random distal genome location
            src = int(rng.integers(0, len(seq) - L))
            ins = seq[src : src + L]
            ref = anchor
            alt = anchor + ins
        elif t == "DUP":
            ref = seq[pos0 - 1 : pos0 + L]
            alt = ref + ref[1:]  # tandem duplication representation
        elif t == "INV":
            seg = seq[pos0 : pos0 + L]
            comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
            ref = anchor + seg
            alt = anchor + "".join(comp.get(c, "N") for c in reversed(seg))
        else:
            raise ValueError(t)
        occupied[c].append((pos0, pos0 + L))
        svs.append(PlantedSV(c, pos0, t, L, ref, alt))
    svs.sort(key=lambda s: (s.chrom, s.pos1))
    return svs


def apply_svs(genome: dict[str, str], svs: list[PlantedSV]) -> dict[str, str]:
    """Build the ALT haplotype per chromosome (all SVs homozygous-applied)."""
    out = {}
    by_chrom: dict[str, list[PlantedSV]] = {}
    for sv in svs:
        by_chrom.setdefault(sv.chrom, []).append(sv)
    for c, seq in genome.items():
        parts = []
        cur = 0
        for sv in sorted(by_chrom.get(c, []), key=lambda s: s.pos1):
            st0 = sv.pos1 - 1
            parts.append(seq[cur:st0])
            parts.append(sv.alt)
            cur = st0 + len(sv.ref)
        parts.append(seq[cur:])
        out[c] = "".join(parts)
    return out


@dataclass
class SimRead:
    name: str
    seq1: str
    qual1: str
    seq2: str
    qual2: str
    chrom: str
    pos0_1: int       # true fwd-read leftmost position on its haplotype
    pos0_2: int
    from_alt: bool
    n_err1: int = 0   # introduced sequencing errors (-> the NM tag)
    n_err2: int = 0


def simulate_read_pairs(
    rng: np.random.Generator,
    hap: dict[str, str],
    n_pairs: int,
    read_len: int = 150,
    isize_mean: float = 400.0,
    isize_sd: float = 40.0,
    err_rate: float = 0.002,
    name_prefix: str = "sim",
    from_alt: bool = False,
    regions: list[tuple[str, int, int]] | None = None,
) -> list[SimRead]:
    """FR paired-end reads. Read1 forward at p, read2 = revcomp of
    [p+isize-read_len, p+isize). If ``regions`` given, pairs are drawn
    uniformly from those (chrom, start0, end0) windows."""
    reads = []
    chroms = list(hap)
    lens = np.array([len(hap[c]) for c in chroms], dtype=np.float64)
    probs = lens / lens.sum()
    for i in range(n_pairs):
        if regions:
            c, rst, ren = regions[int(rng.integers(len(regions)))]
            seq = hap[c]
            lo = max(0, rst)
            hi = max(lo + 1, min(ren, len(seq) - read_len - 1))
        else:
            c = chroms[int(rng.choice(len(chroms), p=probs))]
            seq = hap[c]
            lo, hi = 0, len(seq) - 600
        isize = max(read_len + 10, int(rng.normal(isize_mean, isize_sd)))
        p = int(rng.integers(lo, max(lo + 1, hi)))
        p2 = min(p + isize - read_len, len(seq) - read_len)
        s1 = seq[p : p + read_len]
        s2_fwd = seq[p2 : p2 + read_len]
        if len(s1) < read_len or len(s2_fwd) < read_len:
            continue
        s1, ne1 = _add_errors_n(rng, s1, err_rate)
        s2_fwd, ne2 = _add_errors_n(rng, s2_fwd, err_rate)
        s2 = dna.revcomp(s2_fwd)
        q = "I" * read_len
        reads.append(
            SimRead(
                name=f"{name_prefix}.{i}",
                seq1=s1, qual1=q, seq2=s2, qual2=q,
                chrom=c, pos0_1=p, pos0_2=p2, from_alt=from_alt,
                n_err1=ne1, n_err2=ne2,
            )
        )
    return reads


def _add_errors(rng: np.random.Generator, seq: str, rate: float) -> str:
    s, _ = _add_errors_n(rng, seq, rate)
    return s


def _add_errors_n(rng: np.random.Generator, seq: str,
                  rate: float) -> tuple[str, int]:
    if rate <= 0:
        return seq, 0
    codes = dna.encode(seq)
    mask = rng.random(len(codes)) < rate
    if not mask.any():
        return seq, 0
    codes = codes.copy()
    codes[mask] = (codes[mask] + rng.integers(1, 4, size=mask.sum())) & 3
    return dna.decode(codes), int(mask.sum())


@dataclass
class SimDataset:
    genome: dict[str, str]
    svs: list[PlantedSV]
    alt_hap: dict[str, str]
    reads: list[SimRead]

    @property
    def vcf_records(self) -> list[VCFRecord]:
        return [sv.to_vcf_record(i) for i, sv in enumerate(self.svs)]


def _alt_to_ref_segments(genome: dict[str, str], svs: list[PlantedSV]):
    """Per chromosome: list of (alt_start, alt_end, ref_start) collinear
    segments of the ALT haplotype; inserted sequence has no segment."""
    segs: dict[str, list[tuple[int, int, int]]] = {}
    for c, seq in genome.items():
        c_svs = sorted((s for s in svs if s.chrom == c), key=lambda s: s.pos1)
        out = []
        ref_cur = 0
        alt_cur = 0
        for sv in c_svs:
            st0 = sv.pos1 - 1
            seg_len = st0 - ref_cur
            out.append((alt_cur, alt_cur + seg_len, ref_cur))
            alt_cur += seg_len
            ref_cur = st0
            # shared anchor prefix of ref/alt stays collinear
            k = 0
            while (k < len(sv.ref) and k < len(sv.alt)
                   and sv.ref[k] == sv.alt[k]):
                k += 1
            if k:
                out.append((alt_cur, alt_cur + k, ref_cur))
            if sv.sv_type == "INV":
                # inverted content: alt[a0:a1] == revcomp(ref[r0:r0+L])
                out.append((alt_cur + k, alt_cur + len(sv.alt),
                            ref_cur + k, True))
            alt_cur += len(sv.alt)
            ref_cur += len(sv.ref)
        out.append((alt_cur, alt_cur + len(seq) - ref_cur, ref_cur))
        segs[c] = out
    return segs


def sim_bam_records(ds: "SimDataset", read_len: int = 150):
    """BWA-like original alignments for the simulated pairs: reads from
    collinear segments get full-M proper pairs; alt reads spanning
    breakpoints get soft-clipped records; pairs across deletions get
    inflated insert sizes. Returns (header, records sorted by position).
    """
    from ..io.bam import BamHeader, BamRecord, FPAIRED, FREAD1, FREAD2, \
        FREVERSE, FMREVERSE, FPROPER_PAIR, FUNMAP, FMUNMAP

    chroms = list(ds.genome)
    header = BamHeader.from_sam_text(
        "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{c}\tLN:{len(s)}\n" for c, s in ds.genome.items()
        )
    )
    segs = _alt_to_ref_segments(ds.genome, ds.svs)

    def map_read(chrom, p, L, from_alt):
        """-> (ref_pos, cigar, mapped_len, strand_flip) with soft clips
        at breakpoints, or None if unmappable (inside insertion). A read
        landing in a strand-flipped segment (inversion interior) maps to
        the reverse strand with its clip sides swapped — the BWA
        behavior that produces the same-strand INV pair signal."""
        if not from_alt:
            return p, [("M", L)], L, False
        best = None
        for seg in segs[chrom]:
            a0, a1, r0 = seg[0], seg[1], seg[2]
            rev = len(seg) > 3 and seg[3]
            lo = max(p, a0)
            hi = min(p + L, a1)
            if hi - lo > (best[1] - best[0] if best else 0):
                best = (lo, hi, a0, a1, r0, rev)
        if best is None or best[1] - best[0] < 30:
            return None
        lo, hi, a0, a1, r0, rev = best
        if not rev:
            rpos = r0 + (lo - a0)
            cig = []
            if lo > p:
                cig.append(("S", lo - p))
            cig.append(("M", hi - lo))
            if p + L > hi:
                cig.append(("S", p + L - hi))
            return rpos, cig, hi - lo, False
        # reverse segment: alt[a0:a1] == revcomp(ref[r0:r0+(a1-a0)])
        rpos = r0 + (a1 - hi)
        cig = []
        if p + L > hi:                      # alt right clip -> ref left
            cig.append(("S", p + L - hi))
        cig.append(("M", hi - lo))
        if lo > p:                          # alt left clip -> ref right
            cig.append(("S", lo - p))
        return rpos, cig, hi - lo, True

    records = []
    for rd in ds.reads:
        hap_maps = []
        for (p, seq, rev) in ((rd.pos0_1, rd.seq1, False), (rd.pos0_2, rd.seq2, True)):
            hap_maps.append(map_read(rd.chrom, p, len(seq), rd.from_alt))
        tid = chroms.index(rd.chrom)
        recs = []
        for k, (p, seq, qual, rev) in enumerate(
            ((rd.pos0_1, rd.seq1, rd.qual1, False),
             (rd.pos0_2, rd.seq2, rd.qual2, True))
        ):
            m = hap_maps[k]
            mm = hap_maps[1 - k]
            flip = m[3] if m else False
            mflip = mm[3] if mm else False
            strand_rev = rev ^ flip
            mate_rev = (k == 0) ^ mflip   # mate's sequenced dir is opposite
            flag = FPAIRED | (FREAD1 if k == 0 else FREAD2)
            if strand_rev:
                flag |= FREVERSE
            if mm is None:
                flag |= FMUNMAP
            elif mate_rev:
                flag |= FMREVERSE
            # BAM stores the read on the forward reference strand: the
            # sequenced bases as-is when mapped forward, revcomp'd when
            # mapped reverse (strand flips inside inverted segments)
            r = BamRecord(
                name=rd.name, flag=flag, tid=tid,
                seq=seq if not strand_rev else dna.revcomp(seq),
                qual=qual if not strand_rev else qual[::-1], mapq=60,
                # NM = introduced sequencing errors (an upstream aligner
                # would report these as mismatches for clean-cigar reads)
                tags=[("NM", "i", rd.n_err1 if k == 0 else rd.n_err2)],
            )
            if m is None:
                r.flag |= FUNMAP
                r.pos = mm[0] if mm else 0
                r.mapq = 0
                r.cigar = []
            else:
                r.pos, r.cigar, _ = m[0], m[1], m[2]
            r.mtid = tid
            r.mpos = (mm[0] if mm else (m[0] if m else 0))
            recs.append(r)
        # isize
        if hap_maps[0] and hap_maps[1]:
            lo = min(recs[0].pos, recs[1].pos)
            hi = max(recs[0].end_pos, recs[1].end_pos)
            isz = hi - lo
            recs[0].isize = isz if recs[0].pos <= recs[1].pos else -isz
            recs[1].isize = -recs[0].isize
            if isz < 1000:
                recs[0].flag |= FPROPER_PAIR
                recs[1].flag |= FPROPER_PAIR
        records.extend(recs)
    records.sort(key=lambda r: (r.tid, r.pos))
    return header, records


def write_sim_bam(ds: "SimDataset", path: str, read_len: int = 150):
    from ..io.bam import BamWriter

    header, records = sim_bam_records(ds, read_len)
    with BamWriter(path, header) as w:
        for r in records:
            w.write(r)
    return header


def make_dataset(
    seed: int = 0,
    chrom_lengths: dict[str, int] | None = None,
    n_sv: int = 8,
    n_pairs: int = 400,
    sv_region_reads: bool = True,
    err_rate: float = 0.002,
    **sv_kwargs,
) -> SimDataset:
    """One-call synthetic dataset: genome + SVs + reads from ref and alt
    haplotypes (half/half), SV-region-focused if sv_region_reads."""
    rng = np.random.default_rng(seed)
    if chrom_lengths is None:
        chrom_lengths = {"chr1": 200_000, "chr2": 150_000}
    genome = random_genome(rng, chrom_lengths)
    svs = plant_svs(rng, genome, n_sv, **sv_kwargs)
    alt = apply_svs(genome, svs)
    regions_ref = regions_alt = None
    if sv_region_reads:
        regions_ref = [(sv.chrom, sv.pos1 - 800, sv.pos1 + len(sv.ref) + 800) for sv in svs]
        # map region into alt-hap coordinates (shift by cumulative delta)
        regions_alt = []
        delta: dict[str, int] = {c: 0 for c in genome}
        by_c: dict[str, list[PlantedSV]] = {}
        for sv in svs:
            by_c.setdefault(sv.chrom, []).append(sv)
        for sv in svs:
            d = sum(
                len(x.alt) - len(x.ref)
                for x in by_c[sv.chrom]
                if x.pos1 < sv.pos1
            )
            regions_alt.append(
                (sv.chrom, sv.pos1 - 800 + d, sv.pos1 + len(sv.alt) + 800 + d)
            )
    r_ref = simulate_read_pairs(
        rng, genome, n_pairs // 2, name_prefix="ref", from_alt=False,
        regions=regions_ref, err_rate=err_rate,
    )
    r_alt = simulate_read_pairs(
        rng, alt, n_pairs - n_pairs // 2, name_prefix="alt", from_alt=True,
        regions=regions_alt, err_rate=err_rate,
    )
    return SimDataset(genome=genome, svs=svs, alt_hap=alt, reads=r_ref + r_alt)
