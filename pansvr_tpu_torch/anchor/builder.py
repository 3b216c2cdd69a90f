"""SV anchor-reference construction (stage `fc_anchor_ref`).

Behavioral re-implementation of the reference's VCF_HANDLER
(src/PanSVgenerateVCF/get_anchor_ref.hpp:122-328): for each VCF SV record
passing the filters, emit one pseudo-contig per ALT allele consisting of the
ALT sequence spliced between +-edge_len of flanking reference, named

    >ID_chr_stPos_len_TYPE_bp1_bp2_edPos_vcfID      (get_anchor_ref.hpp:322-324)

COORDINATE QUIRK (reproduced deliberately for output parity): the reference
passes ``chrom:st-ed`` with st = htslib-0-based pos - edge_len to fai_fetch,
which interprets st as 1-based — so every anchor window is shifted one base
LEFT of the mathematically-consistent window, and the REF allele is spliced
out starting at 0-based position POS-2 rather than POS-1. We reproduce that
arithmetic exactly (fetch0 = P - edge - 1 below) so our FASTA is
byte-identical to the reference tool's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

from ..io.vcf import VCFReader, VCFRecord

DUP_MAX_LEN = 2000          # get_anchor_ref.hpp:14
DECOY_MIN_CHR_LEN = 40_000_000  # get_anchor_ref.hpp:172 (40M)

SV_TYPES = ("ALL", "DEL", "INS", "DUP", "TRA", "INV", "BND")


@dataclass
class AnchorConfig:
    edge_len: int = 500          # -e (get_anchor_ref.hpp:158)
    min_sv_len: int = 50         # -m (:159)
    begin_at_0: bool = False     # -b (:160)
    sample_name: str = "ALL"     # -S (:163)
    sv_type: str = "ALL"         # -T (:165)
    chrom_id: str = "ALL"        # -I (:167) — numeric contig index, not name
    discard_decoy: bool = False  # -J (:168)
    skip_n_ref: bool = False     # -N (:172)
    skip_angle_allele: bool = True  # -B (:173), default true


@dataclass
class AnchorContig:
    """One emitted anchor pseudo-contig + its metadata channel."""
    new_ref_id: int
    chrom: str
    st_pos: int      # bp-coordinates in htslib-0-based units, as the
    length: int      # reference records them in the contig name
    sv_type: str
    bp1: int
    bp2: int
    ed_pos: int
    vcf_id: str
    seq: str

    @property
    def name(self) -> str:
        return (
            f"{self.new_ref_id}_{self.chrom}_{self.st_pos}_{self.length}_"
            f"{self.sv_type}_{self.bp1}_{self.bp2}_{self.ed_pos}_{self.vcf_id}"
        )

    @staticmethod
    def parse_name(name: str) -> "AnchorContig":
        """Decode the metadata channel from a contig name (the inverse of
        the emit format; mirrored by SV_chr_info, deBGA_index.hpp:74-155).
        chrom names may themselves contain '_' — the reference's parser
        splits on '_' fields positionally from both ends."""
        parts = name.split("_")
        # fields: id, chrom(one or more parts), st, len, type, bp1, bp2, ed, vcf_id
        new_ref_id = int(parts[0])
        vcf_id = parts[-1]
        ed_pos = int(parts[-2])
        bp2 = int(parts[-3])
        bp1 = int(parts[-4])
        sv_type = parts[-5]
        length = int(parts[-6])
        st_pos = int(parts[-7])
        chrom = "_".join(parts[1:-7])
        return AnchorContig(new_ref_id, chrom, st_pos, length, sv_type,
                            bp1, bp2, ed_pos, vcf_id, "")

    @property
    def end_offset(self) -> int:
        """ed_pos - st_pos - contig_len: the reference-vs-contig length
        difference used in PE insert-size logic (deBGA_index.hpp:113)."""
        return self.ed_pos - self.st_pos - self.length


def _sv_type_ok(cfg: AnchorConfig, sv_type: str, rlen: int) -> bool:
    """try_filter() type rules (get_anchor_ref.hpp:190-198)."""
    if cfg.sv_type not in ("ALL", "all") and cfg.sv_type != sv_type:
        return False
    if sv_type in ("BND", "TRA", "INV"):
        return False
    if sv_type == "DUP" and rlen > DUP_MAX_LEN:
        return False
    return True


def _canon_type(sv_type: str | None) -> str:
    if sv_type is None:
        return "UNKNOWN"
    return sv_type if sv_type in SV_TYPES else sv_type


def build_anchor_contigs(
    records: Iterable[VCFRecord],
    genome,                     # Faidx-like: fetch(name, start0, end0), seq_len(name)
    cfg: AnchorConfig = AnchorConfig(),
    chrom_order: list[str] | None = None,
    warnings: list[str] | None = None,
) -> Iterator[AnchorContig]:
    """Generate anchor contigs per the reference's getSV_ref loop
    (get_anchor_ref.hpp:240-328)."""
    new_ref_id = 0
    chrom_index = {c: i for i, c in enumerate(chrom_order)} if chrom_order else None
    want_chrom = None
    if cfg.chrom_id not in ("ALL", "all"):
        want_chrom = int(cfg.chrom_id)

    for rec in records:
        # format checks (:252-254)
        if cfg.skip_angle_allele and rec.ref.startswith("<"):
            continue
        if cfg.skip_n_ref and rec.ref[:1] in ("N", "n"):
            continue

        sv_type = _canon_type(rec.sv_type)

        # try_filter (:186-198)
        if cfg.sample_name not in ("ALL", "all"):
            sample = rec.sample_tag
            if sample and sample != cfg.sample_name:
                continue
        P = rec.pos0 + (1 if cfg.begin_at_0 else 0)  # htslib pos (+begin_at_0 bump, :265)
        rlen = rec.rlen
        if not _sv_type_ok(cfg, sv_type, rlen):
            continue
        if want_chrom is not None:
            if chrom_index is None or chrom_index.get(rec.chrom) != want_chrom:
                continue

        if cfg.discard_decoy:  # (:270-274)
            if genome.seq_len(rec.chrom) < DECOY_MIN_CHR_LEN:
                continue
            bc = rec.chrom[0]
            if not (bc in "cCXY" or bc.isdigit()):
                continue

        # window arithmetic (:277-289) — see module docstring for the
        # deliberate one-base-left shift (htslib region parsing).
        load_st = P - cfg.edge_len
        ori = cfg.edge_len
        if load_st <= 0:
            ori = P - 1
            load_st = 0
        load_ed = P + rlen + cfg.edge_len
        fetch0 = max(load_st - 1, 0)
        ref_seq = genome.fetch(rec.chrom, fetch0, load_ed)

        if warnings is not None:
            _check_ref_field(rec, sv_type, rlen, ref_seq, ori, warnings)

        for alt in rec.alts:
            if cfg.skip_angle_allele and alt.startswith("<"):
                continue
            if rlen < cfg.min_sv_len and len(alt) < cfg.min_sv_len:
                continue
            if sv_type == "DUP":
                seq = ref_seq[: ori + rlen] + ref_seq[ori:]
            else:
                seq = ref_seq[:ori] + alt + ref_seq[ori + rlen :]
            yield AnchorContig(
                new_ref_id=new_ref_id,
                chrom=rec.chrom,
                st_pos=P - cfg.edge_len,
                length=len(seq),
                sv_type=sv_type,
                bp1=P,
                bp2=P + rlen,
                ed_pos=P + rlen + cfg.edge_len,
                vcf_id=rec.id or ".",
                seq=seq,
            )
            new_ref_id += 1


def _check_ref_field(rec, sv_type, rlen, ref_seq, ori, warnings: list[str]):
    """CHECK_REF_filed_VS_true_ref (get_anchor_ref.hpp:200-238), reduced to
    warning strings rather than stderr prints."""
    ref_field = rec.ref
    if sv_type == "DUP":
        if len(ref_field) != 1:
            warnings.append(f"DUP ref-length!=1 at {rec.chrom}:{rec.pos1}")
    elif rlen != len(ref_field):
        warnings.append(
            f"REF length {len(ref_field)} != rlen {rlen} at {rec.chrom}:{rec.pos1}"
        )
        ref_field = ref_field[:rlen]
    if ref_field[:1] in ("N", "n"):
        warnings.append(f"REF starts with N at {rec.chrom}:{rec.pos1}")
        return
    true_ref = ref_seq[ori:]
    if sv_type == "DUP":
        true_ref = ref_seq[ori + 1 :]
    if not true_ref.startswith(ref_field[: len(true_ref)]) or len(true_ref) == 0:
        warnings.append(f"REF mismatch vs genome at {rec.chrom}:{rec.pos1}")


def run_anchor_ref(vcf_path: str, genome, out_fh, cfg: AnchorConfig = AnchorConfig()):
    """File-level entry point: VCF -> anchor FASTA (70-col wrap) on out_fh."""
    from ..io.fasta import write_fasta

    with VCFReader(vcf_path) as reader:
        chrom_order = [c for c, _ in reader.contigs] or None
        contigs = build_anchor_contigs(reader, genome, cfg, chrom_order)
        write_fasta(out_fh, ((c.name, c.seq) for c in contigs), width=70)
