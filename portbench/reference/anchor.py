"""Anchor contigs of an SV database.

AnchorContig is a frozen copy of pansvr_tpu_torch/anchor/builder.py's
(the metadata channel in the contig name), and anchor_seq the window
arithmetic of its build_anchor_contigs for one DEL/INS/DUP record
(fc_anchor_ref's defaults: edge 500, one-base-left fetch quirk), so the
benchmark writes the anchors both sides read without running the
program.
"""

from __future__ import annotations

from dataclasses import dataclass

EDGE_LEN = 500


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


def anchor_seq(genome: str, pos0: int, rlen: int, alt: str, sv_type: str,
               edge: int = EDGE_LEN) -> tuple[int, str]:
    """(st_pos, contig sequence) of one SV record on its chromosome
    `genome` (a str): pos0 the record's 0-based POS, rlen its htslib rlen
    (len(REF) with INFO/END = POS + len(REF) - 1)."""
    P = pos0
    load_st = P - edge
    ori = edge
    if load_st <= 0:
        ori = P - 1
        load_st = 0
    load_ed = P + rlen + edge
    fetch0 = max(load_st - 1, 0)
    ref_seq = genome[fetch0:load_ed]
    if sv_type == "DUP":
        seq = ref_seq[: ori + rlen] + ref_seq[ori:]
    else:
        seq = ref_seq[:ori] + alt + ref_seq[ori + rlen:]
    return P - edge, seq
