"""Realigned-BAM emission: engine/host aligner results -> tagged records.

Mirrors single_end_handler::output_BAM (read_realignment.cpp:479-536):
flags, position, CIGAR, mate fields, and the tag vocabulary
AS/OS/OA/CS/SV/MV/XA/RC (samTag.hpp:11-20) that fc_sv parses back.
"""

from __future__ import annotations

from ..io.bam import (
    BamHeader,
    BamRecord,
    FMUNMAP,
    FREAD1,
    FREVERSE,
)
from .host_align import FORWARD, REVERSE, AlnResult, PEPairing, SingleEndState


def sv_tag_string(info) -> str:
    """SV_chr_info::vcf_print_string: ID_chrID?_st_len_TYPE_vcfid — we keep
    the chrom NAME in place of the original-header tid (self-describing)."""
    return (
        f"{info.new_ref_id}_{info.chrom}_{info.st_pos}_{info.length}_"
        f"{info.sv_type}_{info.vcf_id}"
    )


def make_bam_record(
    aligner,
    st: SingleEndState,
    name: str,
    seq: str,
    qual: str,
    is_first: bool,
    abs_isize: int,
    comment: str,
    header: BamHeader,
    primary: AlnResult | None,
    secondary: AlnResult | None,
    mate: AlnResult | None,
) -> BamRecord | None:
    if primary is None:
        return None
    r = primary
    flag = (FREAD1 if is_first else 0)
    if r.direction == REVERSE:
        flag |= FREVERSE
    has_mate = mate is not None
    if not has_mate:
        flag |= FMUNMAP

    if r.is_ori:
        chrom = (
            aligner.ori_chrom_names[r.chr_id]
            if 0 <= r.chr_id < len(aligner.ori_chrom_names) else "*"
        )
        sv_info = aligner.sv_of(mate) if (mate is not None and not mate.is_ori) else None
    else:
        sv_info = aligner.sv_of(r)
        chrom = sv_info.chrom if sv_info else "*"
    tid = header.name2id(chrom)

    rec = BamRecord(
        name=name,
        flag=flag,
        tid=tid,
        pos=r.ref_bg,
        mapq=r.mapq,
        cigar=list(r.cigar),
        seq=seq if r.direction == FORWARD else _revcomp(seq),
        qual=qual if r.direction == FORWARD else qual[::-1],
        isize=abs_isize if r.direction == FORWARD else -abs_isize,
    )
    if has_mate:
        if mate.is_ori:
            mchrom = (
                aligner.ori_chrom_names[mate.chr_id]
                if 0 <= mate.chr_id < len(aligner.ori_chrom_names) else "*"
            )
        else:
            msv = aligner.sv_of(mate)
            mchrom = msv.chrom if msv else "*"
        rec.mtid = header.name2id(mchrom)
        rec.mpos = mate.ref_bg
    rec.set_tag("AS", "i", r.align_score)
    rec.set_tag("OS", "i", st.ori.align_score)
    rec.set_tag(
        "OA", "Z",
        f"{st.ori.chr_id},{st.ori.ref_bg},{st.ori.read_bg},{st.ori.mapq},"
        f"{'U' if st.ori_unmapped else 'M'};",
    )
    if not r.is_ori:
        rec.set_tag("CS", "i", r.chain_score)
    if sv_info is not None:
        rec.set_tag("SV", "Z", sv_tag_string(sv_info))
    if mate is not None and not mate.is_ori:
        msv = aligner.sv_of(mate)
        if msv is not None:
            rec.set_tag("MV", "Z", sv_tag_string(msv))
    if secondary is not None:
        ssv = aligner.sv_of(secondary) if not secondary.is_ori else None
        rec.set_tag(
            "XA", "Z",
            f"{secondary.chr_id},{secondary.ref_bg},{secondary.read_bg},"
            f"{secondary.align_score},"
            f"{'F' if secondary.direction == FORWARD else 'R'},"
            f"{ssv.vcf_id if ssv else '*'};",
        )
    rec.set_tag("RC", "Z", comment)
    return rec


def emit_pair(aligner, pe: PEPairing, st1: SingleEndState, st2: SingleEndState,
              name: str, seq1: str, qual1: str, seq2: str, qual2: str,
              comment1: str, comment2: str, header: BamHeader):
    """PE pairing -> up to two BAM records (primary per end)."""
    out = []
    for is_first, st, primary, mate, seq, qual, comment in (
        (True, st1, pe.max_1, pe.max_2, seq1, qual1, comment1),
        (False, st2, pe.max_2, pe.max_1, seq2, qual2, comment2),
    ):
        secondary = None
        if primary is not None:
            if primary.is_ori and st.results:
                secondary = st.results[0]
            elif len(st.results) > 1 and not primary.is_ori:
                secondary = st.results[1] if primary.rst_idx == 0 else st.results[0]
        rec = make_bam_record(
            aligner, st, name, seq, qual, is_first, abs(pe.isize), comment,
            header, primary, secondary, mate,
        )
        if rec is not None:
            out.append(rec)
    return out


def min_filter_score(normal_read_len: int, match: int = 2) -> int:
    """Full-match PE score threshold gating the original-alignment
    side-channel (read_realignment.cpp:143)."""
    return max(normal_read_len * match * 2 - 80, 50)


def _parse_ori_record(comment: str):
    """FLAG_<flag>_<qual>_CIGAR_<cig>_MATE_<mtid>_<mpos>_<isize>_TAG_<tags>
    -> (flag, qual, cigar_str, mtid, mpos, isize, tag_list).  Inverse of
    the block written by signal._pair_comment; the reference re-parses it
    the same way in output_ori_bam (read_realignment.cpp:656-717)."""
    k = comment.index("FLAG_")
    rest = comment[k + 5 :]
    flag_s, qual_s, rest = rest.split("_", 2)
    assert rest.startswith("CIGAR_")
    rest = rest[6:]
    cig, rest = rest.split("_MATE_", 1)
    mtid_s, mpos_s, isize_s, rest = rest.split("_", 3)
    assert rest.startswith("TAG_")
    tags_blob = rest[4:]
    # split on '_' only where a new `XX:Y:` tag begins (the reference's
    # tags[i]=='_' && tags[i+3]==':' && tags[i+5]==':' rewrite)
    tags = []
    start = 0
    for i in range(len(tags_blob)):
        if (tags_blob[i] == "_" and i + 5 < len(tags_blob)
                and tags_blob[i + 3] == ":" and tags_blob[i + 5] == ":"):
            tags.append(tags_blob[start:i])
            start = i + 1
    last = tags_blob[start:].rstrip("_")
    if last:
        tags.append(last)
    return (int(flag_s), int(qual_s), cig, int(mtid_s), int(mpos_s),
            int(isize_s), [t for t in tags if t])


def _cigar_from_str(cig: str):
    out = []
    n = 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((ch, n))
            n = 0
    return out


def _ori_clip_or_unmapped(cigar, min_clip_len: int) -> bool:
    """bam_has_clip_or_unmapped_ori (read_realignment.cpp:721-734):
    end soft/hard clips of the reconstructed original record."""
    if not cigar:
        return True
    total = 0
    if cigar[0][0] in "SH":
        total += cigar[0][1]
    if len(cigar) > 1 and cigar[-1][0] in "SH":
        total += cigar[-1][1]
    return total >= min_clip_len


def _new_clip_or_unmapped(r: AlnResult, min_clip_len: int) -> bool:
    """bam_has_clip_or_unmapped_new (read_realignment.cpp:736-744):
    total soft clip of the new alignment."""
    if r is None or not r.cigar:
        return True
    return sum(l for op, l in r.cigar if op == "S") >= min_clip_len


def make_ori_record(st: SingleEndState, name: str, seq: str, qual: str,
                    comment: str, header: BamHeader, max_score: int,
                    ori_chrom_names) -> BamRecord | None:
    """Reconstruct the ORIGINAL alignment record from the signal comment
    (single_end_handler::output_ori_bam, read_realignment.cpp:656-718):
    pos/chrom from the parsed ori mapping, flag/qual/CIGAR/mate/tags from
    the comment's FLAG_/CIGAR_/MATE_/TAG_ block, plus MS:i:<pair max>."""
    try:
        flag, qual_score, cig, mtid, mpos, isize, tags = _parse_ori_record(comment)
    except (ValueError, AssertionError):
        return None
    o = st.ori
    chrom = (ori_chrom_names[o.chr_id]
             if 0 <= o.chr_id < len(ori_chrom_names) else "*")
    # the signal FASTQ stores reads in forward orientation; restore the
    # record's original strand
    if flag & FREVERSE:
        seq = _revcomp(seq)
        qual = qual[::-1]
    rec = BamRecord(
        name=name, flag=flag, tid=header.name2id(chrom), pos=o.ref_bg,
        mapq=qual_score, cigar=_cigar_from_str(cig), seq=seq, qual=qual,
        mtid=mtid, mpos=mpos, isize=isize,
    )
    for t in tags:
        tag, typ, val = t.split(":", 2)
        rec.set_tag(tag, typ, int(val) if typ == "i" else val)
    rec.set_tag("MS", "i", max_score)
    return rec


def emit_ori_pair(pe: PEPairing, st1: SingleEndState, st2: SingleEndState,
                  name: str, seq1: str, qual1: str, seq2: str, qual2: str,
                  comment1: str, comment2: str, header: BamHeader,
                  filter_score: int, ori_chrom_names) -> list:
    """The `-p` output_ori side-channel (read_realignment.cpp:775-798):
    pairs that neither reference explains well (pair score <= the
    full-match threshold) get their ORIGINAL alignments written for the
    de novo caller — unless the pair is properly mated with unclipped
    primaries, in which case it is suppressed."""
    if pe.max_score > filter_score:
        return []
    if st1.ori.chr_id < 0 or st2.ori.chr_id < 0:
        return []
    recs = []
    for st, name_, seq, qual, comment in (
        (st1, name, seq1, qual1, comment1),
        (st2, name, seq2, qual2, comment2),
    ):
        rec = make_ori_record(st, name_, seq, qual, comment, header,
                              pe.max_score, ori_chrom_names)
        if rec is None:
            return []
        recs.append(rec)
    properly_mapped = pe.proper_mated
    for c_max, rec in ((pe.max_1, recs[0]), (pe.max_2, recs[1])):
        if not properly_mapped:
            break
        if c_max is None:
            properly_mapped = False
        elif c_max.is_ori:
            properly_mapped = not _ori_clip_or_unmapped(rec.cigar, 25)
        else:
            properly_mapped = not _new_clip_or_unmapped(c_max, 25)
    if properly_mapped:
        return []
    return recs


def _revcomp(seq: str) -> str:
    from ..utils import dna

    return dna.revcomp(seq)


# ---------------------------------------------------------------------
# Native-emit support: precomputed tables the C++ PE-pair/emit pass
# (native/engine_glue.cpp glue_pe_emit) indexes by sv_id / ori chr_id.


def _blob(items: list[bytes]):
    import numpy as np

    off = np.zeros(len(items) + 1, np.int64)
    if items:
        np.cumsum([len(b) for b in items], out=off[1:])
    data = np.frombuffer(b"".join(items) or b"\0", np.uint8).copy()
    return data, off


class EmitContext:
    """Per-run constants for glue_pe_emit: header tids, interned
    chrom-name keys (proper-mating equality), SV tag strings, and the
    PE scorer's isize window (PEScorer.__init__ adjustments baked into
    *_adj)."""

    def __init__(self, aligner, header: BamHeader, max_isize: int,
                 min_isize: int, normal_read_len: int):
        import numpy as np

        keys: dict[str, int] = {}

        def key(name: str) -> int:
            return keys.setdefault(name, len(keys))

        sv = aligner.sv_info
        self.sv_tid = np.array(
            [header.name2id(s.chrom) for s in sv], np.int32)
        self.sv_key = np.array([key(s.chrom) for s in sv], np.int32)
        self.sv_end_off = np.array([s.end_offset for s in sv], np.int32)
        self.svtag_blob, self.svtag_off = _blob(
            [sv_tag_string(s).encode() for s in sv])
        self.vcfid_blob, self.vcfid_off = _blob(
            [str(s.vcf_id).encode() for s in sv])
        self.header = header
        ori_names = aligner.ori_chrom_names
        self.ori_tid = np.array(
            [header.name2id(nm) for nm in ori_names], np.int32)
        self.ori_key = np.array([key(nm) for nm in ori_names], np.int32)
        self.max_isize = max_isize
        self.min_isize = min_isize
        self.normal_read_len = normal_read_len
        self.max_isize_adj = max_isize + 200
        self.min_isize_adj = max(0, min_isize - 200)
