"""Realigned-BAM records of the plain reference.

sv_tag_string, make_bam_record and emit_pair are a frozen copy of
pansvr_tpu_torch/align/bam_out.py's (the Python emit the program's
native emit is byte-identical to), and encode_record of
pansvr_tpu_torch/io/bam.py's _encode_record, with a record class and
header of their own, so that the reference builds the bytes the program
should have written without importing it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import dna
from .host_align import FORWARD, REVERSE, AlnResult, PEPairing, SingleEndState

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_SEQ16_CODE_TRANS = bytearray([15]) * 256
for _i, _c in enumerate(SEQ_NT16):
    _SEQ16_CODE_TRANS[ord(_c)] = _i
    _SEQ16_CODE_TRANS[ord(_c.lower())] = _i
_SEQ16_CODE_TRANS = bytes(_SEQ16_CODE_TRANS)
CIGAR_CODE = {c: i for i, c in enumerate("MIDNSHP=X")}
FMUNMAP = 0x8
FREVERSE = 0x10
FREAD1 = 0x40


@dataclass
class BamHeader:
    ref_names: list

    def name2id(self, name: str) -> int:
        try:
            return self.ref_names.index(name)
        except ValueError:
            return -1


@dataclass
class BamRecord:
    name: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = -1
    mapq: int = 0
    cigar: list = field(default_factory=list)
    mtid: int = -1
    mpos: int = -1
    isize: int = 0
    seq: str = ""
    qual: str = ""
    tags: list = field(default_factory=list)

    def set_tag(self, tag: str, type_char: str, value):
        for i, (t, ty, v) in enumerate(self.tags):
            if t == tag:
                self.tags[i] = (tag, type_char, value)
                return
        self.tags.append((tag, type_char, value))


def _revcomp(seq: str) -> str:
    return dna.revcomp(seq)


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


def encode_record(r: BamRecord) -> bytes:
    name_b = r.name.encode() + b"\0"
    cigar_b = b"".join(
        struct.pack("<I", (n << 4) | CIGAR_CODE[op]) for op, n in r.cigar
    )
    l_seq = len(r.seq)
    codes = np.frombuffer(
        r.seq.encode().translate(_SEQ16_CODE_TRANS), np.uint8)
    if l_seq % 2:
        codes = np.append(codes, np.uint8(0))
    seq_b = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    if r.qual and r.qual != "*":
        q = np.frombuffer(r.qual.encode(), np.uint8)
        qual_b = np.minimum(q - 33, 93).astype(np.uint8).tobytes()
    else:
        qual_b = b"\xff" * l_seq
    tags_b = b""
    for t, ty, v in r.tags:
        tb = t.encode()
        if ty in "cCsSiI" or ty == "i":
            tags_b += tb + b"i" + struct.pack("<i", int(v))
        elif ty == "f":
            tags_b += tb + b"f" + struct.pack("<f", float(v))
        elif ty == "A":
            tags_b += tb + b"A" + str(v)[:1].encode()
        elif ty in "ZH":
            tags_b += tb + ty.encode() + str(v).encode() + b"\0"
        elif ty == "B":
            # decoder representation: (subtype char, raw element bytes)
            sub, raw = v
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
                    "f": 4}[sub]
            tags_b += (tb + b"B" + sub.encode()
                       + struct.pack("<I", len(raw) // size) + bytes(raw))
        else:
            raise ValueError(f"unsupported tag type {ty!r} for {t}")
    # bin left 0 (htslib computes reg2bin; unused by our readers)
    body = struct.pack(
        "<iiBBHHHiiii",
        r.tid, r.pos, len(name_b), r.mapq, 0, len(r.cigar),
        r.flag, l_seq, r.mtid, r.mpos, r.isize,
    ) + name_b + cigar_b + bytes(seq_b) + qual_b + tags_b
    return struct.pack("<I", len(body)) + body
