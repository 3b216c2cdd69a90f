"""BAM reading/writing (htslib-free), plus SAM text conversion.

Replaces the reference's clib/bam_file.{h,c} + htslib SAM/BAM layers for
the pipeline's needs: sequential read/write of BAM over BGZF, full flag/
cigar/tag access, and the cigar_adjust normalization both bridge points
rely on (bam_file.c:1138-1226).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BGZFReader, BGZFWriter

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# 256-byte translate table mapping 4-bit codes to their bases
_SEQ16_TRANS = (SEQ_NT16.encode() + bytes(240))
SEQ_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
# base byte (either case) -> 4-bit code, unknown -> N (15)
_SEQ16_CODE_TRANS = bytearray([15]) * 256
for _i, _c in enumerate(SEQ_NT16):
    _SEQ16_CODE_TRANS[ord(_c)] = _i
    _SEQ16_CODE_TRANS[ord(_c.lower())] = _i
_SEQ16_CODE_TRANS = bytes(_SEQ16_CODE_TRANS)
CIGAR_OPS = "MIDNSHP=X"
CIGAR_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# flag bits (SAM spec)
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


@dataclass
class BamHeader:
    text: str = ""
    ref_names: list = field(default_factory=list)
    ref_lens: list = field(default_factory=list)

    def name2id(self, name: str) -> int:
        try:
            return self.ref_names.index(name)
        except ValueError:
            return -1

    @classmethod
    def from_sam_text(cls, text: str) -> "BamHeader":
        names, lens = [], []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:] if ":" in f)
                names.append(d.get("SN", "?"))
                lens.append(int(d.get("LN", 0)))
        return cls(text=text, ref_names=names, ref_lens=lens)

    def to_sam_text(self) -> str:
        """SAM header text; synthesizes @SQ lines if the stored text
        lacks them (e.g. a header built programmatically)."""
        if "@SQ" in self.text or not self.ref_names:
            return self.text
        sq = "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n"
            for n, l in zip(self.ref_names, self.ref_lens)
        )
        return (self.text or "@HD\tVN:1.6\n") + sq


@dataclass
class BamRecord:
    name: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = -1          # 0-based
    mapq: int = 0
    cigar: list = field(default_factory=list)   # [(op_char, len)]
    mtid: int = -1
    mpos: int = -1
    isize: int = 0
    seq: str = ""
    qual: str = ""         # ASCII phred+33; "*" when absent
    tags: list = field(default_factory=list)    # [(tag, type_char, value)]

    # ---- flag helpers ----------------------------------------------------
    @property
    def is_unmapped(self):
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)

    @property
    def is_read1(self):
        return bool(self.flag & FREAD1)

    @property
    def is_secondary(self):
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def mate_unmapped(self):
        return bool(self.flag & FMUNMAP)

    @property
    def mate_reverse(self):
        return bool(self.flag & FMREVERSE)

    def get_tag(self, tag: str):
        for t, ty, v in self.tags:
            if t == tag:
                return v
        return None

    def set_tag(self, tag: str, type_char: str, value):
        for i, (t, ty, v) in enumerate(self.tags):
            if t == tag:
                self.tags[i] = (tag, type_char, value)
                return
        self.tags.append((tag, type_char, value))

    # ---- derived ---------------------------------------------------------
    @property
    def query_len(self) -> int:
        return len(self.seq)

    @property
    def ref_len(self) -> int:
        return sum(n for op, n in self.cigar if op in "MDN=X")

    @property
    def end_pos(self) -> int:
        return self.pos + self.ref_len

    @property
    def soft_left(self) -> int:
        return self.cigar[0][1] if self.cigar and self.cigar[0][0] == "S" else 0

    @property
    def soft_right(self) -> int:
        return self.cigar[-1][1] if self.cigar and self.cigar[-1][0] == "S" else 0

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for op, n in self.cigar) or "*"

    def to_sam(self, header: BamHeader) -> str:
        rname = header.ref_names[self.tid] if 0 <= self.tid < len(header.ref_names) else "*"
        mrname = "*"
        if 0 <= self.mtid < len(header.ref_names):
            mrname = "=" if self.mtid == self.tid else header.ref_names[self.mtid]
        cols = [
            self.name, str(self.flag), rname, str(self.pos + 1),
            str(self.mapq), self.cigar_string(), mrname, str(self.mpos + 1),
            str(self.isize), self.seq or "*", self.qual or "*",
        ]
        for t, ty, v in self.tags:
            if ty in "cCsSiI":
                cols.append(f"{t}:i:{v}")
            elif ty == "f":
                cols.append(f"{t}:f:{v}")
            elif ty == "A":
                cols.append(f"{t}:A:{v}")
            else:
                cols.append(f"{t}:{ty}:{v}")
        return "\t".join(cols)

    @classmethod
    def from_sam(cls, line: str, header: BamHeader) -> "BamRecord":
        c = line.rstrip("\n").split("\t")
        cigar = []
        if c[5] != "*":
            num = ""
            for ch in c[5]:
                if ch.isdigit():
                    num += ch
                else:
                    cigar.append((ch, int(num)))
                    num = ""
        mrname = c[6]
        tid = header.name2id(c[2]) if c[2] != "*" else -1
        mtid = tid if mrname == "=" else (header.name2id(mrname) if mrname != "*" else -1)
        tags = []
        for t in c[11:]:
            tag, ty, val = t.split(":", 2)
            if ty == "i":
                tags.append((tag, "i", int(val)))
            elif ty == "f":
                tags.append((tag, "f", float(val)))
            else:
                tags.append((tag, ty, val))
        return cls(
            name=c[0], flag=int(c[1]), tid=tid, pos=int(c[3]) - 1,
            mapq=int(c[4]), cigar=cigar, mtid=mtid, mpos=int(c[7]) - 1,
            isize=int(c[8]), seq="" if c[9] == "*" else c[9],
            qual="" if c[10] == "*" else c[10], tags=tags,
        )


# ---- binary encode/decode -----------------------------------------------

def _encode_record(r: BamRecord) -> bytes:
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


def _parse_tags(body: bytes) -> list:
    """Decode a raw BAM aux blob into [(tag, type_char, value)] — shared
    by the BAM record decoder and the CRAM reader (whose tag series carry
    the same value byte layout)."""
    tags = []
    off = 0
    end = len(body)
    while off + 3 <= end:
        tag = body[off : off + 2].decode()
        ty = chr(body[off + 2])
        off += 3
        if ty == "A":
            tags.append((tag, "A", chr(body[off])))
            off += 1
        elif ty in "cC":
            v = struct.unpack_from("<b" if ty == "c" else "<B", body, off)[0]
            tags.append((tag, "i", v))
            off += 1
        elif ty in "sS":
            v = struct.unpack_from("<h" if ty == "s" else "<H", body, off)[0]
            tags.append((tag, "i", v))
            off += 2
        elif ty in "iI":
            v = struct.unpack_from("<i" if ty == "i" else "<I", body, off)[0]
            tags.append((tag, "i", v))
            off += 4
        elif ty == "f":
            tags.append((tag, "f", struct.unpack_from("<f", body, off)[0]))
            off += 4
        elif ty in "ZH":
            z = body.index(b"\0", off)
            tags.append((tag, ty, body[off:z].decode()))
            off = z + 1
        elif ty == "B":
            sub = chr(body[off])
            cnt = struct.unpack_from("<I", body, off + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            vals = body[off + 5 : off + 5 + cnt * size]
            tags.append((tag, "B", (sub, vals)))
            off += 5 + cnt * size
        else:
            break
    return tags


def _encode_tag_value(ty: str, v) -> bytes:
    """BAM aux VALUE bytes for one tag (no tag/type prefix) — the layout
    CRAM tag series store."""
    if ty == "i":
        return struct.pack("<i", int(v))
    if ty == "f":
        return struct.pack("<f", float(v))
    if ty == "A":
        return str(v)[:1].encode()
    if ty in "ZH":
        return str(v).encode() + b"\0"
    if ty == "B":
        sub, raw = v
        size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
        return (sub.encode() + struct.pack("<I", len(raw) // size)
                + bytes(raw))
    if ty in "cC":
        return struct.pack("<b" if ty == "c" else "<B", int(v))
    if ty in "sS":
        return struct.pack("<h" if ty == "s" else "<H", int(v))
    raise ValueError(f"unsupported tag type {ty!r}")


def _parse_cigar(body: bytes, off: int, n_cigar: int) -> list:
    cigar = []
    for k in range(n_cigar):
        v = struct.unpack_from("<I", body, off + 4 * k)[0]
        cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
    return cigar


def _parse_seq(body: bytes, off: int, l_seq: int) -> str:
    if not l_seq:
        return ""
    n_seq_b = (l_seq + 1) // 2
    packed = np.frombuffer(body, np.uint8, count=n_seq_b, offset=off)
    codes = np.empty(2 * n_seq_b, np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 0xF
    return codes[:l_seq].tobytes().translate(_SEQ16_TRANS).decode()


def _parse_qual(body: bytes, off: int, l_seq: int) -> str:
    qual_raw = body[off : off + l_seq]
    if l_seq == 0 or (qual_raw and qual_raw[0] == 0xFF):
        return ""
    qarr = np.frombuffer(qual_raw, np.uint8)
    return (np.minimum(qarr, 93) + 33).astype(np.uint8).tobytes().decode()


class LazyBamRecord:
    """BamRecord-compatible read view that parses the expensive fields
    (name, cigar, seq, qual, tags) only on first access. The fixed
    32-byte header decodes in one struct call, so streaming scans that
    filter on flag/pos/isize (fc_signal's stats and pairing passes) skip
    ~90% of the per-record decode cost. Yielded by BamReader.iter_lazy().
    Read-only by convention — use materialize() before mutating."""

    __slots__ = ("_body", "flag", "tid", "pos", "mapq", "mtid", "mpos",
                 "isize", "l_seq", "_l_name", "_n_cigar",
                 "_name", "_cigar", "_seq", "_qual", "_tags")

    def __init__(self, body: bytes):
        (self.tid, self.pos, l_name, self.mapq, _bin, n_cigar, self.flag,
         self.l_seq, self.mtid, self.mpos,
         self.isize) = struct.unpack_from("<iiBBHHHiiii", body, 0)
        self._body = body
        self._l_name = l_name
        self._n_cigar = n_cigar
        self._name = None
        self._cigar = None
        self._seq = None
        self._qual = None
        self._tags = None

    # ---- lazy fields ------------------------------------------------
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = self._body[32 : 32 + self._l_name - 1].decode()
        return self._name

    @property
    def cigar(self) -> list:
        if self._cigar is None:
            self._cigar = _parse_cigar(
                self._body, 32 + self._l_name, self._n_cigar)
        return self._cigar

    @property
    def seq(self) -> str:
        if self._seq is None:
            off = 32 + self._l_name + 4 * self._n_cigar
            self._seq = _parse_seq(self._body, off, self.l_seq)
        return self._seq

    @property
    def qual(self) -> str:
        if self._qual is None:
            off = (32 + self._l_name + 4 * self._n_cigar
                   + (self.l_seq + 1) // 2)
            self._qual = _parse_qual(self._body, off, self.l_seq)
        return self._qual

    @property
    def tags(self) -> list:
        if self._tags is None:
            off = (32 + self._l_name + 4 * self._n_cigar
                   + (self.l_seq + 1) // 2 + self.l_seq)
            self._tags = _parse_tags(self._body[off:])
        return self._tags

    def materialize(self) -> "BamRecord":
        return BamRecord(
            name=self.name, flag=self.flag, tid=self.tid, pos=self.pos,
            mapq=self.mapq, cigar=list(self.cigar), mtid=self.mtid,
            mpos=self.mpos, isize=self.isize, seq=self.seq,
            qual=self.qual, tags=list(self.tags),
        )

    # ---- BamRecord API ----------------------------------------------
    is_unmapped = BamRecord.is_unmapped
    is_reverse = BamRecord.is_reverse
    is_read1 = BamRecord.is_read1
    is_secondary = BamRecord.is_secondary
    is_supplementary = BamRecord.is_supplementary
    mate_unmapped = BamRecord.mate_unmapped
    mate_reverse = BamRecord.mate_reverse
    get_tag = BamRecord.get_tag
    ref_len = BamRecord.ref_len
    end_pos = BamRecord.end_pos
    soft_left = BamRecord.soft_left
    soft_right = BamRecord.soft_right
    cigar_string = BamRecord.cigar_string

    @property
    def query_len(self) -> int:
        return self.l_seq

    def to_sam(self, header) -> str:
        return self.materialize().to_sam(header)


def _decode_record(body: bytes) -> BamRecord:
    (tid, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     isize) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    name = body[off : off + l_name - 1].decode()
    off += l_name
    cigar = _parse_cigar(body, off, n_cigar)
    off += 4 * n_cigar
    seq = _parse_seq(body, off, l_seq)
    off += (l_seq + 1) // 2
    qual = _parse_qual(body, off, l_seq)
    off += l_seq
    tags = _parse_tags(body[off:])
    return BamRecord(
        name=name, flag=flag, tid=tid, pos=pos, mapq=mapq, cigar=cigar,
        mtid=mtid, mpos=mpos, isize=isize, seq=seq, qual=qual, tags=tags,
    )


class BamWriter:
    def __init__(self, path: str, header: BamHeader):
        self._w = BGZFWriter(path)
        self.header = header
        text_b = header.text.encode()
        out = b"BAM\1" + struct.pack("<i", len(text_b)) + text_b
        out += struct.pack("<i", len(header.ref_names))
        for nm, ln in zip(header.ref_names, header.ref_lens):
            nb = nm.encode() + b"\0"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._w.write(out)

    def write(self, r: BamRecord) -> None:
        self._w.write(_encode_record(r))

    def write_raw(self, body: bytes) -> None:
        """Write an already-encoded record body (no decode round trip)."""
        self._w.write(struct.pack("<I", len(body)) + body)

    def write_blob(self, data: bytes) -> None:
        """Write a pre-encoded record STREAM (length-prefixed records,
        e.g. the native emit path's per-batch blob)."""
        if data:
            self._w.write(data)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BamReader:
    def __init__(self, path: str):
        self._r = BGZFReader(path)
        magic = self._r.read(4)
        if magic != b"BAM\1":
            raise ValueError(f"not a BAM file: {path}")
        l_text = struct.unpack("<i", self._r.read(4))[0]
        text = self._r.read(l_text).rstrip(b"\0").decode()
        n_ref = struct.unpack("<i", self._r.read(4))[0]
        names, lens = [], []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._r.read(4))[0]
            names.append(self._r.read(l_name)[:-1].decode())
            lens.append(struct.unpack("<i", self._r.read(4))[0])
        self.header = BamHeader(text=text, ref_names=names, ref_lens=lens)

    def iter_chunks(self):
        """Yield whole decompressed chunks after the header — for native
        column scans (glue_bam_scan) that find record boundaries in C++."""
        while True:
            nb = self._r.next_chunk()
            if nb is None:
                return
            yield nb

    def iter_bodies(self):
        """Yield raw record bodies (bytes) by slicing whole decompressed
        BGZF chunks: one buffer splice per ~64 KB block instead of two
        buffer-compacting reads per record."""
        buf = b""
        pos = 0
        while True:
            while len(buf) - pos < 4:
                nb = self._r.next_chunk()
                if nb is None:
                    return
                buf = buf[pos:] + nb
                pos = 0
            sz = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
            while len(buf) - pos < sz:
                nb = self._r.next_chunk()
                if nb is None:
                    return
                buf = buf[pos:] + nb
                pos = 0
            yield buf[pos : pos + sz]
            pos += sz

    def __iter__(self):
        for body in self.iter_bodies():
            yield _decode_record(body)

    def iter_lazy(self):
        """Iterate LazyBamRecord views (expensive fields parse on first
        access) — the fast path for streaming scans."""
        for body in self.iter_bodies():
            yield LazyBamRecord(body)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def cigar_adjust(cigar: list, delete_small_tail: int, add_blank: bool):
    """Literal port of the reference's cigar_adjust (bam_file.c:1138-1226).

    Head: find the first M longer than delete_small_tail; if it is not op
    0, replace everything before it with one I of (weak-M lengths + I
    lengths) and advance the position by (weak-M lengths + D lengths).
    Tail: find the last M whose CUMULATIVE weak-M run exceeds the
    threshold; collapse everything after it into one I of (weak-M + I
    lengths). With add_blank the list keeps its original length padded
    with zero-length ops (downstream loops must tolerate them).
    Returns (new_cigar, position_adjust)."""
    if not cigar:
        return list(cigar), 0
    ops = [list(c) for c in cigar]
    orig_len = len(ops)

    # ---- head pass ------------------------------------------------------
    m_len = 0
    stable = 0
    for k, (op, ln) in enumerate(ops):
        if op == "M":
            if ln > delete_small_tail:
                stable = k
                break
            m_len += ln
    position_adjust = 0
    if stable != 0:
        position_adjust = m_len
        ins = m_len
        for k in range(stable):
            op, ln = ops[k]
            if op == "I":
                ins += ln
            elif op == "D":
                position_adjust += ln
        new_ops = []
        if ins != 0:
            new_ops.append(["I", ins])
        new_ops.extend(ops[stable:])
        ops = new_ops

    # ---- tail pass ------------------------------------------------------
    m_len = 0
    stable = 0
    for k in range(len(ops) - 1, -1, -1):
        op, ln = ops[k]
        if op == "M":
            if m_len + ln > delete_small_tail:
                stable = k
                break
            m_len += ln
    if stable != len(ops) - 1:
        ins = m_len
        for k in range(len(ops) - 1, stable, -1):
            op, ln = ops[k]
            if op == "I":
                ins += ln
        if ins != 0:
            ops = ops[: stable + 1] + [["I", ins]]
        else:
            ops = ops[: stable + 1]

    out = [(op, ln) for op, ln in ops]
    if add_blank:
        out = out + [("M", 0)] * (orig_len - len(out))
    return out, position_adjust


class BamReaderOffsets(BamReader):
    """BamReader variant that also yields each record's uncompressed
    stream span, for building tag-keyed record indexes (the loader-side
    analog of signalSAMLoader's region index over BGZF offsets)."""

    def iter_bodies_with_spans(self):
        """(uoffset, span_len, raw body) per record — for native column
        scans over the index pass."""
        while True:
            uoff = self._r.uoffset
            szb = self._r.read(4)
            if len(szb) < 4:
                return
            sz = struct.unpack("<I", szb)[0]
            body = self._r.read(sz)
            if len(body) < sz:
                return
            yield uoff, 4 + sz, body

    def iter_with_spans(self):
        while True:
            uoff = self._r.uoffset
            szb = self._r.read(4)
            if len(szb) < 4:
                return
            sz = struct.unpack("<I", szb)[0]
            body = self._r.read(sz)
            if len(body) < sz:
                return
            # lazy view: index passes touch only tags/pos, so the
            # seq/qual/cigar decode is deferred to first access
            yield uoff, 4 + sz, LazyBamRecord(body)


class BamRandomReader:
    """Random access to BAM records by uncompressed-stream spans.

    Walks the BGZF block table once at construction, then decompresses
    only the blocks covering each requested span (with a small LRU of
    decompressed blocks). Memory stays O(touched blocks), giving fc_sv
    its O(region) loading contract (signalSAMLoader.hpp:79-157)."""

    def __init__(self, path: str, cache_blocks: int = 64):
        self.path = path
        self._fh = open(path, "rb")
        self._table = []        # (file_off, u_start, u_len)
        upos = 0
        while True:
            foff = self._fh.tell()
            header = self._fh.read(18)
            if len(header) < 18:
                break
            bsize = struct.unpack("<H", header[16:18])[0] + 1
            self._fh.seek(foff + bsize - 4)
            isize = struct.unpack("<I", self._fh.read(4))[0]
            self._table.append((foff, upos, isize))
            upos += isize
        self._ustarts = [t[1] for t in self._table]
        self._cache: dict[int, bytes] = {}
        self._cache_order: list[int] = []
        self._cache_blocks = cache_blocks

    def _block_data(self, bi: int) -> bytes:
        data = self._cache.get(bi)
        if data is None:
            foff, _, _ = self._table[bi]
            self._fh.seek(foff)
            header = self._fh.read(18)
            bsize = struct.unpack("<H", header[16:18])[0] + 1
            rest = self._fh.read(bsize - 18)
            data = zlib.decompress(rest[:-8], -15)
            self._cache[bi] = data
            self._cache_order.append(bi)
            if len(self._cache_order) > self._cache_blocks:
                old = self._cache_order.pop(0)
                self._cache.pop(old, None)
        return data

    def read_span(self, uoff: int, length: int) -> bytes:
        import bisect
        bi = bisect.bisect_right(self._ustarts, uoff) - 1
        out = bytearray()
        while length > 0:
            foff, ustart, ulen = self._table[bi]
            data = self._block_data(bi)
            local = uoff - ustart
            take = min(length, ulen - local)
            out += data[local : local + take]
            uoff += take
            length -= take
            bi += 1
        return bytes(out)

    def record_at(self, uoff: int, length: int):
        body = self.read_span(uoff, length)
        return LazyBamRecord(body[4:])

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
