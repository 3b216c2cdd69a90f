"""Binary BCF 2.2 reader.

The reference consumes SV call sets through htslib's unified
`bcf_read`/`vcf_parse` surface (src/clib/vcf_file.h:25-36 wraps
`bcf_sr_add_reader`, which opens .vcf, .vcf.gz and .bcf alike; the
binary record layout is htslib vcf.c `bcf_read1_core`). Our text
VCF/VCF.gz reader (io/vcf.py) covered the first two; this module adds
the binary leg so `VCFReader` accepts every input the reference does.

Decodes the BGZF-framed BCF 2.x stream and renders each record into
the same `VCFRecord` (text-typed fields) the rest of the pipeline
consumes — the anchor builder, force caller and toolbox see no
difference between a text and binary source.

Layout (BCF2.2 spec / htslib vcf.c):
  magic "BCF\\2\\x02" | l_text u32 | header text (NUL-padded)
  per record: l_shared u32 | l_indiv u32 | shared block | indiv block
  shared: rid i32, pos i32 (0-based), rlen i32, qual f32,
          (n_allele<<16|n_info) u32, (n_fmt<<24|n_sample) u32,
          ID typed-str, n_allele typed-strs, FILTER typed-int-vec,
          n_info x (typed-int key, typed value)
  indiv:  n_fmt x (typed-int key, typed vector of per-sample values)
Typed descriptor byte: low nibble = type (1=i8, 2=i16, 3=i32, 5=f32,
7=char), high nibble = count (15 -> next typed scalar is the count).
"""

from __future__ import annotations

import struct
from typing import Iterator

from .bgzf import BGZFReader
from .vcf import VCFRecord

_MISSING = {1: -128, 2: -32768, 3: -2147483648}
_EOV = {1: -127, 2: -32767, 3: -2147483647}
_SIZE = {1: 1, 2: 2, 3: 4, 5: 4, 7: 1}
_FMT = {1: "b", 2: "h", 3: "i", 5: "f"}

_QUAL_MISSING = 0x7F800001  # bcf_float_missing bit pattern
_QUAL_EOV = 0x7F800002      # bcf_float_vector_end bit pattern


def _fmt_float(v: float) -> str:
    s = f"{v:g}"
    return s


class _Cursor:
    __slots__ = ("buf", "o")

    def __init__(self, buf: bytes, o: int = 0):
        self.buf = buf
        self.o = o

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.o)[0]
        self.o += 4
        return v

    def typed_desc(self) -> tuple[int, int]:
        d = self.buf[self.o]
        self.o += 1
        t = d & 0x0F
        n = d >> 4
        if n == 15:
            n = self.typed_scalar_int()
        return t, n

    def typed_scalar_int(self) -> int:
        t, n = self.typed_desc()
        assert t in (1, 2, 3) and n == 1, f"bad typed int ({t},{n})"
        v = struct.unpack_from("<" + _FMT[t], self.buf, self.o)[0]
        self.o += _SIZE[t]
        return v

    def typed_value(self):
        """Decode one typed value -> (type, list-or-str)."""
        t, n = self.typed_desc()
        if t == 0 or n == 0:
            return t, []
        if t == 7:
            s = self.buf[self.o : self.o + n].decode("latin-1")
            self.o += n
            return t, s
        if t == 5:
            # floats decode as uint32 BIT PATTERNS: bcf_float_missing
            # (0x7F800001) and bcf_float_vector_end (0x7F800002) are both
            # NaN as Python floats and would be indistinguishable
            vals = list(struct.unpack_from(f"<{n}I", self.buf, self.o))
        else:
            vals = list(struct.unpack_from(f"<{n}{_FMT[t]}", self.buf, self.o))
        self.o += n * _SIZE[t]
        return t, vals


def _render_info_value(t: int, vals) -> str | bool:
    if t == 0:
        return True                      # Flag
    if t == 7:
        return vals                      # char string, verbatim
    if t == 5:
        # vals are uint32 bit patterns (see typed_value): terminate on
        # vector-end, render '.' only for missing — the integer EOV/
        # missing split (htslib vcf.c bcf_fmt_array float leg)
        out = []
        for bits in vals:
            if bits == _QUAL_EOV:
                break
            if bits == _QUAL_MISSING:
                out.append(".")
            else:
                out.append(_fmt_float(
                    struct.unpack("<f", struct.pack("<I", bits))[0]))
    else:
        miss, eov = _MISSING[t], _EOV[t]
        out = []
        for v in vals:
            if v == eov:
                break
            out.append("." if v == miss else str(v))
    return ",".join(out)


def _render_gt(t: int, vals) -> str:
    miss = _MISSING.get(t, -128)
    eov = _EOV.get(t, -127)
    parts = []
    for i, v in enumerate(vals):
        if v == eov:
            break
        sep = ("|" if v & 1 else "/") if i else ""
        a = "." if v == miss or (v >> 1) == 0 else str((v >> 1) - 1)
        parts.append(sep + a)
    return "".join(parts) or "."


class BCFReader:
    """Same surface as io.vcf.VCFReader: .header_lines, .contigs,
    iteration yields VCFRecord."""

    def __init__(self, path_or_fh):
        self._bgzf = BGZFReader(path_or_fh)
        magic = self._bgzf.read(5)
        if magic[:3] != b"BCF":
            raise ValueError(f"not a BCF file (magic {magic!r})")
        l_text = struct.unpack("<I", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).split(b"\0", 1)[0]
        text = text.decode("utf-8", "replace")
        self.header_lines = [ln for ln in text.split("\n") if ln]
        self.contigs: list[tuple[str, int]] = []
        self._contig_names: list[str] = []
        # shared FILTER/INFO/FORMAT string dictionary: explicit IDX=
        # wins, else order of first appearance; PASS is implicitly 0
        # (htslib vcf.c bcf_hdr_register_hrec)
        self._dict: dict[int, str] = {}
        seen: dict[str, int] = {}
        next_idx = 0

        def reg(name: str, idx: int | None):
            nonlocal next_idx
            if name in seen:
                return
            if idx is None:
                idx = next_idx
            seen[name] = idx
            self._dict[idx] = name
            next_idx = max(next_idx, idx + 1)

        reg("PASS", 0)
        for ln in self.header_lines:
            if ln.startswith(("##FILTER=<", "##INFO=<", "##FORMAT=<")):
                fields = _split_meta(ln)
                if "ID" in fields:
                    idx = int(fields["IDX"]) if "IDX" in fields else None
                    reg(fields["ID"], idx)
            elif ln.startswith("##contig=<"):
                fields = _split_meta(ln)
                if "ID" in fields:
                    self._contig_names.append(fields["ID"])
                    self.contigs.append(
                        (fields["ID"], int(fields.get("length", 0))))

    def _name(self, idx: int) -> str:
        return self._dict.get(idx, str(idx))

    def __iter__(self) -> Iterator[VCFRecord]:
        while True:
            hdr = self._bgzf.read(8)
            if len(hdr) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", hdr)
            body = self._bgzf.read(l_shared + l_indiv)
            if len(body) < l_shared + l_indiv:
                return
            yield self._decode(body, l_shared)

    def _decode(self, body: bytes, l_shared: int) -> VCFRecord:
        c = _Cursor(body)
        rid = struct.unpack_from("<i", body, 0)[0]
        pos = struct.unpack_from("<i", body, 4)[0]
        # rlen at 8 (unused: VCFRecord derives it from REF)
        qual_bits = struct.unpack_from("<I", body, 12)[0]
        n_ai = struct.unpack_from("<I", body, 16)[0]
        n_info, n_allele = n_ai & 0xFFFF, n_ai >> 16
        n_fs = struct.unpack_from("<I", body, 20)[0]
        n_sample, n_fmt = n_fs & 0xFFFFFF, n_fs >> 24
        c.o = 24
        _, vid = c.typed_value()
        alleles = []
        for _ in range(n_allele):
            _, a = c.typed_value()
            alleles.append(a if isinstance(a, str) else "")
        tf, fvals = c.typed_value()
        if isinstance(fvals, str) or not fvals:
            filt = "."
        else:
            filt = ";".join(self._name(int(v)) for v in fvals)
        info: dict[str, str | bool] = {}
        for _ in range(n_info):
            key = c.typed_scalar_int()
            t, vals = c.typed_value()
            info[self._name(key)] = _render_info_value(t, vals)
        # ---- indiv block (FORMAT columns) -------------------------------
        c.o = l_shared
        fmt_keys: list[str] = []
        cols: list[list[str]] = [[] for _ in range(n_sample)]
        for _ in range(n_fmt):
            key = self._name(c.typed_scalar_int())
            t, n = c.typed_desc()
            per = n  # values per sample
            fmt_keys.append(key)
            for s in range(n_sample):
                if t == 7:
                    raw = c.buf[c.o : c.o + per].decode("latin-1")
                    c.o += per
                    cols[s].append(raw.rstrip("\0") or ".")
                    continue
                # floats as uint32 bit patterns (as typed_value): the
                # missing/EOV NaNs must stay distinguishable
                vals = list(struct.unpack_from(
                    f"<{per}{'I' if t == 5 else _FMT[t]}", c.buf, c.o))
                c.o += per * _SIZE[t]
                if key == "GT":
                    cols[s].append(_render_gt(t, vals))
                else:
                    cols[s].append(_render_info_value(t, vals) or ".")
        chrom = self._contig_names[rid] \
            if 0 <= rid < len(self._contig_names) else str(rid)
        qual = "." if qual_bits == _QUAL_MISSING else _fmt_float(
            struct.unpack("<f", struct.pack("<I", qual_bits))[0])
        return VCFRecord(
            chrom=chrom,
            pos1=pos + 1,
            id=vid if isinstance(vid, str) and vid and vid != "." else "",
            ref=alleles[0] if alleles else "",
            alts=[a for a in alleles[1:]],
            qual=qual,
            filter=filt,
            info=info,
            format=":".join(fmt_keys),
            samples=[":".join(col) for col in cols],
        )

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _split_meta(line: str) -> dict:
    """##KEY=<A=1,B="x,y"> -> {A: 1, B: x,y} (quote-aware split)."""
    body = line.strip()
    body = body[body.index("<") + 1 : body.rindex(">")]
    fields: dict[str, str] = {}
    key = ""
    val = []
    in_q = False
    k = True
    for ch in body:
        if k:
            if ch == "=":
                k = False
            else:
                key += ch
        else:
            if ch == '"':
                in_q = not in_q
            elif ch == "," and not in_q:
                fields[key] = "".join(val)
                key, val, k = "", [], True
            else:
                val.append(ch)
    if key:
        fields[key] = "".join(val)
    return fields


def is_bcf(path: str) -> bool:
    """Sniff the on-disk magic: BGZF gzip framing whose first payload
    bytes are 'BCF' (htslib hts_detect_format equivalent for our two
    legs)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(4)
        if head[:2] != b"\x1f\x8b":
            return False
        r = BGZFReader(path)
        magic = r.read(3)
        r.close()
        return magic == b"BCF"
    except Exception:
        return False
