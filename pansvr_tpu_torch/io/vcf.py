"""Plain-text VCF reading/writing (htslib-free).

Replaces the reference's clib/vcf_file.{h,c} wrapper over htslib. Only the
surface the pipeline uses is implemented: record iteration, INFO-tag lookup
(SVTYPE, END, SVLEN, SAMPLE — vcf_file.c:67-93), alleles, and rlen semantics.

rlen semantics mirror htslib-1.9 vcf.c: rlen = len(REF), overridden to
END - pos0 when an INFO/END is present (END is 1-based inclusive, pos0 is
0-based, so rlen = END - POS + 1 in 1-based terms).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field
from typing import Iterator


@dataclass
class VCFRecord:
    chrom: str
    pos1: int              # 1-based POS as written in the file
    id: str
    ref: str
    alts: list[str]
    qual: str
    filter: str
    info: dict[str, str | bool] = field(default_factory=dict)
    format: str = ""
    samples: list[str] = field(default_factory=list)

    @property
    def pos0(self) -> int:
        return self.pos1 - 1

    @property
    def rlen(self) -> int:
        """htslib rlen: END-pos0 when INFO/END exists, else len(REF)."""
        end = self.info.get("END")
        if end is not None and end is not True:
            try:
                return int(end) - self.pos0
            except ValueError:
                pass
        return len(self.ref)

    def info_str(self, key: str) -> str | None:
        v = self.info.get(key)
        if v is None or v is True:
            return None
        return str(v)

    def info_int(self, key: str) -> int | None:
        v = self.info_str(key)
        if v is None:
            return None
        try:
            return int(v.split(",")[0])
        except ValueError:
            return None

    @property
    def sv_type(self) -> str | None:
        return self.info_str("SVTYPE")

    @property
    def sv_len(self) -> int | None:
        return self.info_int("SVLEN")

    @property
    def sample_tag(self) -> str | None:
        """INFO 'SAMPLE=' tag used by the anchor-ref sample filter
        (vcf_file.c:67-71, get_anchor_ref.hpp:286)."""
        return self.info_str("SAMPLE")

    def to_line(self) -> str:
        info = ";".join(
            k if v is True else f"{k}={v}" for k, v in self.info.items()
        ) or "."
        cols = [
            self.chrom,
            str(self.pos1),
            self.id or ".",
            self.ref,
            ",".join(self.alts) if self.alts else ".",
            self.qual or ".",
            self.filter or ".",
            info,
        ]
        if self.format:
            cols.append(self.format)
            cols.extend(self.samples)
        return "\t".join(cols)


def _parse_info(s: str) -> dict:
    d: dict[str, str | bool] = {}
    if s == "." or not s:
        return d
    for item in s.split(";"):
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            d[k] = v
        else:
            d[item] = True
    return d


def parse_vcf_line(line: str) -> VCFRecord:
    cols = line.rstrip("\n").split("\t")
    alts = [] if cols[4] in (".", "") else cols[4].split(",")
    return VCFRecord(
        chrom=cols[0],
        pos1=int(cols[1]),
        id="" if cols[2] == "." else cols[2],
        ref=cols[3],
        alts=alts,
        qual=cols[5] if len(cols) > 5 else ".",
        filter=cols[6] if len(cols) > 6 else ".",
        info=_parse_info(cols[7]) if len(cols) > 7 else {},
        format=cols[8] if len(cols) > 8 else "",
        samples=cols[9:] if len(cols) > 9 else [],
    )


class VCFReader:
    """Text VCF / VCF.gz / binary BCF reader — the same three input
    legs htslib's unified reader gives the reference
    (src/clib/vcf_file.h:25-36); binary records decode via io.bcf."""

    def __init__(self, path: str):
        self.path = path
        self._bcf = None
        if path.endswith(".bcf"):
            from .bcf import BCFReader

            self._bcf = BCFReader(path)
            self._fh = None
            self.header_lines = self._bcf.header_lines
            self.contigs = self._bcf.contigs
            self._first_record = None
            return
        if path.endswith(".gz"):
            from .bcf import is_bcf

            if is_bcf(path):
                from .bcf import BCFReader

                self._bcf = BCFReader(path)
                self._fh = None
                self.header_lines = self._bcf.header_lines
                self.contigs = self._bcf.contigs
                self._first_record = None
                return
            self._fh = io.TextIOWrapper(gzip.open(path, "rb"))
        else:
            self._fh = open(path)
        self.header_lines: list[str] = []
        self.contigs: list[tuple[str, int]] = []
        self._first_record: str | None = None
        for line in self._fh:
            if line.startswith("#"):
                self.header_lines.append(line.rstrip("\n"))
                if line.startswith("##contig="):
                    self._parse_contig(line)
            else:
                self._first_record = line
                break

    def _parse_contig(self, line: str) -> None:
        body = line.strip()[len("##contig=<") : -1]
        fields = dict(kv.split("=", 1) for kv in body.split(",") if "=" in kv)
        if "ID" in fields:
            self.contigs.append((fields["ID"], int(fields.get("length", 0))))

    def __iter__(self) -> Iterator[VCFRecord]:
        if self._bcf is not None:
            yield from self._bcf
            return
        if self._first_record is not None:
            yield parse_vcf_line(self._first_record)
            self._first_record = None
        for line in self._fh:
            if line.strip():
                yield parse_vcf_line(line)

    def close(self):
        if self._bcf is not None:
            self._bcf.close()
        else:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class VCFWriter:
    def __init__(self, path_or_fh, header_lines: list[str]):
        self._own = isinstance(path_or_fh, str)
        self._fh = open(path_or_fh, "w") if self._own else path_or_fh
        for line in header_lines:
            self._fh.write(line.rstrip("\n") + "\n")

    def write(self, rec: VCFRecord) -> None:
        self._fh.write(rec.to_line() + "\n")

    def write_line(self, line: str) -> None:
        self._fh.write(line.rstrip("\n") + "\n")

    def close(self):
        if self._own:
            self._fh.close()


def minimal_header(contigs: list[tuple[str, int]], source: str = "pansvr_tpu") -> list[str]:
    lines = ["##fileformat=VCFv4.2", f"##source={source}"]
    for name, length in contigs:
        lines.append(f"##contig=<ID={name},length={length}>")
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
    return lines
