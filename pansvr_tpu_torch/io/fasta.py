"""FASTA reading/writing with .fai-style random access.

Replaces the reference's use of htslib faidx (fai_load/fai_fetch,
get_anchor_ref.hpp:138,289). Supports plain and gzip/BGZF-compressed files
for streaming reads; random access (Faidx) requires uncompressed FASTA.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fasta(path: str) -> dict[str, str]:
    """Load a whole FASTA into {name: sequence}. Name is the first word."""
    seqs: dict[str, str] = {}
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def iter_fasta(path: str) -> Iterator[tuple[str, str]]:
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def write_fasta(path_or_fh, records, width: int = 70) -> None:
    """Write (name, seq) records, wrapping at ``width`` columns (the
    reference emits 70-column FASTA, get_anchor_ref.hpp FA_string_BUFF)."""
    own = isinstance(path_or_fh, (str, os.PathLike))
    fh = open(path_or_fh, "w") if own else path_or_fh
    try:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width])
                fh.write("\n")
            if len(seq) == 0:
                fh.write("\n")
    finally:
        if own:
            fh.close()


class Faidx:
    """Random-access FASTA via a .fai index (built on the fly if missing).

    fetch() uses 0-based half-open coordinates (we do NOT reproduce the
    htslib 1-based region-string interface; callers do their own coordinate
    arithmetic — see anchor/builder.py for where the reference's
    region-string off-by-one is reproduced explicitly).
    """

    def __init__(self, path: str):
        if path.endswith(".gz"):
            raise ValueError("Faidx requires uncompressed FASTA")
        self.path = path
        self._fh = open(path, "rb")
        fai = path + ".fai"
        if os.path.exists(fai):
            self._index = self._load_fai(fai)
        else:
            self._index = self._build_index()
            try:
                self._write_fai(fai)
            except OSError:
                pass
        self.names = list(self._index.keys())

    @staticmethod
    def _load_fai(fai_path: str) -> dict:
        idx = {}
        with open(fai_path) as fh:
            for line in fh:
                name, length, offset, linebases, linewidth = line.split("\t")[:5]
                idx[name] = (int(length), int(offset), int(linebases), int(linewidth))
        return idx

    def _build_index(self) -> dict:
        idx = {}
        self._fh.seek(0)
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        pos = 0
        for raw in self._fh:
            if raw.startswith(b">"):
                if name is not None:
                    idx[name] = (length, offset, linebases, linewidth)
                name = raw[1:].split()[0].decode()
                length = 0
                offset = pos + len(raw)
                linebases = 0
                linewidth = 0
            else:
                stripped = raw.rstrip(b"\r\n")
                if linebases == 0 and stripped:
                    linebases = len(stripped)
                    linewidth = len(raw)
                length += len(stripped)
            pos += len(raw)
        if name is not None:
            idx[name] = (length, offset, linebases, linewidth)
        return idx

    def _write_fai(self, fai_path: str) -> None:
        with open(fai_path, "w") as fh:
            for name, (length, offset, lb, lw) in self._index.items():
                fh.write(f"{name}\t{length}\t{offset}\t{lb}\t{lw}\n")

    def seq_len(self, name: str) -> int:
        return self._index[name][0]

    def fetch(self, name: str, start: int, end: int) -> str:
        """0-based half-open fetch, clamped to [0, seq_len]."""
        length, offset, lb, lw = self._index[name]
        start = max(0, min(start, length))
        end = max(start, min(end, length))
        if end == start:
            return ""
        byte_start = offset + (start // lb) * lw + (start % lb)
        byte_end = offset + ((end - 1) // lb) * lw + ((end - 1) % lb) + 1
        self._fh.seek(byte_start)
        raw = self._fh.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self):
        self._fh.close()
