"""Format-dispatching reader for alignment files (BAM or CRAM).

The reference's read path accepts either container through one handle
(`panSVR src/clib/bam_file.h:16-259` via htslib `hts_open`);
this is that dispatch for the TPU pipeline: sniff the magic, return the
matching reader. CRAM needs the reference genome to reconstruct mapped
sequences (pass `ref=`: a Faidx or {name: seq} dict)."""

from __future__ import annotations

import gzip

from .bam import BamReader
from .cram import CRAM_MAGIC, CramReader


def open_alignment(path: str, ref=None):
    """BamReader or CramReader by magic bytes."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == CRAM_MAGIC:
        return CramReader(path, ref=ref)
    return BamReader(path)


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == CRAM_MAGIC
