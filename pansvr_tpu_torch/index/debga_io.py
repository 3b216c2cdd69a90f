"""Loader for deBGA's on-disk index directory -> RdBGIndex.

File formats per the reference loader (deBGA_index.cpp:33-80) and writer
(deBGA_release/src/index_build.c). Used for cross-validating our NumPy
builder against the real `deBGA index` binary, and as an import path for
pre-built indexes.

On-disk conventions converted here to our in-memory ones:
  - unipath.pos entries are 1-based (writer stores pos+1, index_build.c:600)
    -> subtract 1.
  - unipath.chr is (name, cumulative_end+1) line pairs
    (index_build.c:874) -> converted to 0-based chr_starts. Note the
    reference loader then clobbers chr_end_n[0] with 1
    (deBGA_index.cpp:73), corrupting the first contig's boundary; we do
    NOT reproduce that (flagged in SURVEY-level parity notes).
  - first level hash is 14 bases, entries uint64; kmer residues uint32
    holding 2*(22-14)=16 bits.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import dna
from .builder import K_T, LEN_KMER, RdBGIndex


def _read(path: str, dtype) -> np.ndarray:
    return np.fromfile(path, dtype=dtype)


def load_debga_index(index_dir: str) -> RdBGIndex:
    p = lambda fn: os.path.join(index_dir, fn)

    ref_words = _read(p("ref.seq"), np.uint64)
    uni_words = _read(p("unipath.seqb"), np.uint64)
    uni_seqf = _read(p("unipath.seqfb"), np.uint64).astype(np.int64)
    uni_pos = _read(p("unipath.pos"), np.uint64).astype(np.int64) - 1
    uni_posp = _read(p("unipath.posp"), np.uint64).astype(np.int64)
    hash_g_raw = _read(p("unipath_g.hash"), np.uint64)
    # the last entry is n_kmers; int32 device tables silently wrap past
    # 2^31 entries (plausible for whole-pangenome indexes) — fail loudly
    if len(hash_g_raw) and int(hash_g_raw[-1]) > np.iinfo(np.int32).max:
        raise ValueError(
            f"deBGA index has {int(hash_g_raw[-1])} k-mer entries, "
            "over the int32 device-table limit")
    hash_g = hash_g_raw.astype(np.int32)
    kmer_g = _read(p("unipath_g.kmer"), np.uint32)
    # NB buffer_off_g is uint64* (deBGA_index.hpp:163) though the loader's
    # size bookkeeping divides by 4; the data is 8-byte entries.
    off_g = _read(p("unipath_g.offset"), np.uint64).astype(np.int64)

    chr_names: list[str] = []
    chr_ends: list[int] = []
    with open(p("unipath.chr")) as fh:
        lines = [l.strip() for l in fh if l.strip()]
    for i in range(0, len(lines) - 1, 2):
        chr_names.append(lines[i])
        chr_ends.append(int(lines[i + 1]) - 1)  # cumulative end, 0-based

    chr_starts = np.zeros(len(chr_names) + 1, dtype=np.int64)
    chr_starts[1:] = np.array(chr_ends, dtype=np.int64)

    ref_len = int(chr_starts[-1])
    ref_codes = dna.unpack_2bit(ref_words, 0, ref_len) if ref_len else np.empty(0, np.uint8)
    uni_len = int(uni_seqf[-1]) if len(uni_seqf) else 0
    uni_codes = dna.unpack_2bit(uni_words, 0, uni_len) if uni_len else np.empty(0, np.uint8)

    # deBGA writes seqf as [0, ...ends]; posp likewise has n_uni+1 entries
    return RdBGIndex(
        k=K_T, search_k=LEN_KMER, first_level_bases=14,
        ref_codes=ref_codes, ref_words=ref_words,
        chr_names=chr_names, chr_starts=chr_starts,
        uni_codes=uni_codes, uni_words=uni_words,
        uni_seqf=uni_seqf, uni_pos=uni_pos, uni_posp=uni_posp,
        hash_g=hash_g, kmer_g=kmer_g, off_g=off_g,
    )
