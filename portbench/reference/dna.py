"""Vectorized DNA sequence utilities (host-side, NumPy).

Frozen copy of pansvr_tpu_torch/utils/dna.py (imports made local) for the
benchmark's plain reference.

2-bit base coding follows the reference convention A=0 C=1 G=2 T=3
(ref: deBGA_release/src/bit_operation.c charToDna5 tables, and
src/PanSVgenerateVCF/read_realignment.cpp:646-654 binary_read_2_bit).
Non-ACGT characters map to code 4 ("N"); callers decide the fill policy
(the reference fills N with a random base at read-encode time,
read_realignment.cpp:649 — we use a seeded counter-based fill so runs are
reproducible).
"""

from __future__ import annotations

import numpy as np

# --- byte -> 2-bit code lookup -------------------------------------------------
_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N
_BASE_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (4 -> 'N')."""
    return _BASE_CHARS[np.minimum(codes, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


def revcomp(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


def fill_n(codes: np.ndarray, seed: int = 0) -> np.ndarray:
    """Replace code-4 (N) entries with deterministic pseudo-random bases.

    The reference uses libc rand()%4 (read_realignment.cpp:649); we use a
    position-hash so results are stable regardless of batch composition.
    """
    n_mask = codes >= 4
    if not n_mask.any():
        return codes
    idx = np.nonzero(n_mask)[0].astype(np.uint64)
    h = (idx * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed)) >> np.uint64(61)
    out = codes.copy()
    out[n_mask] = (h & np.uint64(3)).astype(np.uint8)
    return out


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes into uint64 words, 32 bases/word, MSB-first.

    Matches the deBGA on-disk packing of ref.seq / unipath.seqb
    (base b of word w holds sequence position w*32+b in bits
    [62-2b, 63-2b]; see deBGA_index.cpp:313 extraction
    ``(seq[pos>>5] >> ((31 - (pos&31)) << 1)) & 0x3``).
    """
    n = len(codes)
    n_words = (n + 31) // 32
    out = np.empty(n_words, dtype=np.uint64)
    shifts = np.uint64(2) * (np.uint64(31) - np.arange(32, dtype=np.uint64))
    # chunked: the widened uint64 scratch is 8x the input, so one flat
    # pass over a whole-genome array would cost gigabytes of transient
    step = 1 << 24                       # bases per chunk, 32-aligned
    for st in range(0, max(n, 1), step):
        blk = codes[st : st + step]
        m = len(blk)
        mw = (m + 31) // 32
        padded = np.zeros(mw * 32, dtype=np.uint64)
        np.copyto(padded[:m], blk & 3, casting="unsafe")
        out[st // 32 : st // 32 + mw] = (
            padded.reshape(mw, 32) << shifts).sum(axis=1, dtype=np.uint64)
    return out


def unpack_2bit(words: np.ndarray, start: int, length: int) -> np.ndarray:
    """Extract ``length`` 2-bit codes starting at base offset ``start``."""
    pos = start + np.arange(length, dtype=np.int64)
    w = words[pos >> 5]
    sh = (np.uint64(31) - (pos & 31).astype(np.uint64)) << np.uint64(1)
    return ((w >> sh) & np.uint64(3)).astype(np.uint8)


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-mers as uint64 values (2 bits/base, first base most
    significant). Positions containing any N yield value 2**64-1 (sentinel).

    Vectorized sliding-window encoding; len(codes) >= k required.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    vals = np.zeros(len(codes), dtype=np.uint64)
    np.copyto(vals, codes & 3, casting="unsafe")
    # prefix "polynomial" via cumulative shifting: use strided windows
    win = np.lib.stride_tricks.sliding_window_view(vals, k)  # (n, k)
    shifts = np.uint64(2) * (np.uint64(k - 1) - np.arange(k, dtype=np.uint64))
    out = (win << shifts).sum(axis=1, dtype=np.uint64)
    nwin = np.lib.stride_tricks.sliding_window_view(codes >= 4, k).any(axis=1)
    out[nwin] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return out
