"""Host-side (NumPy) query oracle over RdBGIndex.

Frozen copy of pansvr_tpu_torch/index/query.py (imports made local) for the
benchmark's plain reference.

Mirrors the query engine of src/PanSVgenerateVCF/deBGA_index.cpp —
search_kmer (:84-101), UNITIG_MEM_search (:105-146),
merge_seed_in_unipath (:151-217), expand_seed (:219-251) — in readable
scalar/NumPy form. This is the correctness reference for the batched JAX
device implementation in pansvr_tpu.ops.seeding; the device path is tested
against this oracle.

Constants (deBGA_index.cpp:3-5, read_realignment.hpp:29):
  POS_N_MAX        500   occurrences above this -> sample RANDOM_NUM
  POS_N_MAX_LEVEL2 8000  occurrences above this -> abort expansion entirely
  RANDOM_NUM       500
  UNI_POS_N_MAX    32    k-mer entries above this -> skip seed (realigner)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index_builder import RdBGIndex

POS_N_MAX = 500
POS_N_MAX_LEVEL2 = 8000
RANDOM_NUM = 500
WAITING_LEN = 3     # merge: max read-gap between MEMs (deBGA_index.cpp:148)
EINDEL = 1          # merge: |indel| must be < this, i.e. 0 (deBGA_index.cpp:149)


@dataclass
class MEM:
    """vertex_MEM (deBGA_index.hpp:23-38)."""
    uid: int           # unitig id
    read_pos: int      # MEM start in read (0-based)
    uni_pos_off: int   # MEM start offset within the unitig
    length: int        # MEM length in bases
    pos_n: int         # number of reference occurrences of the unitig


@dataclass
class MergedSeed:
    """vertex_U (deBGA_index.hpp:57-72)."""
    uid: int
    read_pos: int
    uni_pos_off: int
    length1: int       # length in read
    length2: int       # length in unitig/reference
    pos_n: int
    cov: int


@dataclass
class RefSeed:
    """UNI_SEED (graph.hpp seed input): a seed expanded to reference space.
    All coordinates 0-based, ends inclusive (matching the reference's
    ref_begin/ref_end arithmetic after its -1 adjustment)."""
    seed_id: int
    read_begin: int
    read_end: int
    ref_begin: int
    ref_end: int
    cov: int


def kmer_value(codes: np.ndarray, start: int, k: int) -> int:
    """2-bit value of codes[start:start+k] (must be N-free)."""
    v = 0
    for c in codes[start : start + k]:
        v = (v << 2) | int(c & 3)
    return v


def search_kmer(idx: RdBGIndex, kmer20: int) -> tuple[int, int] | None:
    """20-mer lookup -> half-open [lo, hi) range of k-mer-table entries whose
    first 20 bases equal kmer20 (search_kmer + binsearch_range semantics)."""
    fl = idx.first_level_bases
    resid_bases = idx.search_k - fl
    bucket = kmer20 >> (2 * resid_bases)
    residue = kmer20 & ((1 << (2 * resid_bases)) - 1)
    lo = int(idx.hash_g[bucket])
    hi = int(idx.hash_g[bucket + 1])
    if lo >= hi:
        return None
    shift = 2 * (idx.k - idx.search_k)
    keys = idx.kmer_g[lo:hi] >> np.uint32(shift)
    left = lo + int(np.searchsorted(keys, residue, side="left"))
    right = lo + int(np.searchsorted(keys, residue, side="right"))
    if left >= right:
        return None
    return left, right


def mem_extend(
    idx: RdBGIndex, entry: int, read_codes: np.ndarray, read_off: int
) -> MEM:
    """UNITIG_MEM_search: extend k-mer-table entry ``entry`` (matching the
    read 20-mer at ``read_off``) to a maximal exact match within its unitig.

    Note the reference extends with len_k = LEN_KMER (20) even though table
    offsets address 22-mers — the right extension starts at offset
    len_k inside the k-mer, re-verifying bases 20..21 (deBGA_index.cpp:124-128).
    """
    len_k = idx.search_k
    kmer_pos_uni = int(idx.off_g[entry])
    uid = int(np.searchsorted(idx.uni_seqf, kmer_pos_uni, side="right")) - 1
    pos_n = int(idx.uni_posp[uid + 1] - idx.uni_posp[uid])
    uni_start = int(idx.uni_seqf[uid])
    uni_end = int(idx.uni_seqf[uid + 1])
    off_l = kmer_pos_uni - uni_start
    off_r = uni_end - (kmer_pos_uni + len_k)
    read_len = len(read_codes)

    left = 0
    while left < off_l and left < read_off:
        if idx.uni_codes[kmer_pos_uni - left - 1] != read_codes[read_off - left - 1]:
            break
        left += 1
    right = 0
    while right < off_r and right < read_len - read_off - len_k:
        if (
            idx.uni_codes[kmer_pos_uni + len_k + right]
            != read_codes[read_off + len_k + right]
        ):
            break
        right += 1

    return MEM(
        uid=uid,
        read_pos=read_off - left,
        uni_pos_off=off_l - left,
        length=len_k + left + right,
        pos_n=pos_n,
    )


def merge_seeds(mems: list[MEM]) -> list[MergedSeed]:
    """merge_seed_in_unipath: colinear MEMs in the same unitig, read-gap
    <= WAITING_LEN, zero indel drift, merged into one seed with coverage."""
    if not mems:
        return []
    if len(mems) == 1:
        m = mems[0]
        return [MergedSeed(m.uid, m.read_pos, m.uni_pos_off,
                           m.length, m.length, m.pos_n, m.length)]
    ms = sorted(mems, key=lambda m: (m.uid, m.read_pos))
    out: list[MergedSeed] = []
    j = 0
    n = len(ms)
    while j < n:
        s1 = j
        cov = ms[s1].length
        j += 1
        while (
            j < n
            and ms[j].uid == ms[s1].uid
            and ms[j].uni_pos_off > ms[j - 1].uni_pos_off
        ):
            diff = ms[j].read_pos - ms[j - 1].read_pos - ms[j - 1].length
            if diff > WAITING_LEN:
                break
            drift = (ms[j].uni_pos_off - ms[j - 1].uni_pos_off) - (
                ms[j].read_pos - ms[j - 1].read_pos
            )
            if abs(drift) < EINDEL:
                cov += ms[j].length if diff > 0 else diff + ms[j].length
                j += 1
            else:
                break
        e1 = j - 1
        m0 = ms[s1]
        if s1 == e1:
            l1 = l2 = m0.length
        else:
            l1 = ms[e1].read_pos + ms[e1].length - m0.read_pos
            l2 = ms[e1].uni_pos_off + ms[e1].length - m0.uni_pos_off
        out.append(MergedSeed(m0.uid, m0.read_pos, m0.uni_pos_off,
                              l1, l2, m0.pos_n, cov))
    return out


def expand_seeds(
    idx: RdBGIndex,
    merged: list[MergedSeed],
    rng: np.random.Generator | None = None,
) -> list[RefSeed]:
    """expand_seed: unitig-space seeds -> reference-space seeds.

    Reproduces the truncation rules exactly: pos_n > POS_N_MAX_LEVEL2
    aborts the WHOLE expansion (the reference `return`s mid-loop,
    deBGA_index.cpp:226 — deliberate or not, downstream counts depend on
    it); pos_n > POS_N_MAX samples RANDOM_NUM occurrences with replacement.
    """
    out: list[RefSeed] = []
    for i, v in enumerate(merged):
        if v.pos_n > POS_N_MAX:
            if v.pos_n > POS_N_MAX_LEVEL2:
                return out
            if rng is None:
                rng = np.random.default_rng(0)
            picks = rng.integers(0, v.pos_n, size=RANDOM_NUM)
        else:
            picks = range(v.pos_n)
        base = int(idx.uni_posp[v.uid])
        for m in picks:
            ref_begin = int(idx.uni_pos[base + int(m)]) + v.uni_pos_off
            out.append(
                RefSeed(
                    seed_id=i,
                    read_begin=v.read_pos,
                    read_end=v.read_pos + v.length1 - 1,
                    ref_begin=ref_begin,
                    ref_end=ref_begin + v.length2 - 1,
                    cov=v.cov,
                )
            )
    return out
