"""RdBG (de Bruijn unitig) anchor-reference index — vectorized host builder.

Logical re-implementation of the deBGA index (built by
deBGA_release/src/index_build.c, queried through
src/PanSVgenerateVCF/deBGA_index.{hpp,cpp}) as flat NumPy arrays ready for
TPU HBM upload. NOT a file-format port: coordinates are 0-based throughout
(the reference stores 1-based positions on disk and subtracts 1 at
expand_seed, deBGA_index.cpp:235-245 — we skip the round trip).

Vectorization insight: for an index built from reference sequence (not
reads), every unitig of the repeat-aware de Bruijn graph appears as one or
more maximal runs of consecutive genome positions whose k-mers are
chain-linked (unique out-edge of u == unique in-edge of v). So unitig
discovery is run-length bookkeeping over the position array — no graph
walk:

  1. extract all k-mers + positions per contig (k-mers never span contigs);
  2. np.unique -> distinct k-mer ids; OR-accumulate in/out edge masks
     (bit 4 = contig boundary or N, the reference's `charN` edge,
     index_build.c:622/694);
  3. link(i, i+1) iff same contig, both k-mers valid, u's out-mask is
     exactly {next base} and v's in-mask is exactly {u's first base};
  4. maximal linked runs, deduped by first-kmer id, are the unitigs;
     occurrences of a unitig = all positions of its first k-mer.

Index parameters mirror the reference: k = 22 (K_T, panSVR_run.sh:36),
search k = 20 (LEN_KMER, deBGA_index.hpp:17), two-level table with a
``first_level_bases``-base bucket hash (14 in the reference,
KMER_LEN_FIRST_LEVEL, deBGA_index.cpp:7; parameterized here because
4^14 buckets is 2 GB of pointers that small anchor references don't need).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils import dna

K_T = 22            # indexed k-mer length
LEN_KMER = 20       # search k-mer length
SEED_OFFSET = K_T - LEN_KMER


@dataclass
class RdBGIndex:
    """Flat-array RdBG index. All positions 0-based; all ranges half-open."""

    k: int
    search_k: int
    first_level_bases: int

    # reference space: concatenated anchor contigs
    ref_codes: np.ndarray      # uint8 [ref_len] base codes (N kept as 4)
    ref_words: np.ndarray      # uint64 packed 2-bit (N->2 like charToDna5_N2)
    chr_names: list            # contig names (anchor metadata channel)
    chr_starts: np.ndarray     # int64 [n_chr+1] cumulative 0-based starts

    # unitig space: concatenated unitig sequences
    uni_codes: np.ndarray      # uint8 [uni_len]
    uni_words: np.ndarray      # uint64 packed
    uni_seqf: np.ndarray       # int64 [n_uni+1] unitig start offsets in uni space
    uni_pos: np.ndarray        # int64 [n_occ] 0-based unitig occurrence starts in ref space
    uni_posp: np.ndarray       # int64 [n_uni+1] per-unitig slice into uni_pos

    # two-level k-mer search table (entries sorted by full k-mer value)
    hash_g: np.ndarray         # int32 [4^FL+1] bucket start per FL-base prefix
    kmer_g: np.ndarray         # uint32 [n_kmer] low 2*(k-FL) bits of k-mer
    off_g: np.ndarray          # int64 [n_kmer] k-mer offset in unitig space

    @property
    def ref_len(self) -> int:
        return int(self.chr_starts[-1])

    @property
    def n_unitigs(self) -> int:
        return len(self.uni_seqf) - 1

    @property
    def n_kmers(self) -> int:
        return len(self.kmer_g)

    def chr_of_pos(self, pos: int) -> int:
        """Contig id containing 0-based packed position (cf. the reference's
        get_chromosome_ID, deBGA_index.cpp:370-397)."""
        return int(np.searchsorted(self.chr_starts, pos, side="right")) - 1

    def contig_seq_codes(self, cid: int) -> np.ndarray:
        return self.ref_codes[self.chr_starts[cid] : self.chr_starts[cid + 1]]


def resolve_first_level(first_level_bases, n_kmers: int) -> int:
    """'auto' -> smallest first level whose 4^fl bucket table matches the
    k-mer population (bounded to [8, 14]). The reference hard-codes 14
    (KMER_LEN_FIRST_LEVEL, deBGA_index.cpp:7) and pays a dense 4^14
    table (1+ GB) even for megabase anchor sets; sizing the level to the
    population keeps the table ~O(n_kmers) with the same two-level
    probe semantics."""
    if isinstance(first_level_bases, int):
        return first_level_bases
    fl = 8
    while fl < 14 and (1 << (2 * fl)) < n_kmers:
        fl += 1
    return fl


def build_index(
    contigs: list[tuple[str, str]],
    k: int = K_T,
    search_k: int = LEN_KMER,
    first_level_bases: int | str = "auto",
    spill_threshold: int = 32_000_000,
    spill_dir: str | None = None,
) -> RdBGIndex:
    """Build the RdBG index from (name, sequence) anchor contigs.

    Memory-bounded. Small builds group k-mers with one stable in-RAM
    sort (replacing np.unique + a second per-occurrence argsort, with
    int32 transients and aggressive frees). Past `spill_threshold`
    k-mer rows, grouping goes external-memory the way the reference
    deBGA bounds its pass-1 (256 prefix-bucket spill files, per-bucket
    sort — index_build.c:411-1013): each k-mer is written once to its
    top-8-bit bucket file as a 12-byte (key, row) record with the
    prev/next-base edge codes packed above the 2k value bits, then each
    bucket is loaded, sorted, and reduced independently. Measured
    (tools/measure_index_memory.py): 24 Mbp anchors 0.9 GB peak vs the
    reference's 2.3 GB; 100 Mbp anchors stay under 4 GB.
    """
    names = [n for n, _ in contigs]
    lengths = np.array([len(s) for _, s in contigs], dtype=np.int64)
    chr_starts = np.zeros(len(contigs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=chr_starts[1:])

    ref_codes = (
        np.concatenate([dna.encode(s) for _, s in contigs])
        if contigs else np.empty(0, dtype=np.uint8)
    )
    # packing maps N->2 ('G'), matching charToDna5_N2 (bit_operation.c:30-38)
    ref_words = dna.pack_2bit(np.where(ref_codes >= 4, np.uint8(2), ref_codes))

    n_per = np.maximum(lengths - (k - 1), 0)
    row_starts = np.zeros(len(contigs) + 1, dtype=np.int64)
    np.cumsum(n_per, out=row_starts[1:])
    total = int(row_starts[-1])
    if total == 0:
        return _empty_index(names, chr_starts, ref_codes, ref_words,
                            k, search_k, first_level_bases)

    # positions fit int32 whenever the packed reference does (anchor sets
    # are < 2 Gbp by construction; fall back to int64 defensively)
    pos_dt = np.int32 if chr_starts[-1] < 2**31 - 1 else np.int64
    # k-mer row -> 0-based genome position (rows are per-contig arange)
    pos_shift = chr_starts[:-1] - row_starts[:-1]

    def row2pos(rows):
        cid = np.searchsorted(row_starts, rows, side="right") - 1
        return (rows + pos_shift[cid]).astype(pos_dt)

    nxt = np.empty(total, dtype=np.uint8)    # base after the k-mer (4 = edge)
    # the grouping passes ALSO build the two-level search table and free
    # the distinct-k-mer array before returning: at whole-genome scale
    # uniq (8 B/distinct k-mer) must not coexist with the unitig phase +
    # the 4^fl bucket table (the round-4 fl=14/100 Mbp build peaked at
    # 4.58 GB exactly that way)
    if total > spill_threshold and k <= 29:  # 2k+6 packed bits must fit 64
        grouped = _group_kmers_spill(
            contigs, ref_codes, k, n_per, row_starts, chr_starts,
            nxt, row2pos, pos_dt, spill_dir, first_level_bases)
    else:
        grouped = _group_kmers_ram(
            contigs, ref_codes, k, n_per, row_starts, chr_starts,
            nxt, row2pos, pos_dt, first_level_bases)
    if grouped is None:                      # every k-mer spans an N
        return _empty_index(names, chr_starts, ref_codes, ref_words,
                            k, search_k, first_level_bases)
    (kid, grp_start, occ_pos, in_mask, out_mask, n_valid,
     n_uniq, first_base, kmer_g, hash_g, fl) = grouped

    # park a BIG two-level table on disk through the unitig phase: at
    # whole-genome scale hash_g+kmer_g are ~1.3 GB that nothing below
    # reads until the final assembly; they come back as read-only
    # memmaps (of unlinked temp files, so nothing leaks)
    tab_spill = None
    if hash_g.nbytes + kmer_g.nbytes > (256 << 20):
        import tempfile

        tab_spill = tempfile.mkdtemp(prefix="rdbg_tab_", dir=spill_dir)
        np.save(os.path.join(tab_spill, "hash_g.npy"), hash_g)
        np.save(os.path.join(tab_spill, "kmer_g.npy"), kmer_g)
        hash_g = kmer_g = None

    single_bit = np.array([bin(m).count("1") == 1 and m < 16 for m in range(32)])
    out_single = single_bit[out_mask]
    in_single = single_bit[in_mask]

    # --- link(i, i+1) over genome positions ------------------------------
    # consecutive rows are consecutive genome positions except across
    # contig boundaries (row_starts marks each contig's first row);
    # chunked so the int64 gather temporaries stay bounded at scale
    linked = np.zeros(total, dtype=bool)
    contig_last = row_starts[1:-1] - 1               # last row per contig
    contig_last = contig_last[contig_last >= 0]
    for st in range(0, total - 1, _CHUNK):
        en = min(st + _CHUNK, total - 1)
        a = kid[st:en]
        b = kid[st + 1 : en + 1]
        cand = (a >= 0) & (b >= 0)
        lo = np.searchsorted(contig_last, st)
        hi = np.searchsorted(contig_last, en)
        cand[contig_last[lo:hi] - st] = False
        ai = a[cand]
        bi = b[cand]
        ok = (
            out_single[ai]
            & (out_mask[ai] == (np.uint8(1) << nxt[st:en][cand]))
            & in_single[bi]
            & (in_mask[bi] == (np.uint8(1) << first_base[ai]))
        )
        linked[st:en][cand] = ok
    del nxt

    # --- maximal runs, deduped by first-kmer id --------------------------
    # run start at i iff valid[i] (kid >= 0) and (i==0 or not linked[i-1])
    run_start = kid >= 0
    run_start[1:] &= ~linked[:-1]
    starts_idx = np.nonzero(run_start)[0]
    # run length: next run start (or end) after each start
    boundaries = np.nonzero(~np.concatenate([linked, [False]]))[0]
    run_end_idx = boundaries[np.searchsorted(boundaries, starts_idx)]
    run_nk = run_end_idx - starts_idx + 1          # kmers in each run
    del run_start, boundaries, run_end_idx, linked

    first_kid = kid[starts_idx]
    # dedupe runs by first-kmer id -> unitigs (keep first occurrence)
    order_r = np.argsort(first_kid, kind="stable")
    fk_sorted = first_kid[order_r]
    is_rep = np.ones(len(order_r), dtype=bool)
    is_rep[1:] = fk_sorted[1:] != fk_sorted[:-1]
    rep_runs = order_r[is_rep]                     # representative run per unitig
    rep_runs = rep_runs[np.argsort(starts_idx[rep_runs], kind="stable")]
    n_uni = len(rep_runs)

    uni_first_kid = first_kid[rep_runs]
    uni_nk = run_nk[rep_runs]
    uni_len = uni_nk + k - 1
    uni_seqf = np.zeros(n_uni + 1, dtype=np.int64)
    np.cumsum(uni_len, out=uni_seqf[1:])

    # unitig sequences from genome slices: read uni_len bases from the
    # representative run's OWN start (another occurrence of the first
    # k-mer may sit mid-run near a contig end, where the slice would
    # cross into the next contig)
    rep_pos = row2pos(starts_idx[rep_runs]).astype(np.int64)
    uni_codes = np.empty(int(uni_seqf[-1]), dtype=np.uint8)
    for lo, hi in _segment_blocks(uni_len, _CHUNK_SEG):
        rows = np.repeat(rep_pos[lo:hi], uni_len[lo:hi]) + _ranges(uni_len[lo:hi])
        uni_codes[uni_seqf[lo] : uni_seqf[hi]] = ref_codes[rows]
    uni_words = dna.pack_2bit(np.where(uni_codes >= 4, np.uint8(2), uni_codes))

    # --- kmer -> offset in unitig space ----------------------------------
    # kmers of representative run i at chain offsets 0..uni_nk[i]-1
    # (int32 when the unitig space fits — a whole-genome index saves
    # 4 B per distinct k-mer; the device table is int32 regardless)
    off_dt = np.int32 if int(uni_seqf[-1]) < 2**31 - 1 else np.int64
    off_g = np.empty(n_uniq, dtype=off_dt)
    rep_rows = starts_idx[rep_runs]
    for lo, hi in _segment_blocks(uni_nk, _CHUNK_SEG):
        rows = np.repeat(rep_rows[lo:hi], uni_nk[lo:hi]) + _ranges(uni_nk[lo:hi])
        offs = (np.repeat(uni_seqf[lo:hi], uni_nk[lo:hi])
                + _ranges(uni_nk[lo:hi]))
        off_g[kid[rows]] = offs
    del rep_rows, starts_idx, first_kid, run_nk, kid

    # --- unitig occurrences = positions of first kmer --------------------
    km_start = np.concatenate(
        [grp_start, np.array([n_valid], dtype=grp_start.dtype)])
    del grp_start
    occ_counts = (km_start[uni_first_kid + 1]
                  - km_start[uni_first_kid]).astype(np.int64)
    uni_posp = np.zeros(n_uni + 1, dtype=np.int64)
    np.cumsum(occ_counts, out=uni_posp[1:])
    uni_pos = np.empty(int(uni_posp[-1]), dtype=np.int64)
    occ_first = km_start[uni_first_kid].astype(np.int64)
    for lo, hi in _segment_blocks(occ_counts, _CHUNK_SEG):
        take = (np.repeat(occ_first[lo:hi], occ_counts[lo:hi])
                + _ranges(occ_counts[lo:hi]))
        uni_pos[uni_posp[lo] : uni_posp[hi]] = occ_pos[take]
    del occ_pos, km_start, occ_first

    if tab_spill is not None:
        import shutil

        hash_g = np.load(os.path.join(tab_spill, "hash_g.npy"),
                         mmap_mode="r")
        kmer_g = np.load(os.path.join(tab_spill, "kmer_g.npy"),
                         mmap_mode="r")
        # unlink now; the open memmap fds keep the data reachable
        shutil.rmtree(tab_spill, ignore_errors=True)
    return RdBGIndex(
        k=k, search_k=search_k, first_level_bases=fl,
        ref_codes=ref_codes, ref_words=ref_words,
        chr_names=names, chr_starts=chr_starts,
        uni_codes=uni_codes, uni_words=uni_words,
        uni_seqf=uni_seqf, uni_pos=uni_pos, uni_posp=uni_posp,
        hash_g=hash_g, kmer_g=kmer_g, off_g=off_g,
    )


_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
_CHUNK = 1 << 24      # rows per downstream chunk (bounds int64 temporaries)
_CHUNK_SEG = 1 << 22  # rows per segment-expansion block (3-4 int64
                      # temporaries each -> ~100 MB instead of ~400)


def _shifted_u8(arr_u64, shift_bits):
    """(arr >> shift).astype(uint8) without a full-size uint64 temp."""
    out = np.empty(len(arr_u64), dtype=np.uint8)
    sh = np.uint64(shift_bits)
    for st in range(0, max(len(arr_u64), 1), _CHUNK):
        np.copyto(out[st : st + _CHUNK], arr_u64[st : st + _CHUNK] >> sh,
                  casting="unsafe")
    return out


def _segment_blocks(counts, chunk):
    """Yield (lo, hi) index blocks over `counts` whose totals stay under
    `chunk` (always at least one segment per block)."""
    cum = np.cumsum(counts)
    lo = 0
    n = len(counts)
    while lo < n:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(np.searchsorted(cum, base + chunk, side="right"))
        hi = max(hi, lo + 1)
        yield lo, hi
        lo = hi


def _extract_contig(ref_codes, chr_starts, k, cid, n, nxt, r0):
    """k-mer values + prev codes for one contig; writes nxt in place."""
    codes = ref_codes[chr_starts[cid] : chr_starts[cid + 1]]
    vals = dna.kmer_codes(codes, k)
    prev = np.empty(n, dtype=np.uint8)
    prev[0] = 4
    np.minimum(codes[: n - 1], 4, out=prev[1:])
    nxt[r0 + n - 1] = 4
    np.minimum(codes[k:], 4, out=nxt[r0 : r0 + n - 1])
    return vals, prev


def _table_from_uniq(uniq, k, fl):
    """(kmer_g, hash_g, first_base) from the sorted distinct k-mers."""
    n_uniq = len(uniq)
    low_bits = np.uint64(2 * (k - fl))
    mask = (np.uint64(1) << low_bits) - np.uint64(1)
    kmer_g = np.empty(n_uniq, dtype=np.uint32)
    for st in range(0, max(n_uniq, 1), _CHUNK):
        np.copyto(kmer_g[st : st + _CHUNK], uniq[st : st + _CHUNK] & mask,
                  casting="unsafe")
    nb = (1 << (2 * fl)) + 1
    hash_g = np.empty(nb, np.int32)
    for st in range(0, nb, _CHUNK):
        en = min(st + _CHUNK, nb)
        qs = np.arange(st, en, dtype=np.uint64) << low_bits
        hash_g[st:en] = np.searchsorted(uniq, qs)
    first_base = _shifted_u8(uniq, 2 * (k - 1))
    return kmer_g, hash_g, first_base


def _group_kmers_ram(contigs, ref_codes, k, n_per, row_starts, chr_starts,
                     nxt, row2pos, pos_dt, first_level_bases):
    """One stable sort of all k-mer values -> (kid, grp_start, occ_pos,
    in_mask, out_mask, n_valid, n_uniq, first_base, kmer_g, hash_g, fl).
    The all-ones sentinel (N-containing k-mers) sorts to the tail, so
    the valid prefix of the sorted stream is exactly vals != sentinel.
    The two-level search table is built here, while the distinct-k-mer
    array exists anyway, and uniq is freed before returning — at
    whole-genome scale it is 8 B per distinct k-mer that would
    otherwise coexist with the 4^fl bucket table."""
    total = int(row_starts[-1])
    vals = np.empty(total, dtype=np.uint64)
    prev = np.empty(total, dtype=np.uint8)   # base before the k-mer (4 = edge)
    for cid in range(len(contigs)):
        n = int(n_per[cid])
        if n == 0:
            continue
        r0 = int(row_starts[cid])
        vals[r0 : r0 + n], prev[r0 : r0 + n] = _extract_contig(
            ref_codes, chr_starts, k, cid, n, nxt, r0)

    order = np.argsort(vals, kind="stable")
    svals = vals[order]
    del vals
    n_valid = int(np.searchsorted(svals, _SENTINEL))
    if n_valid == 0:
        return None
    order_v = order[:n_valid]
    new_grp = np.empty(n_valid, dtype=bool)
    new_grp[0] = True
    np.not_equal(svals[1:n_valid], svals[: n_valid - 1], out=new_grp[1:])
    uniq = svals[:n_valid][new_grp]
    del svals
    grp_start = np.flatnonzero(new_grp)            # [n_uniq] first sorted row
    kid = np.full(total, -1, dtype=np.int32)
    uid_sorted = np.cumsum(new_grp, dtype=np.int32)
    uid_sorted -= 1
    kid[order_v] = uid_sorted
    del uid_sorted, new_grp

    # edge masks (bit 4 = boundary/N edge): segment-OR over sorted groups
    in_mask = np.bitwise_or.reduceat(np.uint8(1) << prev[order_v], grp_start)
    out_mask = np.bitwise_or.reduceat(np.uint8(1) << nxt[order_v], grp_start)
    occ_pos = row2pos(order_v)                     # occurrences by kmer, stable
    n_uniq = len(uniq)
    fl = resolve_first_level(first_level_bases, n_uniq)
    kmer_g, hash_g, first_base = _table_from_uniq(uniq, k, fl)
    del uniq
    return (kid, grp_start, occ_pos, in_mask, out_mask, n_valid,
            n_uniq, first_base, kmer_g, hash_g, fl)


def _group_kmers_spill(contigs, ref_codes, k, n_per, row_starts, chr_starts,
                       nxt, row2pos, pos_dt, spill_dir, first_level_bases):
    """External-memory grouping: spill each valid k-mer once as a
    12-byte (key, row) record into one of 256 files keyed by the top 8
    bits of its 2k-bit value (the reference deBGA's prefix buckets,
    index_build.c:411-1013), then sort + reduce each bucket alone. The
    prev/next edge codes ride in key bits [2k, 2k+3) / [2k+3, 2k+6).
    Spill order is ascending global row, so a stable per-bucket sort
    keeps occurrence lists in original position order."""
    import shutil
    import tempfile

    total = int(row_starts[-1])
    assert total < 2**32, "row ids are spilled as uint32"
    val_bits = np.uint64(2 * k)
    val_mask = (np.uint64(1) << val_bits) - np.uint64(1)
    bucket_shift = np.uint64(2 * k - 8)
    rec_dt = np.dtype([("key", "<u8"), ("row", "<u4")])

    tmpdir = tempfile.mkdtemp(prefix="rdbg_spill_",
                              dir=spill_dir or tempfile.gettempdir())
    try:
        files = [open(os.path.join(tmpdir, f"b{b:03d}.bin"), "wb")
                 for b in range(256)]
        buf_key, buf_row, buffered = [], [], 0

        def flush():
            nonlocal buffered
            if not buf_key:
                return
            key = np.concatenate(buf_key)
            row = np.concatenate(buf_row)
            buf_key.clear()
            buf_row.clear()
            buffered = 0
            bucket = ((key >> bucket_shift) & np.uint64(0xFF)).astype(np.uint8)
            order = np.argsort(bucket, kind="stable")
            rec = np.empty(len(key), dtype=rec_dt)
            rec["key"] = key[order]
            rec["row"] = row[order]
            ends = np.cumsum(np.bincount(bucket, minlength=256))
            st = 0
            for b in range(256):
                e = int(ends[b])
                if e > st:
                    files[b].write(rec[st:e].tobytes())
                st = e

        for cid in range(len(contigs)):
            n = int(n_per[cid])
            if n == 0:
                continue
            r0 = int(row_starts[cid])
            vals, prev = _extract_contig(
                ref_codes, chr_starts, k, cid, n, nxt, r0)
            valid = vals != _SENTINEL
            key = (vals | (prev.astype(np.uint64) << val_bits)
                   | (nxt[r0 : r0 + n].astype(np.uint64) << (val_bits + np.uint64(3))))
            buf_key.append(key[valid])
            buf_row.append((np.flatnonzero(valid) + r0).astype(np.uint32))
            buffered += len(buf_key[-1])
            if buffered >= 4_000_000:
                flush()
        flush()
        for fh in files:
            fh.close()

        n_valid = sum(os.path.getsize(fh.name) for fh in files) // rec_dt.itemsize
        if n_valid == 0:
            return None
        # the first level resolves from n_valid (an upper bound of the
        # distinct count — the exact count is only known after the
        # bucket sweep, but the table must allocate before it); explicit
        # fl values pass through unchanged
        fl = resolve_first_level(first_level_bases, n_valid)
        low_bits = np.uint64(2 * (k - fl))
        nb = (1 << (2 * fl)) + 1
        hash_g = np.empty(nb, np.int32)
        cells_per_bucket = (nb - 1) >> 8   # fl >= 4: cells nest in buckets
        kmer_mask = (np.uint64(1) << low_bits) - np.uint64(1)
        kid = np.full(total, -1, dtype=np.int32)
        occ_pos = np.empty(n_valid, dtype=pos_dt)
        grp_l, in_l, out_l, kmer_l, fb_l = [], [], [], [], []
        occ_base = 0
        uid_base = np.int32(0)
        for b in range(256):
            path = os.path.join(tmpdir, f"b{b:03d}.bin")
            rec = np.fromfile(path, dtype=rec_dt)
            os.unlink(path)
            c_lo, c_hi = b * cells_per_bucket, (b + 1) * cells_per_bucket
            if len(rec) == 0:
                hash_g[c_lo:c_hi] = uid_base
                continue
            val = rec["key"] & val_mask
            order = np.argsort(val, kind="stable")
            sval = val[order]
            skey = rec["key"][order]
            srow = rec["row"][order].astype(np.int64)
            del rec, val
            ng = np.empty(len(sval), dtype=bool)
            ng[0] = True
            np.not_equal(sval[1:], sval[:-1], out=ng[1:])
            gs = np.flatnonzero(ng)
            u = sval[ng]
            # this bucket's slice of the two-level table: top 2*fl bits
            # of every key here fall in [c_lo, c_hi) because the spill
            # bucket is the top 8 bits (fl >= 4)
            kmer_l.append((u & kmer_mask).astype(np.uint32))
            fb_l.append(_shifted_u8(u, 2 * (k - 1)))
            qs = (np.arange(c_lo, c_hi, dtype=np.uint64) << low_bits)
            hash_g[c_lo:c_hi] = uid_base + np.searchsorted(u, qs)
            del u
            grp_l.append((gs + occ_base).astype(
                np.int32 if total < 2**31 else np.int64))
            prev_bits = ((skey >> val_bits) & np.uint64(7)).astype(np.uint8)
            nxt_bits = ((skey >> (val_bits + np.uint64(3)))
                        & np.uint64(7)).astype(np.uint8)
            in_l.append(np.bitwise_or.reduceat(np.uint8(1) << prev_bits, gs))
            out_l.append(np.bitwise_or.reduceat(np.uint8(1) << nxt_bits, gs))
            uid = np.cumsum(ng, dtype=np.int32)
            uid += uid_base - np.int32(1)
            kid[srow] = uid
            occ_pos[occ_base : occ_base + len(srow)] = row2pos(srow)
            uid_base += np.int32(len(gs))
            occ_base += len(srow)
        hash_g[-1] = uid_base
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    return (kid, np.concatenate(grp_l), occ_pos,
            np.concatenate(in_l), np.concatenate(out_l), n_valid,
            int(uid_base), np.concatenate(fb_l), np.concatenate(kmer_l),
            hash_g, fl)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(c) for c in counts]) without the loop."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def _empty_index(names, chr_starts, ref_codes, ref_words, k, search_k, fl):
    fl = resolve_first_level(fl, 0)
    return RdBGIndex(
        k=k, search_k=search_k, first_level_bases=fl,
        ref_codes=ref_codes, ref_words=ref_words,
        chr_names=names, chr_starts=chr_starts,
        uni_codes=np.empty(0, dtype=np.uint8),
        uni_words=np.empty(0, dtype=np.uint64),
        uni_seqf=np.zeros(1, dtype=np.int64),
        uni_pos=np.empty(0, dtype=np.int64),
        uni_posp=np.zeros(1, dtype=np.int64),
        hash_g=np.zeros((1 << (2 * fl)) + 1, dtype=np.int32),
        kmer_g=np.empty(0, dtype=np.uint32),
        off_g=np.empty(0, dtype=np.int64),
    )
