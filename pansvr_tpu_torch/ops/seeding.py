"""Batched seeding on the device: k-mer probe, unitig MEM extension,
merge + reference expansion.

Port of the flat front of pansvr_tpu/ops/seeding.py (seed_reads_flat,
with its active-row compaction, and merge_expand_device3) to PyTorch. Same semantics
(read_realignment.cpp:615-644, deBGA_index.cpp search_kmer /
UNITIG_MEM_search / merge_seed_in_unipath / expand_seed): every
SEED_STEP bases the 20-mer is looked up, seeds with more than
UNI_POS_N_MAX entries are skipped, each entry is extended to a maximal
exact match inside its unitig, the sequential MEM-coverage skip masks
covered seeds, and adjacent-linked MEMs merge before expansion to
reference coordinates.

Reads are packed 16 bases per 32-bit word (MSB-first). Torch's uint32
support is partial, so every packed word is handled as an int64 holding
the unsigned value, with explicit 32-bit masks after shifts and
products.

The k-mer probe is one torch.searchsorted over the index's sorted int64
(bucket << 32 | residue) entry keys; the equal-key run length comes from
ent_run at the lower bound. It finds the same entries as both JAX probes
(the per-bucket bisect and the sort-merge join).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.device import PAD_WORDS, DeviceIndex

SEED_STEP = 5
UNI_POS_N_MAX = 32
POS_N_MAX = 500
POS_N_MAX_LEVEL2 = 8000
RANDOM_NUM = 500
WAITING_LEN = 3

FLAT_OVERFLOW = 1 << 20    # n_overflow marker for rows cut by the lane cap
BUDGET_OVERFLOW = 1 << 21  # marker for active rows beyond compact_rows

_M32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64


class SeedBatch(NamedTuple):
    """Compacted MEM output, (B, M) int32 unless noted; valid MEMs packed
    to the front of the M axis in (seed position, hit) order. Rows with
    more than M valid MEMs (or cut by the lane pool) report it in
    n_overflow and take the exact host path."""
    uid: torch.Tensor
    read_pos: torch.Tensor
    uni_pos_off: torch.Tensor
    length: torch.Tensor
    pos_n: torch.Tensor
    valid: torch.Tensor       # (B, M) bool
    n_overflow: torch.Tensor  # (B,) int32


class DeviceSeeds(NamedTuple):
    """Per-read reference seeds, (B, S) int32 / bool."""
    read_begin: torch.Tensor
    read_end: torch.Tensor
    ref_begin: torch.Tensor
    ref_end: torch.Tensor
    cov: torch.Tensor
    seed_id: torch.Tensor
    valid: torch.Tensor
    n_dropped: torch.Tensor   # (B,)


def pack_reads(codes: np.ndarray) -> np.ndarray:
    """(B, L) uint8 codes -> (B, ceil(L/16)) int32 packed words."""
    B, L = codes.shape
    Wr = (L + 15) // 16
    padded = np.zeros((B, Wr * 16), dtype=np.uint32)
    padded[:, :L] = codes & 3
    mat = padded.reshape(B, Wr, 16)
    shifts = np.uint32(2) * (np.uint32(15) - np.arange(16, dtype=np.uint32))
    return (mat << shifts).sum(axis=2, dtype=np.uint32).view(np.int32)


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 packed words -> int64 holding the unsigned 32-bit value."""
    return words.to(_I64) & _M32


def _window(hi, lo, sh):
    """32-bit window (hi << sh) | (lo >> (32 - sh)); sh == 0 takes hi."""
    lo_part = torch.where(sh == 0, 0, lo >> (32 - sh))
    return ((hi << sh) | lo_part) & _M32


def _ctz32(x):
    """Trailing zeros of nonzero 32-bit values (int64 holder)."""
    low = (x & -x).to(torch.float64)
    return (torch.frexp(low).exponent - 1).to(_I64)


def _clz32(x):
    """Leading zeros of nonzero 32-bit values (int64 holder)."""
    return (32 - torch.frexp(x.to(torch.float64)).exponent).to(_I64)


def _ext_steps(word, rwin, off, sh_l, sh_r, p0, max_left, max_right, NE):
    """Stepped MEM extension, 16 bases per compare (XOR + zero count)."""
    woff = off >> 4
    left_m = torch.zeros_like(off)
    still = torch.ones_like(off, dtype=torch.bool)
    for step in range(NE):
        wu = _window(word(woff - (step + 1)), word(woff - step), sh_l)
        x = rwin("left", step) ^ wu
        m = torch.where(x == 0, 16, _ctz32(x) >> 1)
        take = torch.where(still, torch.minimum(m, max_left - left_m), 0)
        left_m = left_m + take.clamp(min=0)
        still = still & (m >= 16) & (left_m < max_left)
    left_m = torch.minimum(left_m, max_left)

    w0r = p0 >> 4
    right_m = torch.zeros_like(off)
    still = torch.ones_like(off, dtype=torch.bool)
    for step in range(NE):
        wu = _window(word(w0r + step), word(w0r + step + 1), sh_r)
        x = rwin("right", step) ^ wu
        m = torch.where(x == 0, 16, _clz32(x) >> 1)
        take = torch.where(still, torch.minimum(m, max_right - right_m), 0)
        right_m = right_m + take.clamp(min=0)
        still = still & (m >= 16) & (right_m < max_right)
    right_m = torch.minimum(right_m, max_right)
    return left_m, right_m


def _coverage_skip(found, per_seed_max_right, sk, S0):
    """Sequential coverage skip (read_realignment.cpp:617): a seed is used
    iff its k-mer reaches past the rightmost base covered so far."""
    B = found.shape[0]
    msr = torch.zeros(B, dtype=_I64, device=found.device)
    cols = []
    for s in range(S0):
        o_s = s * SEED_STEP
        used = (o_s + sk - 1 > msr) & found[:, s]
        reach = torch.clamp(per_seed_max_right[:, s] + 1, min=1)
        msr = torch.where(used, o_s + sk + reach - 1, msr)
        cols.append(used)
    return torch.stack(cols, dim=1)


def seed_reads_flat(didx: DeviceIndex, read_words: torch.Tensor,
                    read_lens: torch.Tensor, seed_mask: torch.Tensor,
                    S0: int, n_ext_steps: int = 10, M: int = 32,
                    nf_mult: int = 10, compact_rows: int = 0):
    """read_words (B, Wr) int32 packed, read_lens (B,), seed_mask (B, S0)
    bool (STR whitelist). Hits of the whole batch are compacted onto one
    flat lane axis of nf_mult * B lanes; rows whose hits do not fit are
    flagged FLAT_OVERFLOW (host path), rows over M hits report the excess.

    compact_rows R > 0: after the probe, the rows with any k-mer hit move
    onto R slots in row order and every later stage (and the caller's
    merge and chain) runs at R rows instead of B. Returns (SeedBatch of R
    rows, rid (R,) int32 source row per slot (B = empty slot),
    over_budget (B,) bool: active rows past the budget, for the host
    path) instead of a SeedBatch."""
    dev = read_words.device
    B, Wr = read_words.shape
    NF = nf_mult * B
    NE = n_ext_steps
    fl = didx.first_level_bases
    sk = didx.search_k
    rw = u32(read_words)
    lens = read_lens.to(_I64)

    offs = torch.arange(S0, dtype=_I64, device=dev) * SEED_STEP
    seed_ok = (offs[None, :] < (lens[:, None] - sk + 1)) & seed_mask

    def static_windows(pos):            # (S0,) positions, same for all rows
        w = pos >> 4
        hi = rw[:, w.clamp(0, Wr - 1)]
        lo = rw[:, (w + 1).clamp(0, Wr - 1)]
        return _window(hi, lo, ((pos & 15) * 2)[None, :])

    # --- k-mer probe: lower bound of (bucket, residue) in the entry table
    qb = static_windows(offs) >> (32 - 2 * fl)
    qr = static_windows(offs + fl) >> (32 - 2 * (sk - fl))
    qkey = (qb << 32) | qr
    n_k = didx.n_kmer
    left = torch.searchsorted(didx.ent_key, qkey.reshape(-1)).reshape(B, S0)
    left_c = left.clamp(0, max(n_k - 1, 0))
    exists = (left < n_k) & (didx.ent_key[left_c] == qkey)
    count = torch.where(exists, didx.ent_run[left_c].to(_I64), 0)
    found = seed_ok & exists & (count > 0) & (count <= UNI_POS_N_MAX)

    # --- active-row compaction (compact_rows) ----------------------------
    if compact_rows:
        R = compact_rows
        act = torch.where(found, count, 0).sum(1) > 0        # (B,)
        rank = act.to(_I64).cumsum(0) - 1
        n_act = rank[-1] + 1
        slot = torch.where(act & (rank < R), rank, R)
        # rid[slot] = source row; unwritten slots keep the sentinel B
        rid = torch.full((R + 1,), B, dtype=_I64, device=dev)
        rid.scatter_(0, slot, torch.arange(B, dtype=_I64, device=dev))
        rid = rid[:R]
        slot_ok = torch.arange(R, dtype=_I64, device=dev) < n_act
        over_budget = act & (rank >= R)
        ridc = rid.clamp(0, B - 1)
        found = torch.where(slot_ok[:, None], found[ridc], False)
        count, left, rw, lens = count[ridc], left[ridc], rw[ridc], lens[ridc]
        # NF stays nf_mult x the ORIGINAL rows: compaction removes only
        # hit-free rows, so the batch's flat-lane demand is unchanged
        B = R

    # --- per-row hit layout ---------------------------------------------
    eff = torch.where(found, count, 0)
    cum = eff.cumsum(1)
    start = cum - eff
    row_hits = cum[:, -1]
    overflow0 = (row_hits - M).clamp(min=0)
    row_take = torch.where(row_hits <= M, row_hits, 0)

    # --- flat lane layout -----------------------------------------------
    cum_take = row_take.cumsum(0)
    row_start = cum_take - row_take
    total = cum_take[-1]
    row_fits = cum_take <= NF
    f_idx = torch.arange(NF, dtype=_I64, device=dev)
    row_c = torch.searchsorted(cum_take, f_idx, right=True).clamp(max=B - 1)
    p = f_idx - row_start[row_c]
    lane_ok = (f_idx < total) & (p >= 0) & (p < row_take[row_c])
    # seed of each lane: upper bound of p in its row's inclusive cumsum
    seed_of = torch.searchsorted(cum[row_c], p[:, None], right=True)[:, 0]
    seed_of = seed_of.clamp(max=S0 - 1)
    bs = row_c * S0 + seed_of
    h = p - start.reshape(-1)[bs]
    o2 = seed_of * SEED_STEP

    # --- per-entry attributes from the packed rows -----------------------
    entry = torch.where(lane_ok, left.reshape(-1)[bs] + h, 0)
    rec = didx.ent_pack[entry.clamp(0, max(n_k - 1, 0))].to(_I64)
    zero = torch.zeros((), dtype=_I64, device=dev)
    off = torch.where(lane_ok, rec[:, 0], zero)
    uid = torch.where(lane_ok, rec[:, 1], zero)
    off_l = torch.where(lane_ok, rec[:, 2], zero)
    off_r = torch.where(lane_ok, rec[:, 3] & 2047, zero)
    pos_n = torch.where(lane_ok, rec[:, 3] >> 11, zero)
    max_left = torch.minimum(off_l, o2)
    max_right = torch.minimum(off_r, lens[row_c] - o2 - sk)

    # --- MEM extension on flat lanes -------------------------------------
    uni_pad = u32(didx.uni_words_pad)
    n_pad_w = uni_pad.shape[0]

    def word(j):                    # unitig word j (zero beyond the ends)
        return uni_pad[(j + PAD_WORDS).clamp(0, n_pad_w - 1)]

    rw_lane = rw[row_c]                                   # (NF, Wr)
    w0 = o2 >> 4
    shs = (o2 & 15) * 2
    pr = o2 + sk
    wr0 = pr >> 4
    shr = (pr & 15) * 2

    def read_word(widx):
        return rw_lane.gather(1, widx.clamp(0, Wr - 1)[:, None])[:, 0]

    def rwin(side, step):
        # 16 read bases ending before the k-mer (left, step s covers
        # word w0 - s - 1) or starting after it (right)
        if side == "left":
            widx, sh = w0 - (step + 1), shs
        else:
            widx, sh = wr0 + step, shr
        return _window(read_word(widx), read_word(widx + 1), sh)

    p0 = off + sk
    left_m, right_m = _ext_steps(word, rwin, off, (off & 15) * 2,
                                 (p0 & 15) * 2, p0, max_left, max_right, NE)
    read_pos = o2 - left_m
    uni_pos_off = off_l - left_m
    length = sk + left_m + right_m

    # --- coverage skip over seed positions -------------------------------
    per_seed = torch.full((B * S0,), -1, dtype=_I64, device=dev)
    per_seed.scatter_reduce_(0, bs, torch.where(lane_ok, right_m, -1),
                             reduce="amax")
    per_seed = torch.where(found & (row_take > 0)[:, None],
                           per_seed.reshape(B, S0), -1)
    seed_used = _coverage_skip(found, per_seed, sk, S0)
    valid_f = lane_ok & seed_used.reshape(-1)[bs]

    # --- back to the (B, M) layout ---------------------------------------
    m_cols = torch.arange(M, dtype=_I64, device=dev)[None, :]
    src = (row_start[:, None] + m_cols).clamp(0, NF - 1)
    valid_bm = (m_cols < row_take[:, None]) & valid_f[src]

    def back(vals):
        return torch.where(valid_bm, vals[src], 0).to(_I32)

    n_overflow = overflow0 + torch.where(row_fits, 0, FLAT_OVERFLOW)
    sb = SeedBatch(
        uid=back(uid), read_pos=back(read_pos),
        uni_pos_off=back(uni_pos_off), length=back(length),
        pos_n=back(pos_n), valid=valid_bm, n_overflow=n_overflow.to(_I32))
    if compact_rows:
        return sb, rid.to(_I32), over_budget
    return sb


def merge_expand_device3(sb: SeedBatch, didx: DeviceIndex, S: int,
                         sample_seed: int = 0) -> DeviceSeeds:
    """merge_seed_in_unipath + expand_seed for a (B, M) SeedBatch; same
    outputs as the JAX merge_expand_device3 (occurrence sampling uses its
    counter-based hash)."""
    uid, rp, uo, ln, pn, valid = (
        sb.uid.to(_I64), sb.read_pos.to(_I64), sb.uni_pos_off.to(_I64),
        sb.length.to(_I64), sb.pos_n.to(_I64), sb.valid)
    B, M = uid.shape
    dev = uid.device

    # ---- stable sort by (uid, read_pos), invalid last ------------------
    key1 = torch.where(valid, uid, 0x7FFFFFFF)
    pk = rp.clamp(0, 4095) | (ln.clamp(0, 4095) << 12) | \
        (valid.to(_I64) << 24)
    order = torch.sort((key1 << 32) + (rp + (1 << 31)), dim=1,
                       stable=True).indices
    key1, rp, uo, pk = (a.gather(1, order) for a in (key1, rp, uo, pk))
    pn = pn.clamp(max=16383).gather(1, order)
    valid = (pk >> 24) != 0
    uid = torch.where(valid, key1, 0)
    ln = (pk >> 12) & 4095

    # ---- adjacent-linked runs -------------------------------------------
    same = (uid[:, 1:] == uid[:, :-1]) & (uo[:, 1:] > uo[:, :-1]) \
        & valid[:, 1:] & valid[:, :-1]
    diff = rp[:, 1:] - rp[:, :-1] - ln[:, :-1]
    drift = (uo[:, 1:] - uo[:, :-1]) - (rp[:, 1:] - rp[:, :-1])
    falsecol = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    linked = torch.cat(
        [falsecol, same & (diff <= WAITING_LEN) & (drift == 0)], dim=1)
    is_first = ~linked
    run_id = is_first.to(_I64).cumsum(1) - 1
    diff_p = torch.cat([torch.zeros((B, 1), dtype=_I64, device=dev), diff], 1)
    contrib = torch.where(linked & (diff_p <= 0), diff_p + ln, ln)
    contrib = torch.where(valid, contrib, 0)
    csum = contrib.cumsum(1)

    # ---- per-lane attributes of the run's LAST lane ---------------------
    last = torch.searchsorted(run_id, run_id, right=True) - 1
    pk_l = pk.gather(1, last)
    uo_l = uo.gather(1, last)
    csum_l = csum.gather(1, last)
    csum_before = torch.cat(
        [torch.zeros((B, 1), dtype=_I64, device=dev), csum[:, :-1]], 1)
    cov_all = csum_l - csum_before
    rp_l = pk_l & 4095
    ln_l = (pk_l >> 12) & 4095
    is_last = torch.cat(
        [is_first[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    len1 = torch.where(is_last, ln, rp_l + ln_l - rp)
    len2 = torch.where(is_last, ln, uo_l + ln_l - uo)

    # ---- compact run firsts into run slots (stable) ---------------------
    flag = is_first & valid
    n_runs = flag.sum(1)
    m_cols = torch.arange(M, dtype=_I64, device=dev)[None, :]
    order2 = torch.sort(torch.where(flag, m_cols, M), dim=1,
                        stable=True).indices
    mp_a = (rp & 4095) | ((len1 & 4095) << 12)
    mp_b = (len2 & 4095) | (pn << 12)
    m_uid, m_uo, m_a, m_b, m_cov = (
        a.gather(1, order2) for a in (uid, uo, mp_a, mp_b, cov_all))
    m_pn = m_b >> 12

    # ---- expand -----------------------------------------------------------
    run_ok = m_cols < n_runs[:, None]
    over2 = run_ok & (m_pn > POS_N_MAX_LEVEL2)
    aborted = over2.to(_I64).cumsum(1) > 0
    keep = run_ok & ~aborted
    occ = torch.where(keep, torch.where(m_pn > POS_N_MAX, RANDOM_NUM, m_pn), 0)
    cum = occ.cumsum(1)
    start = cum - occ
    total = cum[:, -1]

    slot = torch.arange(S, dtype=_I64, device=dev)[None, :]
    # run owning each slot: upper bound of the slot in the run cumsum
    run_of = torch.searchsorted(cum, slot.expand(B, S).contiguous(),
                                right=True)
    in_runs = run_of < M
    src_run = run_of.clamp(max=M - 1)

    def sel(a):
        return torch.where(in_runs, a.gather(1, src_run), 0)

    within = slot - sel(start)
    slot_ok = slot < torch.clamp(total, max=S)[:, None]
    r_uid = sel(m_uid)
    r_a = sel(m_a)
    r_b = sel(m_b)
    r_uo = sel(m_uo)
    covv = sel(m_cov)
    r_pn = r_b >> 12
    sampled = r_pn > POS_N_MAX
    h = ((slot * 0x9E3779B9) & _M32) ^ (sample_seed & _M32) \
        ^ (((r_uid & _M32) * 2654435761) & _M32)
    pick_within = torch.where(sampled, h % r_pn.clamp(min=1), within)
    base = didx.uni_posp[r_uid.clamp(0, max(didx.n_uni - 1, 0))].to(_I64)
    occ_idx = (base + pick_within).clamp(0, didx.uni_pos.shape[0] - 1)
    ref_begin = didx.uni_pos[occ_idx].to(_I64) + r_uo
    read_begin = r_a & 4095
    len1_r = (r_a >> 12) & 4095
    len2_r = r_b & 4095

    def z(a):
        return torch.where(slot_ok, a, 0).to(_I32)

    return DeviceSeeds(
        read_begin=z(read_begin), read_end=z(read_begin + len1_r - 1),
        ref_begin=z(ref_begin), ref_end=z(ref_begin + len2_r - 1),
        cov=z(covv), seed_id=z(src_run), valid=slot_ok,
        n_dropped=(total - S).clamp(min=0).to(_I32))
