"""Chain selection + path compaction for the collect walk, on the device.

Port of pansvr_tpu/ops/collect.py (select_and_paths) to PyTorch. The
C++ collect walk (native/engine_glue.cpp score_chain) only touches the
nodes on the kept chains' paths, so instead of shipping the (rows, K)
chain tensors to the host this selects each read's chains (the
glue_collect extraction, read_realignment.cpp:212-293 + hpp break
rules) and gathers their pre-pointer paths on the device, compacted
onto flat lanes: NC chain lanes and NP path-node lanes.

Selection (bit-identical to glue_collect): per read, the candidates are
the two directions' hit lists in order (fwd hits 0..5, then rev 0..5);
a running max over the candidates seen so far drives the per-direction
break rule (cs + MAX_CHAIN_SCORE_DIFF < max or cs < MIN_CHAIN_SCORE_LOOP);
survivors sort by (-chain_score, hit_idx, candidate order) and are kept
while within MAX_CHAIN_SCORE_DIFF of the global max; a read takes part
iff its global max >= MIN_CHAIN_SCORE.

Every shape is static (NC, NP, K): no nonzero, boolean-mask indexing or
host read, so nothing here waits for the device. Reads whose chains or
path nodes miss the budgets are flagged in `over` (exact host path) and
the unclipped demand totals come back in n_chains / n_nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MIN_CHAIN_SCORE = 20         # host_align.py:41 (hpp:31)
MAX_CHAIN_SCORE_DIFF = 30    # cpp:396
MIN_CHAIN_SCORE_LOOP = 30    # cpp:397
N_HIT = 6

_I32 = torch.int32
_I64 = torch.int64


class CollectOut(NamedTuple):
    """Compacted selected chains + path nodes (flat lanes).

    chain_meta: (NC, 3) int32 [read | dir<<15 | plen<<16 | over<<24,
                               cs | read_bg<<16, ref_begin0]; -1 in
                column 0 marks an empty lane
    path_a:     (NP,) int32  rb | re<<16  (node read span)
    path_b:     (NP,) int32  fb           (node ref begin)
    path_dfe:   (NP,) int32  fe - fb      (node ref span; int16 range)
    n_chains:   (2,) int32   lanes used (clipped to NC), total demand
    n_nodes:    (2,) int32   lanes used (clipped to NP), total demand
    over:       (n_pad,) int32  reads whose chains/paths missed the
                NC/NP budgets (host path; exactness preserved)
    """
    chain_meta: torch.Tensor
    path_a: torch.Tensor
    path_b: torch.Tensor
    path_dfe: torch.Tensor
    n_chains: torch.Tensor
    n_nodes: torch.Tensor
    over: torch.Tensor


def _bump_map(cum_take: torch.Tensor, NF: int, nmax: int) -> torch.Tensor:
    """flat slot -> owner: the number of owners whose inclusive cumsum
    is <= slot (a scatter-add at the owner boundaries + one cumsum)."""
    bump = torch.zeros(NF + 1, dtype=_I64, device=cum_take.device)
    bump.index_add_(0, cum_take.clamp(max=NF),
                    torch.ones_like(cum_take, dtype=_I64))
    return bump.cumsum(0)[:NF].clamp(max=nmax - 1)


def select_and_paths(rb, re_, fb, fe, pre, hit_idx, hit_score, hit_final,
                     active, rid, n_pad: int, NC: int, NP: int) -> CollectOut:
    """rb/re_/fb/fe/pre (R, K) chain tensors in sorted order; hit_idx /
    hit_score / hit_final (R, 6); active (n_pad,) bool; rid (R,) source
    row of each compacted row (B2 = 2 * n_pad for an empty slot) or None
    when the R = B2 rows are uncompacted."""
    R, K = rb.shape
    B2 = 2 * n_pad
    dev = rb.device
    rb, re_, fb, fe, pre = (a.to(_I64) for a in (rb, re_, fb, fe, pre))
    hit_idx, hit_score, hit_final = (
        a.to(_I64) for a in (hit_idx, hit_score, hit_final))

    # ---- row -> compact slot map (identity when uncompacted) -----------
    if rid is not None:
        inv = torch.full((B2 + 1,), R, dtype=_I64, device=dev)
        inv.scatter_(0, rid.to(_I64).clamp(0, B2),
                     torch.arange(R, dtype=_I64, device=dev))
        inv = inv[:B2]
        slot_f, slot_r = inv[:n_pad], inv[n_pad:]
        # pad row R = "missing" (no hits)
        hi_pad = torch.cat([hit_idx, hit_idx.new_full((1, N_HIT), -1)])
        hs_pad = torch.cat([hit_score, hit_score.new_zeros((1, N_HIT))])
        hf_pad = torch.cat([hit_final, hit_final.new_zeros((1, N_HIT))])

        def hrow(slot):
            return hi_pad[slot], hs_pad[slot], hf_pad[slot]
    else:
        slot_f = torch.arange(n_pad, dtype=_I64, device=dev)
        slot_r = slot_f + n_pad

        def hrow(slot):
            return hit_idx[slot], hit_score[slot], hit_final[slot]

    hi_f, hs_f, hf_f = hrow(slot_f)            # (n_pad, 6)
    hi_r, hs_r, hf_r = hrow(slot_r)

    # candidate order j = d*6 + s (fwd hits first, as the C++ loop)
    cand_cs = torch.cat([hs_f, hs_r], 1)
    cand_hi = torch.cat([hi_f, hi_r], 1)
    cand_fin = torch.cat([hf_f, hf_r], 1)
    # hits are front-packed; treat them as a prefix per direction anyway
    present = torch.cat([(hi_f >= 0).to(_I64).cumprod(1) != 0,
                         (hi_r >= 0).to(_I64).cumprod(1) != 0], 1)

    # ---- running-max / break loop (12 unrolled steps) -------------------
    run_max = torch.zeros(n_pad, dtype=_I64, device=dev)
    broken = [torch.zeros(n_pad, dtype=torch.bool, device=dev)
              for _ in range(2)]
    keep_cols = []
    for j in range(2 * N_HIT):
        d = j // N_HIT
        cs = cand_cs[:, j]
        p = present[:, j] & ~broken[d]
        run_max = torch.where(p, torch.maximum(run_max, cs), run_max)
        broke = (cs + MAX_CHAIN_SCORE_DIFF < run_max) \
            | (cs < MIN_CHAIN_SCORE_LOOP)
        keep_cols.append(p & ~broke)
        broken[d] = broken[d] | (p & broke)
    keep = torch.stack(keep_cols, 1)                    # (n_pad, 12)
    gmax = run_max

    # ---- sort candidates by (-cs, hit_idx, j); dropped ones last ---------
    i32max = 0x7FFFFFFF
    j_arr = torch.arange(2 * N_HIT, dtype=_I64, device=dev)[None, :]
    key = ((8191 - cand_cs.clamp(0, 8191)) << 11) \
        | (cand_hi.clamp(0, 127) << 4) | j_arr
    key = torch.where(keep, key, i32max)
    key_s, j_s = torch.sort(key, dim=1, stable=True)
    cs_s = cand_cs.gather(1, j_s)
    hi_s = cand_hi.gather(1, j_s)
    fin_s = cand_fin.gather(1, j_s)
    d_s = j_s // N_HIT

    read_ok = active & (gmax >= MIN_CHAIN_SCORE) & keep.any(1)
    sel = (key_s != i32max) & read_ok[:, None] \
        & (cs_s + MAX_CHAIN_SCORE_DIFF >= gmax[:, None])
    # a prefix per row (sorted by descending cs)
    n_sel = sel.sum(1)

    # ---- compact chains onto NC flat lanes (read-major) -----------------
    cum_read = n_sel.cumsum(0)
    read_off = cum_read - n_sel
    total_chains = cum_read[-1]
    read_fits = cum_read <= NC
    c_lane = torch.arange(NC, dtype=_I64, device=dev)
    c_read = _bump_map(cum_read, NC, n_pad)
    c_slot = c_lane - read_off[c_read]
    c_ok = (c_lane < total_chains.clamp(max=NC)) \
        & (c_slot >= 0) & (c_slot < n_sel[c_read])

    c_slot_c = c_slot.clamp(0, 2 * N_HIT - 1)

    def g2(a):
        return torch.where(c_ok, a[c_read, c_slot_c], 0)

    c_cs, c_hi, c_fin, c_dir = g2(cs_s), g2(hi_s), g2(fin_s), g2(d_s)

    # the chain's row in the (compacted) chain tensors
    if rid is not None:
        c_row = torch.where(c_dir == 0, slot_f[c_read], slot_r[c_read])
        c_row = c_row.clamp(0, R - 1)    # selected rows are always mapped
    else:
        c_row = c_read + c_dir * n_pad

    def flat(a, node):
        return a[c_row, node.clamp(0, K - 1)]

    c_read_bg = torch.where(c_ok, flat(rb, c_fin), 0)
    c_ref_begin0 = torch.where(c_ok, flat(fb, c_fin), 0)

    # ---- path walk: follow pre from the hit node ------------------------
    node = torch.where(c_ok, c_hi, -1)
    steps_a, steps_b, steps_d = [], [], []
    plen = torch.zeros(NC, dtype=_I64, device=dev)
    for _ in range(K):
        alive = node >= 0
        a = flat(rb, node) | (flat(re_, node) << 16)
        b = flat(fb, node)
        dd = flat(fe, node) - b
        steps_a.append(torch.where(alive, a, 0))
        steps_b.append(torch.where(alive, b, 0))
        steps_d.append(torch.where(alive, dd, 0))
        plen = plen + alive.to(_I64)
        node = torch.where(alive, flat(pre, node), -1)
    pa = torch.stack(steps_a, 1)                        # (NC, K)
    pb = torch.stack(steps_b, 1)
    pd = torch.stack(steps_d, 1)

    # ---- compact path nodes onto NP flat lanes ---------------------------
    cum_nodes = plen.cumsum(0)
    node_off = cum_nodes - plen
    total_nodes = cum_nodes[-1]
    chain_fits = cum_nodes <= NP
    p_lane = torch.arange(NP, dtype=_I64, device=dev)
    p_chain = _bump_map(cum_nodes, NP, NC)
    p_step = p_lane - node_off[p_chain]
    p_ok = (p_lane < total_nodes.clamp(max=NP)) \
        & (p_step >= 0) & (p_step < plen[p_chain])
    p_step_c = p_step.clamp(0, K - 1)

    def gp(a):
        return torch.where(p_ok, a[p_chain, p_step_c], 0).to(_I32)

    # ---- budget overflow -> per-read host path ---------------------------
    # a read is over if its chains spill NC, or any of its chains' path
    # nodes spill NP
    chain_read_over = read_ok & ~read_fits
    bad_chain = c_ok & ~chain_fits
    path_read_over = torch.zeros(n_pad + 1, dtype=_I64, device=dev)
    path_read_over.index_add_(0, torch.where(bad_chain, c_read, n_pad),
                              torch.ones_like(c_read))
    over = (chain_read_over | (path_read_over[:n_pad] > 0)).to(_I32)
    # over-budget reads' chains carry a skip bit (bit 24) instead of being
    # dropped: their path nodes still occupy NP lanes, so the C++ side
    # advances its path cursor by plen while skipping the walk
    c_over = over[c_read] != 0
    meta0 = torch.where(
        c_ok, c_read | (c_dir << 15) | (plen.clamp(0, 255) << 16)
        | (c_over.to(_I64) << 24), -1)
    meta1 = torch.where(c_ok, (c_cs & 0xFFFF) | (c_read_bg << 16), 0)
    meta2 = torch.where(c_ok, c_ref_begin0, 0)
    return CollectOut(
        chain_meta=torch.stack([meta0, meta1, meta2], 1).to(_I32),
        path_a=gp(pa), path_b=gp(pb), path_dfe=gp(pd),
        n_chains=torch.stack([total_chains.clamp(max=NC),
                              total_chains]).to(_I32),
        n_nodes=torch.stack([total_nodes.clamp(max=NP),
                             total_nodes]).to(_I32),
        over=over)
