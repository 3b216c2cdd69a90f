"""Batched fc_aln realignment engine on one PyTorch device.

Port of pansvr_tpu/align/engine.py (its single-device pipeline), per
batch of reads:

  1. host:   2-bit encode fwd + rev, STR screen, packing (_prep_batch,
             run in a worker thread);
  2. device, enqueued at dispatch (_dispatch_front): seeding front
             (ops.seeding.seed_reads_flat, with active-row compaction) +
             merge/expand, SDP chaining at the speculative chain width K
             (ops.chain), then either the chain extraction or the device
             collect (ops.collect.select_and_paths); the results are
             copied into pinned host tensors behind one CUDA event;
  3. host:   _finish_front waits for that event, adapts K (re-chains at
             full width on a miss), widens the lane budgets and
             re-dispatches the batch on mass overflow, and takes the
             exact host path for the rows still over a cap;
  4. host:   the C++ collect walk (native glue) plans every DP segment,
             from the device-collected paths or the chain tensors;
  5. device: DP fill from the resident read codes + packed reference,
             extd2 forward + traceback kernels (ops.extd2_cuda) in three
             size classes, results copied back behind one event;
  6. host:   C++ replay, ranking and (with native emit) PE pairing +
             BAM record encoding.

align_stream keeps cfg.stream_depth fronts in flight and defers each
batch's DP phase by one iteration; host prep runs one to two batches
ahead in a worker thread. Only the main thread issues device work, and
no step on the way reads a device value back except at the two event
waits (sync_chain, sync_dp) and the rare K-miss re-chain.

The adaptive state (speculative K, compaction budget, lane budgets,
collect budgets, retier window) takes the JAX engine's decisions on the
same statistics; each batch carries its own shapes in its `pend`, so a
widening made for batch N never changes how an in-flight batch N+1 is
unpacked. Equality with align.host_align.HostAligner (the port's copy
of pansvr_tpu/align/host_align.py) is the
contract; reads over the device caps (lane budgets, seeds, chain width,
read length) take that exact host path. The native glue library is
required.

Not ported here: the multi-chip mesh (pansvr_tpu/parallel/mesh.py and
the JAX engine's sharded front/chain/DP), the one part of the JAX
package the port still lacks.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np
import torch

from ..index.builder import RdBGIndex
from ..index.device import resolve_device, to_device
from ..ops import extd2_cuda
from ..ops.chain import chain_batch, chain_extract_batch
from ..ops.collect import select_and_paths
from ..ops.extd2 import Extd2Params, plan
from ..utils import dna
from . import native_glue
from .host_align import (
    LEN_KMER,
    MIN_STR_DETECT_LEN,
    SEED_STEP,
    AlignParams,
    AlnResult,
    HostAligner,
    KswHandler,
    OriResult,
    SingleEndState,
)
from ..ops.seeding import (
    BUDGET_OVERFLOW,
    FLAT_OVERFLOW,
    merge_expand_device3,
    pack_reads,
    seed_reads_flat,
)

_I32 = torch.int32
_I64 = torch.int64

# consecutive batches that must ask for the same compaction budget
# before it applies
_COMPACT_STABLE = 3


@dataclass
class EngineConfig:
    """Engine shapes and pipeline choices (the JAX EngineConfig's names
    and defaults, without its TPU-only fields)."""
    # read-length classes: a batch runs in the smallest class that fits
    # its longest read; longer reads take the host aligner (1600 is the
    # reference's cap, read_realignment.hpp:322)
    read_classes: tuple = (160, 256, 512, 1024, 1600)
    max_seeds: int = 32          # S: expanded seeds per read and direction
    chain_bucket: int = 32       # K cap widened with M/S (tuning state)
    mem_slots: int = 32          # M: MEM lanes per row (overflow -> host)
    dp_q: int = 176              # DP size class of the 160 read class
    dp_t: int = 256
    nf_mult: int = 10            # flat-front lane pool: nf_mult lanes per
                                 # row; rows past the pool take the host
                                 # path (and a mass overflow widens it)
    retier_threshold: float = 0.25  # fallback rate that doubles M/S/K
    retier_max: int = 128        # cap of the widened shapes
    dp_chunk: int = 2048         # problems per DP launch, small class
                                 # (the middle class takes 1/4, the big 1/16)
    compact_div: int = 4         # > 1 enables active-row compaction: the
                                 # front's later stages and the chain run
                                 # at a peak-active-rows x 1.4 budget
    stream_depth: int = 3        # fronts in flight in align_stream
                                 # (1 = one batch at a time)
    collect: str = "auto"        # chain selection + path gather: "device"
                                 # (ops.collect), "host" (C++ walk over
                                 # the chain tensors) or "auto" (device
                                 # when the glue has glue_collect_paths)
    collect_mult: int = 1        # device-collect lane budgets: NC =
                                 # mult x n_pad chains, NP = 2 x mult x
                                 # n_pad path nodes (grows on overflow)
    pipe_order: str = "late"     # stream_depth 1: the next batch's front
                                 # is enqueued after this batch's DP
                                 # ("late") or after its chain ("early")

    @property
    def max_read_len(self) -> int:
        return max(self.read_classes)

    def read_class(self, max_len: int) -> int | None:
        return next((c for c in sorted(self.read_classes) if max_len <= c),
                    None)

    def dp_class(self, read_class: int) -> tuple[int, int]:
        """(Qmax, Tmax) of the largest DP class of a read class: the read
        class + 16 by + 96 (dp_q x dp_t for the 160 class)."""
        if read_class <= 160:
            return self.dp_q, self.dp_t
        q = read_class + 16
        return q, q + 80

    def dp_classes(self, read_class: int):
        """[(Qmax, Tmax, W, full chunk, residue chunk)] of the DP classes a
        batch of `read_class` launches, (48, 64) first: most DP segments
        are small chain-gap repairs. A class is cut into full chunks,
        then residue chunks of a quarter (at least 128 problems)."""
        dp_q, dp_t = self.dp_class(read_class)
        classes = [(48, 64, 64, self.dp_chunk),
                   (96, 128, 128, max(self.dp_chunk // 4, 128)),
                   (dp_q, dp_t, 256, max(self.dp_chunk // 16, 128))]
        classes = [c for c in classes[:-1]
                   if c[0] < dp_q and c[1] < dp_t] + [classes[-1]]
        return [(q, t, W, n, max(n // 4, 128)) for q, t, W, n in classes]


def unpack_codes(words: torch.Tensor, L: int) -> torch.Tensor:
    """(B2, Wr) packed read words -> flat (B2*L,) uint8 codes (row-major,
    fwd rows then rev rows: the glue's codes layout)."""
    j = torch.arange(L, dtype=_I64, device=words.device)
    w = (words.to(_I64) & 0xFFFFFFFF)[:, j >> 4]
    return ((w >> ((15 - (j & 15)) * 2)) & 3).to(torch.uint8).reshape(-1)


def dp_fill_meta(codes_flat, ref_words, qbase, qa, refst, tlen, rev,
                 tru_len: int, cq: int, ct: int):
    """One DP chunk's (B, cq)/(B, ct) code matrices built on the device
    from the resident read codes + packed reference, from per-request
    metadata (glue_fill_dp semantics: reversed rows for left extensions,
    reference clamped to [0, true length) with 0 beyond)."""
    dev = codes_flat.device
    qbase, qa, refst, tlen, rev = (a.to(_I64) for a in
                                   (qbase, qa, refst, tlen, rev))
    j_q = torch.arange(cq, dtype=_I64, device=dev)[None, :]
    qidx = qbase[:, None] + torch.where(rev[:, None] != 0,
                                        qa[:, None] - 1 - j_q, j_q)
    n_codes = codes_flat.shape[0]
    qc = torch.where(j_q < qa[:, None],
                     codes_flat[qidx.clamp(0, n_codes - 1)].to(_I32), 0)
    j_t = torch.arange(ct, dtype=_I64, device=dev)[None, :]
    tpos = refst[:, None] + torch.where(rev[:, None] != 0,
                                        tlen[:, None] - 1 - j_t, j_t)
    tok = (j_t < tlen[:, None]) & (tpos < tru_len)
    rw = ref_words.to(_I64) & 0xFFFFFFFF
    w = rw[(tpos >> 4).clamp(0, rw.shape[0] - 1)]
    base = (w >> ((15 - (tpos & 15)) * 2)) & 3
    tc = torch.where(tok, base, 0).to(_I32)
    return qc, qa.to(_I32), tc, tlen.to(_I32)


def dp_chunk(qc, ql, tc, tl, params: Extd2Params, W: int):
    """Forward sweep + traceback of one DP chunk (extd2_cuda kernels on
    a CUDA device, their plain versions on the CPU). Returns ops (B,
    n_diag_pad) int8 in walk order and packed (8, B) int32 rows score,
    mqe, max, max_q, max_t, zdropped, i_fin, j_fin."""
    Qmax, Tmax = qc.shape[1], tc.shape[1]
    _, n_diag_pad, _, _ = plan(Qmax, Tmax, W)
    res = extd2_cuda.extd2_fwd(qc, ql, tc, tl, params, W)
    # walk start: the end cell, or the max cell after a z-drop
    i0 = torch.where(~res.zdropped, tl - 1,
                     torch.where(res.max_t >= 0, res.max_t, -1)).to(_I32)
    j0 = torch.where(~res.zdropped, ql - 1,
                     torch.where(res.max_q >= 0, res.max_q, -1)).to(_I32)
    ops, i_f, j_f = extd2_cuda.extd2_traceback(
        res.dmat, ql, tl, i0, j0, params, W, n_diag_pad, Tmax)
    packed = torch.stack([res.score, res.mqe, res.max, res.max_q, res.max_t,
                          res.zdropped.to(_I32), i_f, j_f])
    return ops, packed


def chain_unpack(out: dict, B: int, K: int):
    """Host chain tensors of the host-collect path, in full (B, ...) row
    space: (s_fb, p16, pre, hits8, hscore). With a row map ("rid" in
    `out`) the per-seed tensors cover the compacted rows only and are
    scattered back here (empty rows: no hits, pre -1)."""
    p32, p16, p8, hits8, hscore = (out[k] for k in
                                   ("p32", "p16", "p8", "hits8", "hscore"))
    if "rid" not in out:
        return p32, p16, p8, hits8, hscore
    rid = out["rid"]
    ok = rid < B
    r = rid[ok]
    s_fb = np.zeros((B, K), np.int32)
    s_fb[r] = p32[ok]
    f16 = np.zeros((3, B, K), np.int16)
    f16[:, r] = p16[:, ok]
    pre = np.full((B, K), -1, np.int8)
    pre[r] = p8[ok]
    h8 = np.full((2, B, 6), -1, np.int8)  # hit_idx -1 = no hits
    h8[1] = 0
    h8[:, r] = hits8[:, ok]
    hs = np.zeros((B, 6), np.int16)
    hs[r] = hscore[ok]
    return s_fb, f16, pre, h8, hs


def _append_results(states, res, lo: int, hi: int) -> None:
    """Append the replayed results lo..hi (glue_replay arrays, sorted by
    read) to their reads' states as AlnResults."""
    res_read, rf, cig_op, cig_len, cig_off, cig_n = res
    for x in range(lo, hi):
        o = int(cig_off[x])
        states[int(res_read[x])].results.append(AlnResult(
            align_score=int(rf[x, 2]), chain_score=int(rf[x, 1]),
            read_bg=int(rf[x, 3]), mapq=int(rf[x, 6]), chr_id=-1,
            ref_bg=int(rf[x, 4]), direction=int(rf[x, 0]),
            is_ori=False, sv_id=int(rf[x, 5]), rst_idx=int(rf[x, 7]),
            cigar=[("MID"[cig_op[o + j]], int(cig_len[o + j]))
                   for j in range(int(cig_n[x]))]))


def _log(msg: str) -> None:
    print(f"[pansvr engine] {msg}", file=sys.stderr)


class AlignEngine:
    """Batched aligner on one device; produces SingleEndState lists
    compatible with align.host_align.PEScorer, or encoded BAM
    record blobs with set_native_emit."""

    def __init__(self, idx: RdBGIndex, params: AlignParams | None = None,
                 config: EngineConfig | None = None,
                 ori_chrom_names: list[str] | None = None, device="cuda"):
        self.device = resolve_device(device)
        self._glue_lib = native_glue.get_lib()
        if self._glue_lib is None or not all(
                hasattr(self._glue_lib, f)
                for f in ("glue_req_meta", "glue_str_dup")):
            raise RuntimeError(
                "the PyTorch engine needs the native glue library "
                "(native/build/libpansvr_glue.so with glue_req_meta and "
                "glue_str_dup; build it with tools/build_native.sh)")
        self.idx = idx
        self.p = params or AlignParams()
        self.cfg = config or EngineConfig()
        self.didx = to_device(idx, self.device)
        self.host = HostAligner(idx, self.p, ori_chrom_names=ori_chrom_names)
        self.sv_info = self.host.sv_info
        self.dp_params = Extd2Params(
            match=self.p.match, mismatch=-self.p.mismatch,
            q=self.p.gap_open, e=self.p.gap_ex,
            q2=self.p.gap_open2, e2=self.p.gap_ex2,
            w=self.p.band, zdrop=self.p.zdrop,
        )
        self._scalar_dp = KswHandler(idx, self.p)._run_dp
        self._packed_ref = np.ascontiguousarray(self.host.ksw.packed_ref)
        self._tru_ref_len = int(len(self._packed_ref))
        self._chr_starts64 = np.ascontiguousarray(self.idx.chr_starts,
                                                  np.int64)
        self._sv_st_pos = np.array(
            [info.st_pos for info in self.sv_info], np.int32)
        # speculative chain width: grows at once to the bucket of a
        # batch's largest seed count, shrinks after 8 narrower batches
        self._k_spec = 8
        self._k_shrink_run = 0
        # active-row compaction: once 4 batches are in the window, the
        # budget is the window's peak active rows x 1.4 + 64, rounded to
        # 512, applied after _COMPACT_STABLE equal asks and engaged only
        # when it saves >= 12.5% of the rows; a budget overflow drops it
        self._act_window: deque = deque(maxlen=8)
        self._comp_cap = 0
        self._comp_want = 0
        self._comp_want_run = 0
        self._tier_window: list[tuple[int, int]] = []  # (n_fallback, n)
        self._fallback_warned = False
        # wall seconds per engine phase and event counts, across batches
        self.prof: dict[str, float] = defaultdict(float)
        self._emit_ctx = None
        self._emit_pe = None

    # ------------------------------------------------------------------
    def load_tuning(self, path: str) -> bool:
        """Start from a previous run's converged lane budgets (the JSON
        of save_tuning; either package's file loads in the other)."""
        try:
            with open(path) as fh:
                t = json.load(fh)
        except (OSError, ValueError):
            return False
        cfg = self.cfg
        for k in ("nf_mult", "mem_slots", "max_seeds", "chain_bucket",
                  "collect_mult"):
            if k in t:
                setattr(cfg, k, int(t[k]))
        if "k_spec" in t:
            self._k_spec = min(int(t["k_spec"]), cfg.max_seeds, 32)
        return True

    def save_tuning(self, path: str) -> None:
        cfg = self.cfg
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({
                "nf_mult": cfg.nf_mult, "mem_slots": cfg.mem_slots,
                "max_seeds": cfg.max_seeds,
                "chain_bucket": cfg.chain_bucket,
                "collect_mult": cfg.collect_mult, "k_spec": self._k_spec,
            }, fh)
        os.replace(tmp, path)

    def set_native_emit(self, emit_ctx) -> None:
        """Route batches with aux=(names, quals, comments) through the
        C++ PE-pair + BAM-encode pass (glue_pe_emit): align_stream then
        yields encoded record blobs instead of state lists."""
        if not hasattr(self._glue_lib, "glue_pe_emit"):
            raise RuntimeError("native emit requires libpansvr_glue with "
                               "glue_pe_emit (tools/build_native.sh)")
        from .host_align import PEScorer

        self._emit_ctx = emit_ctx
        self._emit_pe = PEScorer(self.host, emit_ctx.max_isize,
                                 emit_ctx.min_isize, emit_ctx.normal_read_len)

    # ---- host <-> device ----------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync: staged
        through pinned memory (PyTorch's caching host allocator reuses
        the blocks once their copies are done) and copied non-blocking."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _download(self, tensors: dict):
        """Start non-blocking copies of device tensors into pinned host
        tensors and record one event behind them; _wait returns NumPy
        views once the event has passed."""
        if self.device.type != "cuda":
            return tensors, None
        host = {}
        for k, t in tensors.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k] = h.copy_(t.contiguous(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _wait(self, handle) -> dict:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
            self.prof["n_event_waits"] += 1
        return {k: t.numpy() for k, t in host.items()}

    # ------------------------------------------------------------------
    def align_batch(self, seqs: list[str], oris) -> list[SingleEndState]:
        return self._finish_batch(self._submit_batch(seqs, oris))

    def align_stream(self, batches):
        """Software-pipelined batches: cfg.stream_depth fronts stay in
        flight and each batch's DP phase (result wait, replay, emit) is
        deferred one iteration, so a batch's copies land while newer
        fronts run. Host prep runs in one worker thread with two prep
        futures in flight. stream_depth 1: one batch at a time, the next
        front enqueued at the point cfg.pipe_order names. `batches` yields
        (seqs, oris[, aux]); yields state lists / emit blobs in order."""
        from concurrent.futures import ThreadPoolExecutor

        it = iter(batches)
        depth = self.cfg.stream_depth
        if depth <= 1:
            yield from self._align_stream_d1(it)
            return
        b = next(it, None)
        if b is None:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            q_front: deque = deque()   # front dispatched, chain pending
            q_dp: deque = deque()      # DP dispatched, results pending
            q_prep: deque = deque()    # prep futures in flight
            q_front.append(self._submit_batch(*b))
            for _ in range(depth - 1):
                b = next(it, None)
                if b is None:
                    break
                q_front.append(self._submit_batch(*b))
            if b is not None:
                while len(q_prep) < 2:
                    b = next(it, None)
                    if b is None:
                        break
                    q_prep.append(pool.submit(self._prep_batch, *b))
            while q_front or q_dp:
                if q_front:
                    pend = q_front.popleft()
                    self._finish_front(pend)
                    q_dp.append(pend)
                    if q_prep:
                        t = time.perf_counter()
                        q_front.append(
                            self._dispatch_front(q_prep.popleft().result()))
                        self.prof["host_submit"] += time.perf_counter() - t
                        b = next(it, None)
                        if b is not None:
                            q_prep.append(pool.submit(self._prep_batch, *b))
                # the DP phase waits one iteration while fronts remain
                if q_dp and (not q_front or len(q_dp) > 1):
                    yield self._finish_dp(q_dp.popleft())

    def _align_stream_d1(self, it):
        """stream_depth 1: one batch in flight; host prep of the next
        batch runs in a worker thread while this one finishes."""
        from concurrent.futures import ThreadPoolExecutor

        b = next(it, None)
        if b is None:
            return
        pend = self._submit_batch(*b)
        with ThreadPoolExecutor(max_workers=1) as pool:
            while True:
                nxt = next(it, None)
                if nxt is None:
                    yield self._finish_batch(pend)
                    return
                prep_fut = pool.submit(self._prep_batch, *nxt)
                holder = {}

                def dispatch_next(fut=prep_fut):
                    t = time.perf_counter()
                    holder["p"] = self._dispatch_front(fut.result())
                    self.prof["host_submit"] += time.perf_counter() - t

                yield self._finish_batch(pend, on_dp_dispatched=dispatch_next)
                pend = holder.get("p") or self._dispatch_front(
                    prep_fut.result())

    def _submit_batch(self, seqs, oris, aux=None):
        t = time.perf_counter()
        out = self._dispatch_front(self._prep_batch(seqs, oris, aux))
        self.prof["host_submit"] += time.perf_counter() - t
        return out

    def _prep_batch(self, seqs: list[str], oris, aux=None):
        """Host-only batch preparation (encode, STR screen, packing);
        touches no device or adaptive state, so it runs in a worker
        thread."""
        cfg = self.cfg
        n = len(seqs)
        n_pad = max(64, 1 << (max(n, 1) - 1).bit_length())
        fit_lens = [len(s) for s in seqs if len(s) <= cfg.max_read_len]
        L = cfg.read_class(max(fit_lens)) if fit_lens \
            else min(cfg.read_classes)
        states: list[SingleEndState] = []

        codes_f = np.zeros((n_pad, L), np.uint8)
        codes_r = np.zeros((n_pad, L), np.uint8)
        lens = np.zeros(n_pad, np.int32)
        S0 = (L - LEN_KMER) // SEED_STEP + 1
        seed_mask_f = np.ones((n_pad, S0), bool)
        seed_mask_r = np.ones((n_pad, S0), bool)
        is_str = np.zeros(n_pad, bool)

        # batch-vectorized encoding; N's take the position hash of
        # dna.fill_n (the local read position is the column index)
        all_lens = np.fromiter((len(s) for s in seqs), np.int32, count=n)
        fit = all_lens <= L
        col = np.arange(L)
        if n:
            joined = "".join(s for s, f in zip(seqs, fit) if f).encode()
            flat = dna.encode(joined)
            in_row = col[None, :] < all_lens[fit, None]
            cf_rows = np.zeros((int(fit.sum()), L), np.uint8)
            cf_rows[in_row] = flat
            n_mask = (cf_rows >= 4) & in_row
            if n_mask.any():
                h = ((col.astype(np.uint64)
                      * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(61))
                cf_rows = np.where(
                    n_mask, (h & np.uint64(3)).astype(np.uint8)[None, :],
                    cf_rows)
            rev_idx = np.clip(all_lens[fit, None] - 1 - col[None, :], 0,
                              L - 1)
            cr_rows = np.where(
                in_row, np.take_along_axis(cf_rows, rev_idx, axis=1) ^ 3, 0
            ).astype(np.uint8)
            fit_idx = np.nonzero(fit)[0]
            codes_f[fit_idx] = cf_rows
            codes_r[fit_idx] = cr_rows
        fit_row = np.zeros(n, np.int32)
        fit_row[fit] = np.arange(int(fit.sum()))

        # oris: OriResult objects, or the native comment parser's (n, 8)
        # int32 matrix
        if isinstance(oris, np.ndarray):
            unm_all = ((oris[:, 6] == 1) | (oris[:, 0] > 24)).astype(bool)
            score_all = oris[:, 3].astype(np.int64)
            ori_objs = [None] * n
        else:
            unm_all = np.fromiter(
                (o.unmapped or o.chr_id > 24 for o in oris), bool, count=n)
            score_all = np.fromiter(
                (o.align_score for o in oris), np.int64, count=n)
            ori_objs = oris
        refuse = (~unm_all) & (
            score_all == all_lens.astype(np.int64) * self.p.match)
        act_mask = fit & ~refuse
        lens[:n][act_mask] = all_lens[act_mask]
        active = np.nonzero(act_mask)[0].tolist()
        # out-of-class reads: exact host path in _finish_front
        oversize = np.nonzero(~fit)[0].tolist()
        maybe_str = np.nonzero(
            act_mask & (all_lens - LEN_KMER + 1 > 0))[0].tolist()
        unm_l = unm_all.tolist()
        fit_l = fit.tolist()
        row_l = fit_row.tolist()
        len_l = all_lens.tolist()
        ap = states.append
        for i in range(n):
            if fit_l[i]:
                r = row_l[i]
                rl = len_l[i]
                cf = cf_rows[r, :rl]
                cr = cr_rows[r, :rl]
            else:
                cf = dna.fill_n(dna.encode(seqs[i]), seed=0)
                cr = (cf[::-1] ^ 3).astype(np.uint8)
            ap(SingleEndState(
                results=[], ori=ori_objs[i], ori_unmapped=unm_l[i],
                read_codes_fwd=cf, read_codes_rev=cr,
            ))

        # STR detection: the glue's duplicate-20-mer count narrows the
        # reads that need the full per-read seed-list construction
        if maybe_str:
            dup_all = native_glue.str_dup_counts(
                self._glue_lib, codes_f, lens, LEN_KMER)
            for i in maybe_str:
                n_kmer = int(lens[i]) - LEN_KMER + 1
                if not (n_kmer <= MIN_STR_DETECT_LEN
                        or dup_all[i] > MIN_STR_DETECT_LEN - 1):
                    continue
                istr, sl = self.host._detect_str(codes_f[i, : int(lens[i])])
                is_str[i] = istr
                if sl is not None:
                    pos = np.arange(0, n_kmer, SEED_STEP)
                    seed_mask_f[i, : len(pos)] = (sl > 0)[pos]
                    seed_mask_r[i, : len(pos)] = (sl[::-1] > 0)[pos]

        base = dict(states=states, active=active, n=n, n_pad=n_pad,
                    seqs=seqs, oris=oris, oversize=oversize, aux=aux)
        if not active:
            base["front"] = None
            return base
        act_pad = np.zeros(n_pad, bool)
        act_pad[:n] = act_mask
        base.update(
            words=pack_reads(np.concatenate([codes_f, codes_r], axis=0)),
            lens2=np.concatenate([lens, lens]),
            mask2=np.concatenate([seed_mask_f, seed_mask_r], axis=0),
            is_str2=np.concatenate([is_str, is_str]), act_pad=act_pad,
            S0=S0, L=L, codes_f=codes_f, codes_r=codes_r, lens=lens)
        return base

    # ---- front + chain (+ collect), enqueued at dispatch ----------------
    def _compaction_budget(self, rows: int) -> int:
        """Row budget of this batch's compacted front (0 = uncompacted);
        advances the compaction hysteresis as the JAX engine does at
        dispatch."""
        if self.cfg.compact_div <= 1:
            return 0
        aw = self._act_window
        if len(aw) >= 4:
            tight = -(-(max(aw) * 7 // 5 + 64) // 512) * 512
            if tight == self._comp_want:
                self._comp_want_run += 1
            else:
                self._comp_want = tight
                self._comp_want_run = 1
            if (self._comp_want_run >= _COMPACT_STABLE
                    and self._comp_cap != tight):
                self._comp_cap = tight
        if self._comp_cap and self._comp_cap <= rows * 7 // 8:
            return max(256, min(self._comp_cap, rows))
        return 0

    def _use_device_collect(self) -> bool:
        c = self.cfg.collect
        if c == "host":
            return False
        has = hasattr(self._glue_lib, "glue_collect_paths")
        if c == "device" and not has:
            raise RuntimeError(
                "collect='device' needs libpansvr_glue with "
                "glue_collect_paths (tools/build_native.sh)")
        return has

    def _collect_budgets(self, n_pad: int) -> tuple[int, int]:
        m = self.cfg.collect_mult
        return m * n_pad, 2 * m * n_pad

    def _front(self, words, lens2, mask2, S0, S, M, n_ext, nf_mult, comp):
        """Seeding front + merge/expand. Returns es, stats3 (3, rows)
        [overflow, dropped, seed count] in full row space, and the row
        map of a compacted front (None uncompacted)."""
        if not comp:
            sb = seed_reads_flat(self.didx, words, lens2, mask2, S0=S0,
                                 n_ext_steps=n_ext, M=M, nf_mult=nf_mult)
            es = merge_expand_device3(sb, self.didx, S=S)
            return es, torch.stack([sb.n_overflow, es.n_dropped,
                                    es.valid.sum(1).to(_I32)]), None
        sb, rid, over_budget = seed_reads_flat(
            self.didx, words, lens2, mask2, S0=S0, n_ext_steps=n_ext, M=M,
            nf_mult=nf_mult, compact_rows=comp)
        es = merge_expand_device3(sb, self.didx, S=S)
        B_full = words.shape[0]
        ridx = rid.to(_I64)

        def scatter_full(init, vals):
            # slot B_full takes the empty compacted slots (dropped)
            out = torch.cat([init, init.new_zeros(1)])
            return out.index_add_(0, ridx, vals.to(_I32))[:B_full]

        zeros = torch.zeros(B_full, dtype=_I32, device=words.device)
        ov = torch.where(over_budget, BUDGET_OVERFLOW, 0).to(_I32)
        stats3 = torch.stack([scatter_full(ov, sb.n_overflow),
                              scatter_full(zeros, es.n_dropped),
                              scatter_full(zeros, es.valid.sum(1))])
        return es, stats3, rid

    def _chain_out(self, front: dict, K: int, n_pad: int, NC: int,
                   NP: int) -> dict:
        """Chain at width K over the front's seeds, then chain extraction
        (host collect) or select_and_paths (device collect, NC > 0): the
        device tensors the host needs."""
        es = front["es"]
        cr = chain_batch(
            es.read_begin[:, :K], es.read_end[:, :K], es.ref_begin[:, :K],
            es.ref_end[:, :K], es.cov[:, :K], es.seed_id[:, :K],
            es.valid[:, :K], front["is_str"])
        hit_idx, hit_score, hit_final = chain_extract_batch(
            cr.dist, cr.pre, cr.valid)
        if NC:
            co = select_and_paths(
                cr.read_begin, cr.read_end, cr.ref_begin, cr.ref_end, cr.pre,
                hit_idx, hit_score, hit_final, front["active"], front["rid"],
                n_pad=n_pad, NC=NC, NP=NP)
            return dict(over=co.over,
                        scal=torch.cat([co.n_chains, co.n_nodes]),
                        chain_meta=co.chain_meta, path_a=co.path_a,
                        path_b=co.path_b,
                        path_dfe=co.path_dfe.to(torch.int16))
        # the glue reads int16/int8 chain tensors; fe rides as fe - fb
        out = dict(
            p32=cr.ref_begin,
            p16=torch.stack([cr.read_begin, cr.read_end,
                             cr.ref_end - cr.ref_begin]).to(torch.int16),
            p8=cr.pre.to(torch.int8),
            hits8=torch.stack([hit_idx, hit_final]).to(torch.int8),
            hscore=hit_score.to(torch.int16))
        if front["rid"] is not None:
            out["rid"] = front["rid"]
        return out

    def _dispatch_front(self, prep):
        """Enqueue the batch's front, chain at the speculative width and
        collect, and start the copies of their results to the host; waits
        for nothing (main thread only)."""
        if "front" in prep:
            return prep   # no active reads
        cfg = self.cfg
        L, S0, n_pad = prep["L"], prep["S0"], prep["n_pad"]
        n_ext = max(9, -(-(L - LEN_KMER) // 16))
        # MEM lanes cover at least one hit per seed position
        M = max(cfg.mem_slots, (S0 + 1 + 15) // 16 * 16)
        S = cfg.max_seeds
        K = self._k_spec
        comp = self._compaction_budget(2 * n_pad)
        NC, NP = self._collect_budgets(n_pad) \
            if self._use_device_collect() else (0, 0)
        words = self._upload(prep.pop("words"))
        lens2 = self._upload(prep.pop("lens2"))
        mask2 = self._upload(prep.pop("mask2"))
        is_str2 = self._upload(prep.pop("is_str2"))
        act_pad = prep.pop("act_pad")
        es, stats3, rid = self._front(words, lens2, mask2, S0, S, M, n_ext,
                                      cfg.nf_mult, comp)
        if rid is not None:
            self.prof["n_compacted"] += 1
            B_full = words.shape[0]
            is_str2 = is_str2[rid.to(_I64).clamp(0, B_full - 1)] \
                & (rid < B_full)
        front = dict(es=es, stats3=stats3, rid=rid, is_str=is_str2,
                     active=self._upload(act_pad) if NC else None)
        out = self._chain_out(front, K, n_pad, NC, NP)
        out["stats3"] = stats3
        prep.update(
            front=front, chain=self._download(out),
            shapes=dict(M=M, S=S, K=K, comp=comp, NC=NC, NP=NP),
            codes_flat=unpack_codes(words, L), read_class=L)
        return prep

    def _finish_batch(self, pend, on_dp_dispatched=None):
        self._finish_front(pend, on_dp_dispatched)
        return self._finish_dp(pend)

    def _redispatch(self, pend, on_dp_dispatched) -> None:
        """Batch retry: prepare and dispatch the same batch again (with
        the budgets just widened) and finish its front in place."""
        pend2 = self._dispatch_front(self._prep_batch(
            pend["seqs"], pend["oris"], pend.get("aux")))
        pend2["retry"] = pend.get("retry", 0) + 1
        self.prof["n_retry"] += 1
        pend.clear()
        pend.update(pend2)
        self._finish_front(pend, on_dp_dispatched)

    def _finish_front(self, pend, on_dp_dispatched=None) -> None:
        cfg = self.cfg
        states = pend["states"]
        active = pend["active"]
        n = pend["n"]
        n_pad = pend["n_pad"]
        seqs = pend["seqs"]
        t = time.perf_counter()
        for i in pend.get("oversize", ()):
            states[i] = self.host.align_read(seqs[i], self._ori_obj(pend, i))
        if pend.get("oversize"):
            self.prof["host_fallback"] += time.perf_counter() - t
        # the device tensors of the front live until this batch's chain
        # is final (a K miss re-chains from them)
        front = pend.pop("front")
        if front is None:
            self.prof["n_oversize"] += len(pend.get("oversize", ()))
            if on_dp_dispatched is not None:
                on_dp_dispatched()
            pend["dp"] = ("none",)
            return
        sh = pend["shapes"]
        K, comp, NC, NP = sh["K"], sh["comp"], sh["NC"], sh["NP"]
        B2 = 2 * n_pad
        t = time.perf_counter()
        out = self._wait(pend.pop("chain"))
        self.prof["sync_chain"] += time.perf_counter() - t
        stats3 = out["stats3"]
        overflow, dropped, seed_count = stats3
        kmax = int(seed_count.max()) if len(seed_count) else 0
        # speculative width: grow at once, shrink one step after 8
        # narrower batches; 32 is the device chain cap (ancestor masks),
        # rows with more seeds take the host path below
        bucket = min(cfg.max_seeds, 32,
                     max(8, 1 << max(kmax - 1, 0).bit_length()))
        if bucket > self._k_spec:
            self._k_spec = bucket
            self._k_shrink_run = 0
        elif bucket < self._k_spec:
            self._k_shrink_run += 1
            if self._k_shrink_run >= 8:
                self._k_spec = max(bucket, self._k_spec // 2)
                self._k_shrink_run = 0
        else:
            self._k_shrink_run = 0
        if kmax > K and K < 32:
            # speculation missed: re-chain at the full width of the es
            # this batch's front produced
            K = min(sh["S"], 32)
            t = time.perf_counter()
            out.update(self._wait(self._download(
                self._chain_out(front, K, n_pad, NC, NP))))
            self.prof["sync_chain"] += time.perf_counter() - t
            self.prof["n_rechain"] += 1

        fallback = set(int(r) % n_pad for r in np.nonzero(overflow > 0)[0])
        fallback |= set(int(r) % n_pad for r in np.nonzero(dropped > 0)[0])
        # rows past the 32-node device chain cap: exact host path, always
        seed32 = set(int(r) % n_pad for r in np.nonzero(seed_count > 32)[0])
        n_seed32 = len(seed32 - fallback)
        fallback |= seed32
        # ---- batch retry on mass lane overflow --------------------------
        # widen the budget that overflowed and re-dispatch this batch
        # instead of host-aligning most of it
        if (len(fallback) - n_seed32 > max(64, len(active) // 8)
                and pend.get("retry", 0) < 4):
            widened = False
            flat_n = int(((overflow & FLAT_OVERFLOW) != 0).sum())
            m_over = int(((overflow & (FLAT_OVERFLOW - 1)) > 0).sum())
            drop_n = int((dropped > 0).sum())
            if flat_n and cfg.nf_mult < 64:
                cfg.nf_mult = min(64, cfg.nf_mult * 2)
                widened = True
            if (m_over or drop_n) and cfg.mem_slots < cfg.retier_max:
                cfg.mem_slots = min(cfg.mem_slots * 2, cfg.retier_max)
                cfg.max_seeds = min(cfg.max_seeds * 2, cfg.retier_max)
                cfg.chain_bucket = min(cfg.chain_bucket * 2, cfg.retier_max)
                widened = True
            budget_n = int(((overflow & BUDGET_OVERFLOW) != 0).sum())
            if not widened and budget_n and self._comp_cap:
                # mass compaction-budget overflow: retry uncompacted
                self._drop_compaction()
                widened = True
            if widened:
                self.prof["n_widen"] += 1
                self.prof["n_retry_over"] += len(fallback)
                _log(f"{len(fallback)} reads over lane budgets (flat="
                     f"{flat_n} M/S={m_over}/{drop_n}): widening to "
                     f"(M,S,K,nf)=({cfg.mem_slots}, {cfg.max_seeds}, "
                     f"{cfg.chain_bucket}, {cfg.nf_mult}) and "
                     "re-dispatching the batch")
                self._k_spec = min(self._k_spec, cfg.max_seeds)
                self._redispatch(pend, on_dp_dispatched)
                return
        n_collect_over = 0
        if NC:
            # reads whose chains/paths missed the collect lane budgets:
            # exact host path now, budgets sized from the true demand
            c_over, c_scal = out["over"], out["scal"]
            co_reads = set(int(r) for r in np.nonzero(c_over)[0])
            n_collect_over = len(co_reads - fallback)
            if n_collect_over and cfg.collect_mult < 16:
                need = max(-(-int(c_scal[1]) // n_pad),
                           -(-int(c_scal[3]) // (2 * n_pad)),
                           cfg.collect_mult + 1)
                cfg.collect_mult = min(16, max(1 << (need - 1).bit_length(),
                                               cfg.collect_mult * 2))
                self.prof["n_widen"] += 1
                if (n_collect_over > max(64, len(active) // 8)
                        and pend.get("retry", 0) < 4):
                    # mass overflow: retry instead of host-aligning it
                    self.prof["n_retry_over"] += n_collect_over
                    _log(f"{n_collect_over} reads over the collect "
                         f"budgets: collect_mult -> {cfg.collect_mult}, "
                         "re-dispatching the batch")
                    self._redispatch(pend, on_dp_dispatched)
                    return
                _log(f"device-collect budgets overflowed for "
                     f"{n_collect_over} reads: collect_mult -> "
                     f"{cfg.collect_mult}")
            fallback |= co_reads
        hit_rows = (seed_count > 0) | (overflow > 0)
        self.prof["n_hit_reads"] += int((hit_rows[:n_pad]
                                         | hit_rows[n_pad:])[:n].sum())
        pend["fallback"] = fallback
        t = time.perf_counter()
        for i in list(fallback):
            if i < n and i in active:
                states[i] = self.host.align_read(seqs[i],
                                                 self._ori_obj(pend, i))
                active.remove(i)
        self.prof["host_fallback"] += time.perf_counter() - t
        self.prof["n_fallback"] += len(fallback)
        self.prof["n_oversize"] += len(pend.get("oversize", ()))
        self.prof["n_reads"] += n
        self.prof["n_batches"] += 1
        self._adapt_after_batch(stats3, comp, fallback, n_collect_over,
                                n_seed32, n, n_pad)

        if on_dp_dispatched is not None and cfg.pipe_order == "early":
            # "early": the next batch's front goes right behind this
            # batch's chain, before its DP
            on_dp_dispatched()
            on_dp_dispatched = None
        L = pend["codes_f"].shape[1]
        t = time.perf_counter()
        if NC:
            # the device selected the chains and gathered their paths;
            # host-path reads' chains get the skip bit so the C++ walk
            # produces no results for them
            n_chains, n_nodes = int(out["scal"][0]), int(out["scal"][2])
            chain_meta = out["chain_meta"][:n_chains]
            if fallback and n_chains:
                chain_meta = chain_meta.copy()
                m0 = chain_meta[:, 0]
                fb_arr = np.fromiter(fallback, np.int32, len(fallback))
                bad = (m0 >= 0) & np.isin(m0 & 0x7FFF, fb_arr)
                chain_meta[:, 0] = np.where(bad, m0 | (1 << 24), m0)
            gb = native_glue.GlueBatch.from_paths(
                self._glue_lib, n_pad=n_pad, L=L, chain_meta=chain_meta,
                path_a=out["path_a"][:n_nodes],
                path_b=out["path_b"][:n_nodes],
                path_dfe=out["path_dfe"][:n_nodes],
                codes_f=pend["codes_f"], codes_r=pend["codes_r"],
                lens=pend["lens"], packed_ref=self._packed_ref,
                chr_starts=self._chr_starts64, sv_st_pos=self._sv_st_pos,
                params=self.p)
        else:
            s_fb, p16, pre, hits8, hscore = chain_unpack(out, B2, K)
            active_mask = np.zeros(n_pad, np.uint8)
            if active:
                active_mask[np.array(sorted(active), np.int64)] = 1
            gb = native_glue.GlueBatch(
                self._glue_lib, n_pad=n_pad, L=L, K=K,
                s_rb=p16[0], s_re=p16[1], s_fb=s_fb, s_dfe=p16[2], pre=pre,
                hit_idx=hits8[0], hit_score=hscore, hit_final=hits8[1],
                codes_f=pend["codes_f"], codes_r=pend["codes_r"],
                lens=pend["lens"], active_mask=active_mask,
                packed_ref=self._packed_ref, chr_starts=self._chr_starts64,
                sv_st_pos=self._sv_st_pos, params=self.p)
        self.prof["host_collect"] += time.perf_counter() - t
        self.prof["n_dp_req"] += gb.n_req
        self._dispatch_dp_from_gb(pend, gb, on_dp_dispatched)

    def _drop_compaction(self) -> None:
        """Uncompacted from the next dispatch on; re-engaging needs a
        fresh window of batches."""
        self._act_window.clear()
        self._comp_cap = 0
        self._comp_want = 0
        self._comp_want_run = 0

    def _adapt_after_batch(self, stats3, comp, fallback, n_collect_over,
                           n_seed32, n, n_pad) -> None:
        """Compaction window, retier window and the one-time fallback
        warning, from a finished batch's statistics."""
        cfg = self.cfg
        # budget-overflow rows say nothing about the M/S/K caps: they
        # stay out of the retier window and the warning
        bud = np.nonzero(stats3[0] & BUDGET_OVERFLOW)[0] if comp else ()
        nb_reads = len({int(r) % n_pad for r in bud})
        self.prof["n_budget_fallback"] += nb_reads
        if cfg.compact_div > 1:
            if len(bud):
                self._drop_compaction()
            else:
                self._act_window.append(
                    int(((stats3[2] > 0) | (stats3[0] > 0)).sum()))
        self._tier_window.append(
            (max(len(fallback) - nb_reads - n_collect_over - n_seed32, 0), n))
        self._maybe_retier()
        nr = self.prof["n_reads"]
        n_hard = self.prof["n_fallback"] - self.prof["n_budget_fallback"]
        if not self._fallback_warned and nr >= 4096 and n_hard > 0.05 * nr:
            self._fallback_warned = True
            _log(f"WARNING: {int(self.prof['n_fallback'])}/{int(nr)} reads "
                 f"({100 * self.prof['n_fallback'] / nr:.1f}%) took the host "
                 "fallback path (seed-slot overflow/drops). Throughput will "
                 "degrade; consider raising EngineConfig.mem_slots / "
                 "max_seeds for this workload.")

    def _maybe_retier(self) -> None:
        """Repeat-rich reads overflow the per-read caps (M MEM lanes, S
        seeds, K chain width): when the recent fallback rate crosses the
        threshold, double the caps (bounded by retier_max)."""
        cfg = self.cfg
        if cfg.mem_slots >= cfg.retier_max:
            return
        win = self._tier_window[-4:]
        nf = sum(f for f, _ in win)
        n = sum(x for _, x in win)
        if n >= 2048 and nf > cfg.retier_threshold * n:
            old = (cfg.mem_slots, cfg.max_seeds, cfg.chain_bucket,
                   cfg.nf_mult)
            cfg.mem_slots = min(cfg.mem_slots * 2, cfg.retier_max)
            cfg.max_seeds = min(cfg.max_seeds * 2, cfg.retier_max)
            cfg.chain_bucket = min(cfg.chain_bucket * 2, cfg.retier_max)
            cfg.nf_mult = min(cfg.nf_mult * 2, cfg.retier_max)
            self._k_spec = min(self._k_spec, cfg.max_seeds)
            self._tier_window.clear()
            self.prof["n_widen"] += 1
            _log(f"fallback rate {nf}/{n} over the last batches: widening "
                 f"device shapes (M,S,K,nf) {old} -> ({cfg.mem_slots}, "
                 f"{cfg.max_seeds}, {cfg.chain_bucket}, {cfg.nf_mult})")

    # ---- DP ------------------------------------------------------------
    def _dispatch_dp_from_gb(self, pend, gb, on_dp_dispatched=None):
        """DP over three size classes, each size-sorted and cut into
        full chunks plus quarter-size residue chunks; every chunk's
        request metadata goes up in one copy, every result comes back
        behind one event."""
        cfg = self.cfg
        t = time.perf_counter()
        classes = cfg.dp_classes(pend["read_class"])
        ql_all, tl_all = gb.req_sizes()
        assigned = np.full(gb.n_req, -1, np.int32)
        for ci, (cq, ct, _, _, _) in enumerate(classes):
            m = (assigned < 0) & (ql_all <= cq) & (tl_all <= ct)
            assigned[m] = ci
        meta5 = gb.req_meta()
        if meta5 is None:
            raise RuntimeError("native glue returned no DP request metadata")
        layout = []   # (cq, ct, W, members, chunk size, column offset)
        off = 0
        for ci, (cq, ct, W, CHUNK, small) in enumerate(classes):
            members = np.nonzero(assigned == ci)[0].astype(np.int32)
            # size-sort: neighbouring problems have similar sweep lengths
            members = members[np.argsort(
                ql_all[members] + tl_all[members], kind="stable")]
            c0 = 0
            while c0 < len(members):
                size = CHUNK if len(members) - c0 >= CHUNK else small
                layout.append((cq, ct, W, members[c0 : c0 + size], size, off))
                off += size
                c0 += size
        chunks = []
        if layout:
            # padding problems: empty query/target of length 1
            meta = np.repeat(np.array([[0], [1], [0], [1], [0]], np.int32),
                             off, axis=1)
            for cq, ct, W, mem, size, o in layout:
                meta[:, o : o + len(mem)] = meta5[:, mem]
            meta_dev = self._upload(meta)
            outs = {}
            for k, (cq, ct, W, mem, size, o) in enumerate(layout):
                m = meta_dev[:, o : o + size]
                qc, ql, tc, tl = dp_fill_meta(
                    pend["codes_flat"], self.didx.ref_words, m[0], m[1],
                    m[2], m[3], m[4], self._tru_ref_len, cq, ct)
                ops, packed = dp_chunk(qc, ql, tc, tl, self.dp_params, W)
                outs[f"ops{k}"] = ops[: len(mem)]
                outs[f"packed{k}"] = packed[:, : len(mem)]
                chunks.append(mem)
            handle = self._download(outs)
        else:
            handle = ({}, None)
        big = np.nonzero(assigned < 0)[0]
        self.prof["n_dp_chunks"] += len(chunks)
        self.prof["dp_dispatch"] += time.perf_counter() - t
        if on_dp_dispatched is not None:
            on_dp_dispatched()
        pend["dp"] = ("native", gb, chunks, handle, big, ql_all, tl_all)

    def _finish_dp(self, pend):
        kind = pend.pop("dp")
        states = pend["states"]
        if kind[0] == "none":
            if self._emit_ctx is not None and pend.get("aux") is not None:
                return self._emit_tail(pend, states, None)
            return states
        return self._finish_native_dp(pend, *kind[1:])

    def _finish_native_dp(self, pend, gb, chunks, handle, big, ql_all,
                          tl_all):
        states = pend["states"]
        t = time.perf_counter()
        for k in big:
            qc, ql, tc, tl = gb.fill_dp(
                np.array([k], np.int32), int(ql_all[k]), int(tl_all[k]), 1)
            gb.set_dp_scalar(int(k), self._scalar_dp(qc[0, : ql[0]],
                                                     tc[0, : tl[0]]))
        t2 = time.perf_counter()
        self.prof["dp_big"] += t2 - t
        self.prof["n_dp_big"] += len(big)
        res = self._wait(handle)
        for k, mem in enumerate(chunks):
            # ops carry 3 (= no op) at skipped diagonals
            gb.set_dp_chunk(mem, res[f"ops{k}"], res[f"packed{k}"], True)
        self.prof["sync_dp"] += time.perf_counter() - t2

        t = time.perf_counter()
        res = gb.replay()
        if self._emit_ctx is not None and pend.get("aux") is not None:
            out = self._emit_tail(pend, states, gb, res)
        else:
            _append_results(states, res, 0, len(res[0]))
            out = states
        gb.free()
        self.prof["host_replay"] += time.perf_counter() - t
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _ori_obj(pend, i) -> OriResult:
        oris = pend["oris"]
        if isinstance(oris, np.ndarray):
            r = oris[i]
            return OriResult(
                chr_id=int(r[0]), ref_bg=int(r[1]), read_bg=int(r[2]),
                align_score=int(r[3]), mapq=int(r[4]),
                direction=int(r[5]), unmapped=bool(r[6]))
        return oris[i]

    def _emit_tail(self, pend, states, gb, res=None) -> bytes:
        """Batch -> encoded BAM record blob. Pairs with a host-path read
        are paired and encoded here and spliced in pair order by
        glue_pe_emit; everything else is paired and encoded in C++."""
        from .bam_out import emit_pair
        from ..io.bam import _encode_record

        ec = self._emit_ctx
        names, quals, comments = pend["aux"]
        seqs = pend["seqs"]
        oris = pend["oris"]
        n = pend["n"] // 2 * 2
        n_pairs = n // 2
        ori8 = np.zeros((max(n, 1), 8), np.int32)
        if isinstance(oris, np.ndarray):
            ori8[:n] = oris[:n]
            ori8[:n, 6] = ((oris[:n, 6] == 1)
                           | (oris[:n, 0] > 24)).astype(np.int32)
            ori8[:n, 7] = 0
        else:
            for i in range(n):
                o = oris[i]
                ori8[i, :7] = (o.chr_id, o.ref_bg, o.read_bg, o.align_score,
                               o.mapq, o.direction,
                               1 if states[i].ori_unmapped else 0)

        def fill_from_ctx(i):
            """Materialize read i's device results (a host-path mate
            needs them for the Python pairing)."""
            if res is not None:
                _append_results(states, res,
                                int(np.searchsorted(res[0], i)),
                                int(np.searchsorted(res[0], i + 1)))

        host_reads = set(pend.get("oversize", ()))
        host_reads.update(pend.get("fallback", ()))
        skip_parts: dict[int, bytes] = {}
        for p in range(n_pairs):
            k = 2 * p
            if k in host_reads or k + 1 in host_reads:
                ori8[k, 7] = ori8[k + 1, 7] = 1
                for i in (k, k + 1):
                    if i not in host_reads and not states[i].results:
                        fill_from_ctx(i)
                    if states[i].ori is None:
                        states[i].ori = self._ori_obj(pend, i)
                pr = self._emit_pe.pair(states[k], states[k + 1])
                if not pr.gain_better:
                    continue
                recs = emit_pair(
                    self.host, pr, states[k], states[k + 1], names[k],
                    seqs[k], quals[k], seqs[k + 1], quals[k + 1],
                    comments[k], comments[k + 1], ec.header)
                part = b"".join(_encode_record(r) for r in recs)
                if part:
                    skip_parts[p] = part
        if gb is None:
            return b"".join(skip_parts.get(p, b"") for p in range(n_pairs))
        skip_off = np.zeros(n_pairs + 1, np.int64)
        if skip_parts:
            parts = [skip_parts.get(p, b"") for p in range(n_pairs)]
            np.cumsum([len(b) for b in parts], out=skip_off[1:])
            skip_blob = np.frombuffer(b"".join(parts), np.uint8).copy()
        else:
            skip_blob = np.zeros(1, np.uint8)

        def blob(strs):
            off = np.zeros(len(strs) + 1, np.int64)
            if strs:
                np.cumsum([len(s) for s in strs], out=off[1:])
            data = np.frombuffer("".join(strs).encode() or b"\0", np.uint8)
            return data, off

        name_blob, name_off = blob(names[:n])
        seq_blob, seq_off = blob(seqs[:n])
        qual_blob, qual_off = blob(quals[:n])
        comment_blob, comment_off = blob(comments[:n])
        return gb.pe_emit(n, ori8, name_blob, name_off, seq_blob, seq_off,
                          qual_blob, qual_off, comment_blob, comment_off,
                          ec, skip_blob, skip_off)
