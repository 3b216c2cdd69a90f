"""Batched fc_aln realignment engine on one PyTorch device.

Port of pansvr_tpu/align/engine.py (its single-device pipeline), per
batch of reads:

  1. host:   2-bit encode fwd + rev, STR screen, packing (_prep_batch,
             run in a worker thread);
  2. device, enqueued at dispatch (_dispatch_front): seeding front
             (ops.seeding.seed_reads_flat, with active-row compaction) +
             merge/expand, SDP chaining at the speculative chain width K
             (ops.chain), then either the chain extraction or the device
             collect (ops.collect.select_and_paths): programs.
             front_program, replayed as one CUDA graph per static shape
             set (cfg.fuse_chain on a card) or enqueued op by op; the
             results are copied into pinned host tensors behind one CUDA
             event;
  3. host:   _finish_front waits for that event, adapts K (re-chains at
             full width on a miss), widens the lane budgets and
             re-dispatches the batch on mass overflow, and takes the
             exact host path for the rows still over a cap;
  4. host:   the C++ collect walk (native glue) plans every DP segment,
             from the device-collected paths or the chain tensors;
  5. device: DP fill from the resident read codes + packed reference,
             extd2 forward + traceback kernels (ops.extd2_cuda) in three
             size classes (programs.dp_program, a CUDA graph per chunk
             shape with fuse_chain), results copied back behind one event;
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

An engine drives one device; several cards are served by the fc_aln
fan-out (parallel/aln_shard.py), one process and one engine a card.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np
import torch

from ..index.builder import RdBGIndex
from ..index.device import resolve_device, to_device, upload
from ..ops.extd2 import Extd2Params
from ..utils import dna, memory
from ..utils.opkinds import OpKinds
from ..utils.trace import Spans
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
from ..ops.seeding import BUDGET_OVERFLOW, FLAT_OVERFLOW, pack_reads
from .programs import (
    ES_FIELDS,
    FRONT_SHAPES,
    GraphCache,
    chain_program,
    dp_program,
    front_parts,
    front_program,
    front_seeds,
)

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
    fuse_chain: bool = True      # on a CUDA device: each batch's front +
                                 # chain (+ collect) and each DP chunk
                                 # run as one CUDA graph per static
                                 # shape set, captured once and
                                 # replayed (align/programs.py).
                                 # False enqueues them op by op. The CPU
                                 # runs them op by op either way

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


# the counters of the spans that a stream may never open (no pinning on
# the CPU, no batch yet), present from the start so that a reader tells
# them from a program without them
_SPAN_COUNTERS = ("source_s", "pin_s", "n_pin", "emit_s", "bam_write_s",
                  "prep_cpu_s", "main_traced_s")


def _log(msg: str) -> None:
    print(f"[pansvr engine] {msg}", file=sys.stderr)


class AlignEngine:
    """Batched aligner on one device; produces
    SingleEndState lists compatible with align.host_align.PEScorer, or
    encoded BAM record blobs with set_native_emit. With `op_kinds` the
    ATen op kinds that the build and the graph warm-ups dispatch on the
    device are recorded (utils/opkinds.py: `build_ops`, the graph
    cache's `warmup_ops`, prof n_warmup_new_op_kinds); fc_aln --trace
    asks for it."""

    def __init__(self, idx: RdBGIndex, params: AlignParams | None = None,
                 config: EngineConfig | None = None,
                 ori_chrom_names: list[str] | None = None, device="cuda",
                 op_kinds: bool = False):
        # wall seconds per engine phase and event counts, across batches,
        # each phase a span of utils.trace (index_upload: the index's
        # source arrays read and its tables derived on the device, with
        # index_read and index_derive inside; engine_build: all of
        # __init__); rss_*_gib: the process's peak RSS (rss_start_gib:
        # before __init__, engine_rss_gib: its growth across __init__,
        # rss_built_gib: after it, rss_peak_gib: after the last finished
        # batch); the resident set by kind at the engine's start, once
        # built and at each stream's end (_mem_snapshot)
        self.prof: dict[str, float] = defaultdict(float)
        for k in _SPAN_COUNTERS:
            self.prof[k] = 0.0
        # the graph warm-ups' and captures' VmRSS growth (GraphCache;
        # none op by op)
        self.prof["warmup_rss_gib"] = self.prof["capture_rss_gib"] = 0.0
        self.tr = Spans(self.prof)
        self._bid = 0          # the next batch's id
        self.last_batch = None  # id of the batch align_stream last yielded
        # per snapshot point: VmRSS, the top libraries, the read's seconds
        self.mem: dict[str, dict] = {}
        self.prof["rss_start_gib"] = memory.peak_rss_gib()
        self._mem_snapshot("start")
        # the ATen op kinds the build dispatches on the device, when
        # asked: the graph warm-ups count those they add
        self.build_ops = OpKinds(torch.device(device).type) if op_kinds \
            else None
        self.prof["n_warmup_new_op_kinds"] = 0.0
        with self.tr.span("engine_build", "engine_build"), \
                contextlib.nullcontext() if self.build_ops is None \
                else self.build_ops:
            self._build(idx, params, config, ori_chrom_names, device)
        self.prof["rss_built_gib"] = memory.peak_rss_gib()
        self.prof["engine_rss_gib"] = self.prof["rss_built_gib"] \
            - self.prof["rss_start_gib"]
        self._mem_snapshot("built")

    def _build(self, idx, params, config, ori_chrom_names, device):
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
        with self.tr.span("index_upload", "index_upload"):
            self.didx = to_device(idx, self.device, self.tr)
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
        # the per-batch programs as CUDA graphs (fuse_chain on a card);
        # None: enqueued op by op
        self._programs = GraphCache(self.device, self.tr,
                                    known_ops=self.build_ops) \
            if self.cfg.fuse_chain and self.device.type == "cuda" else None
        # the DP graphs' read-code input, one buffer per codes length
        self._codes_bufs: dict[int, torch.Tensor] = {}
        # the distinct static shape sets the engine keyed, front and DP
        # apart: the keys of its graphs, counted op by op too
        self.shape_sets: dict[str, set] = {"front": set(), "dp": set()}
        self._emit_ctx = None
        self._emit_pe = None

    def _mem_snapshot(self, point: str) -> None:
        """The resident set by kind of mapping (utils.memory) at `point`
        (start, built, end): prof rss_<point>_<kind>_gib, and at the end
        rss_end_gib (VmRSS) and the pinned host allocator's counters (0
        off a card); VmRSS, the top libraries and the read's seconds in
        mem[point]. Nothing where /proc is missing."""
        m = memory.rss_by_kind()
        if m is None:
            return
        for k, v in m["kinds"].items():
            self.prof[f"rss_{point}_{k}_gib"] = v
        if point == "end":
            if m["vmrss"] is not None:
                self.prof["rss_end_gib"] = m["vmrss"]
            # off a card nothing is pinned
            self.prof.update(memory.pinned_host()
                             if self.device.type == "cuda" else
                             dict.fromkeys(memory.PINNED, 0.0))
        self.mem[point] = dict(vmrss=m["vmrss"], top=m["top"], s=m["s"])

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

    def _keyed(self, key: tuple) -> tuple:
        """A program's key (its kind first), counted among the shape sets
        (prof n_front_shape_sets, n_dp_shape_sets)."""
        sets = self.shape_sets[key[0]]
        sets.add(key)
        self.prof[f"n_{key[0]}_shape_sets"] = len(sets)
        return key

    # ---- host <-> device ----------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _pinned(self, host: dict) -> dict:
        """Host arrays as tensors a program's inputs are copied from:
        pinned for a card, so the copies do not sync."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in host.items()}
        if self.device.type == "cuda":
            with self.tr.span("pin", "pin_s"):
                out = {k: v.pin_memory() for k, v in out.items()}
            self.prof["n_pin"] += len(out)
        return out

    def _to_host(self, tensors: dict, host: dict) -> None:
        """Start non-blocking copies of device tensors into pinned host
        tensors host[k] (on the CPU: copies), so a later replay of the
        program that wrote them cannot change what the host reads."""
        pinned = {}
        cuda = [k for k, t in tensors.items() if t.device.type == "cuda"]
        if cuda:
            with self.tr.span("pin", "pin_s"):
                pinned = {k: torch.empty(tensors[k].shape,
                                         dtype=tensors[k].dtype,
                                         pin_memory=True) for k in cuda}
            self.prof["n_pin"] += len(cuda)
        for k, t in tensors.items():
            if k in pinned:
                h = pinned[k]
                h.copy_(t.contiguous(), non_blocking=True)
            else:
                h = t.clone()
            host[k] = h

    def _event(self, host: dict):
        """(host, event): an event recorded behind the copies on the
        engine's card (None off a card); _wait returns NumPy arrays once
        it has passed."""
        ev = None
        if self.device.type == "cuda":
            # the copies run on the card's current stream: the event goes
            # behind them
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    def _download(self, tensors: dict):
        host = {}
        self._to_host(tensors, host)
        return self._event(host)

    def _wait(self, handle) -> dict:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
            self.prof["n_event_waits"] += 1
        return {k: v.numpy() for k, v in host.items()}

    # ------------------------------------------------------------------
    def align_batch(self, seqs: list[str], oris) -> list[SingleEndState]:
        bid = self._bid
        self._bid += 1
        return self._finish_batch(self._submit_batch((seqs, oris), bid))

    def _take(self, it):
        """(the source's next batch or None at its end, the id it gets):
        ids count the batches an engine takes, from 0."""
        bid = self._bid
        with self.tr.span("source", "source_s", batch=bid) as sp:
            b = next(it, None)
            if b is not None:
                sp.attr(reads=len(b[0]))
        if b is not None:
            self._bid += 1
        return b, bid

    def align_stream(self, batches):
        """Software-pipelined batches: cfg.stream_depth fronts stay in
        flight and each batch's DP phase (result wait, replay, emit) is
        deferred one iteration, so a batch's copies land while newer
        fronts run. Host prep runs in one worker thread with two prep
        futures in flight. stream_depth 1: one batch at a time, the next
        front enqueued at the point cfg.pipe_order names. `batches` yields
        (seqs, oris[, aux]); yields state lists / emit blobs in order,
        last_batch the id of the one just yielded. Once the source is
        exhausted and its last batch yielded: the resident set by kind
        (_mem_snapshot "end", span mem_snapshot), which each stream
        overwrites."""
        it = iter(batches)
        if self.cfg.stream_depth <= 1:
            yield from self._align_stream_d1(it)
        else:
            yield from self._align_stream_deep(it)
        with self.tr.span("mem_snapshot"):
            self._mem_snapshot("end")

    def _align_stream_deep(self, it):
        """stream_depth > 1: align_stream's software pipeline."""
        from concurrent.futures import ThreadPoolExecutor

        depth = self.cfg.stream_depth
        b, bid = self._take(it)
        if b is None:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            q_front: deque = deque()   # front dispatched, chain pending
            q_dp: deque = deque()      # DP dispatched, results pending
            q_prep: deque = deque()    # (id, prep future) in flight
            q_front.append(self._submit_batch(b, bid))
            for _ in range(depth - 1):
                b, bid = self._take(it)
                if b is None:
                    break
                q_front.append(self._submit_batch(b, bid))
            if b is not None:
                while len(q_prep) < 2:
                    b, bid = self._take(it)
                    if b is None:
                        break
                    q_prep.append(
                        (bid, pool.submit(self._prep_batch, *b, bid=bid)))
            while q_front or q_dp:
                if q_front:
                    pend = q_front.popleft()
                    self._finish_front(pend)
                    q_dp.append(pend)
                    if q_prep:
                        bid, fut = q_prep.popleft()
                        q_front.append(self._submit_prepped(fut.result, bid))
                        b, bid = self._take(it)
                        if b is not None:
                            q_prep.append((bid, pool.submit(
                                self._prep_batch, *b, bid=bid)))
                # the DP phase waits one iteration while fronts remain
                if q_dp and (not q_front or len(q_dp) > 1):
                    yield self._finish_dp(q_dp.popleft())

    def _align_stream_d1(self, it):
        """stream_depth 1: one batch in flight; host prep of the next
        batch runs in a worker thread while this one finishes."""
        from concurrent.futures import ThreadPoolExecutor

        b, bid = self._take(it)
        if b is None:
            return
        pend = self._submit_batch(b, bid)
        with ThreadPoolExecutor(max_workers=1) as pool:
            while True:
                nxt, nbid = self._take(it)
                if nxt is None:
                    yield self._finish_batch(pend)
                    return
                prep_fut = pool.submit(self._prep_batch, *nxt, bid=nbid)
                holder = {}

                def dispatch_next(fut=prep_fut, nbid=nbid):
                    holder["p"] = self._submit_prepped(fut.result, nbid)

                yield self._finish_batch(pend, on_dp_dispatched=dispatch_next)
                pend = holder.get("p") or self._submit_prepped(
                    prep_fut.result, nbid)

    def _submit_batch(self, b, bid: int):
        """Prepare batch `b` ((seqs, oris[, aux])) here and dispatch it."""
        return self._submit_prepped(
            functools.partial(self._prep_batch, *b, bid=bid), bid)

    def _submit_prepped(self, get_prep, bid: int):
        """Dispatch the front of batch `bid`, which get_prep() returns
        (waiting for the prep worker's future, or preparing it here).
        host_submit is the sum of prep_wait (get_prep) and front_enqueue
        (the uploads and the front's replay or op-by-op enqueue)."""
        tr = self.tr
        with tr.span("host_submit", batch=bid):
            with tr.span("prep_wait", "prep_wait", "host_submit"):
                prep = get_prep()
            with tr.span("front_enqueue", "front_enqueue", "host_submit",
                         retry=prep["retry"]):
                return self._dispatch_front(prep)

    def _prep_batch(self, seqs: list[str], oris, aux=None, bid: int = -1,
                    retry: int = 0):
        """Host-only batch preparation (encode, STR screen, packing) of
        batch `bid`, dispatch `retry`; touches no device or adaptive
        state, so it runs in a worker thread. "prep_s" and "prep_cpu_s"
        in the result: its own wall seconds and its thread's CPU
        seconds."""
        with self.tr.span("prep", batch=bid, retry=retry,
                          reads=len(seqs)) as sp:
            c0 = time.thread_time()
            prep = self._prep(seqs, oris, aux)
            cpu = time.thread_time() - c0
            sp.attr(cpu_s=cpu)
        prep.update(prep_s=sp.s, prep_cpu_s=cpu, bid=bid, retry=retry)
        return prep

    def _prep(self, seqs: list[str], oris, aux=None):
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
            base.update(front=None)
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
        """Seeding front + merge/expand (programs.front_seeds on the
        engine's index): es, stats3, and the row map of a compacted
        front (None uncompacted)."""
        return front_seeds(self.didx, words, lens2, mask2, S0, S, M, n_ext,
                           nf_mult, comp)

    def _run_front(self, host: dict, shapes: dict) -> dict:
        """front_program on the batch's host arrays: uploaded and enqueued
        op by op, or copied into the inputs of the shape set's CUDA graph
        and replayed (its outputs are the graph's: see _dispatch_front)."""
        key = self._keyed(("front", *(shapes[k] for k in FRONT_SHAPES)))
        if self._programs is None:
            return front_program(
                self.didx, {k: self._upload(v) for k, v in host.items()},
                shapes)
        return self._programs.run(
            key, functools.partial(front_program, self.didx, shapes=shapes),
            self._pinned(host))

    def _dispatch_front(self, prep):
        """Enqueue the batch's front, chain at the speculative width and
        collect, and start the copies of their results to the host; waits
        for nothing (main thread only)."""
        self.prof["prep_s"] += prep.pop("prep_s", 0.0)
        self.prof["prep_cpu_s"] += prep.pop("prep_cpu_s", 0.0)
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
        shapes = dict(L=L, n_pad=n_pad, S0=S0, S=S, M=M, n_ext=n_ext,
                      nf_mult=cfg.nf_mult, comp=comp, K=K, NC=NC, NP=NP)
        host = {k: prep.pop(k)
                for k in ("words", "lens2", "mask2", "is_str2", "act_pad")}
        if not NC:
            del host["act_pad"]
        out = self._run_front(host, shapes)
        chain, es, is_str, rid, active = front_parts(out)
        if rid is not None:
            self.prof["n_compacted"] += 1
        prep["chain"] = self._download(chain)
        # what outlives this batch's replay (the next batches' fronts
        # replay the same graph before this batch's chain is final):
        # the DP's read codes, and, where the chain width can miss
        # (K < min(S, 32)), the seeds a re-chain at full width reads
        codes = out["codes"]
        front = dict(es=es, is_str=is_str, rid=rid, active=active) \
            if K < min(S, 32) else dict(es=None)
        if self._programs is not None:
            codes = codes.clone()
            if front["es"] is not None:
                front = dict(
                    es=es._replace(**{f: getattr(es, f).clone()
                                      for f in ES_FIELDS}),
                    is_str=is_str.clone(),
                    rid=None if rid is None else rid.clone(),
                    active=None if active is None else active.clone())
        prep.update(front=front, codes_flat=codes,
                    shapes=dict(M=M, S=S, K=K, comp=comp, NC=NC, NP=NP),
                    read_class=L)
        return prep

    def _finish_batch(self, pend, on_dp_dispatched=None):
        self._finish_front(pend, on_dp_dispatched)
        return self._finish_dp(pend)

    def _redispatch(self, pend, on_dp_dispatched) -> None:
        """Batch retry: prepare and dispatch the same batch again (with
        the budgets just widened; the same id, the next retry count) and
        finish its front in place."""
        bid, retry = pend.get("bid", -1), pend.get("retry", 0) + 1
        with self.tr.span("redispatch", batch=bid, retry=retry):
            pend2 = self._dispatch_front(self._prep_batch(
                pend["seqs"], pend["oris"], pend.get("aux"), bid=bid,
                retry=retry))
        self.prof["n_retry"] += 1
        pend.clear()
        pend.update(pend2)
        self._finish_front(pend, on_dp_dispatched)

    def _finish_front(self, pend, on_dp_dispatched=None) -> None:
        """The batch's front results to its DP dispatch: chain wait,
        adaptive decisions, host fallback, host collect. Its own span
        covers the adaptive layer's glue between the phases'."""
        with self.tr.span("finish_front", batch=pend.get("bid", -1),
                          retry=pend.get("retry", 0)):
            self._finish_front_in(pend, on_dp_dispatched)

    def _finish_front_in(self, pend, on_dp_dispatched) -> None:
        cfg = self.cfg
        tr = self.tr
        states = pend["states"]
        active = pend["active"]
        n = pend["n"]
        n_pad = pend["n_pad"]
        seqs = pend["seqs"]
        if pend.get("oversize"):
            with tr.span("fallback", "host_fallback"):
                for i in pend["oversize"]:
                    states[i] = self.host.align_read(seqs[i],
                                                     self._ori_obj(pend, i))
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
        with tr.span("chain_wait", "sync_chain"):
            out = self._wait(pend.pop("chain"))
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
            if front["es"] is None:
                raise RuntimeError(f"chain width {K} missed ({kmax} seeds) "
                                   "but the front's seeds were not kept")
            K = min(sh["S"], 32)
            with tr.span("rechain", "sync_chain"):
                out.update(self._wait(self._download(chain_program(
                    front["es"], front["is_str"], front["rid"],
                    front["active"], K, n_pad, NC, NP))))
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
        with tr.span("fallback", "host_fallback"):
            for i in list(fallback):
                if i < n and i in active:
                    states[i] = self.host.align_read(seqs[i],
                                                     self._ori_obj(pend, i))
                    active.remove(i)
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
        with tr.span("collect", "host_collect"):
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
    def _dp_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """The batch's read codes where its DP chunks read them: in place
        op by op; with graphs, copied into the engine's buffer of that
        length, which every DP graph of the length reads."""
        if self._programs is None:
            return codes
        buf = self._codes_bufs.get(codes.shape[0])
        if buf is None:
            buf = self._codes_bufs[codes.shape[0]] = torch.empty_like(codes)
        return buf.copy_(codes, non_blocking=True)

    def _run_dp(self, codes, meta, cq: int, ct: int, W: int,
                size: int) -> dict:
        """dp_program on one chunk's (5, size) metadata: op by op, or by
        the replay of the shape set's CUDA graph (whose outputs the next
        replay of the same graph overwrites)."""
        fn = functools.partial(dp_program, codes, self.didx.ref_words,
                               cq=cq, ct=ct, W=W, size=size,
                               params=self.dp_params,
                               tru_len=self._tru_ref_len)
        key = self._keyed(("dp", codes.shape[0], cq, ct, W, size))
        if self._programs is None:
            return fn(meta)
        return self._programs.run(
            key, lambda inputs: fn(inputs["meta"]), {"meta": meta},
            fixed=(codes, self.didx.ref_words))

    def _dispatch_dp_from_gb(self, pend, gb, on_dp_dispatched=None):
        """DP over three size classes, each size-sorted and cut into
        full chunks plus quarter-size residue chunks; every chunk's
        request metadata goes up in one copy, each chunk's results start
        their copy to the host right behind it, and one event goes behind
        the last. dp_dispatch = dp_layout (the host layout) + dp_enqueue
        (the rest)."""
        tr = self.tr
        with tr.span("dp_dispatch", batch=pend.get("bid", -1),
                     retry=pend.get("retry", 0)):
            with tr.span("dp_layout", "dp_layout", "dp_dispatch"):
                layout, meta, big, ql_all, tl_all = self._dp_layout(pend, gb)
            with tr.span("dp_enqueue", "dp_enqueue", "dp_dispatch"):
                chunks, handle = self._dp_enqueue(pend, layout, meta)
        if on_dp_dispatched is not None:
            on_dp_dispatched()
        pend["dp"] = ("native", gb, chunks, handle, big, ql_all, tl_all)

    def _dp_layout(self, pend, gb):
        """(chunk layout, the chunks' request metadata (None without a
        chunk), the problems too big for any class, query and target
        lengths)."""
        classes = self.cfg.dp_classes(pend["read_class"])
        ql_all, tl_all = gb.req_sizes()
        assigned = np.full(gb.n_req, -1, np.int32)
        for ci, (cq, ct, _, _, _) in enumerate(classes):
            m = (assigned < 0) & (ql_all <= cq) & (tl_all <= ct)
            assigned[m] = ci
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
        if layout:
            meta5 = gb.req_meta()
            if meta5 is None:
                raise RuntimeError(
                    "native glue returned no DP request metadata")
            # padding problems: empty query/target of length 1
            meta = np.repeat(
                np.array([[0], [1], [0], [1], [0]], np.int32), off, axis=1)
            for cq, ct, W, mem, size, o in layout:
                meta[:, o : o + len(mem)] = meta5[:, mem]
        else:
            meta = None
        return layout, meta, np.nonzero(assigned < 0)[0], ql_all, tl_all

    def _dp_enqueue(self, pend, layout, meta):
        """(each chunk's problems, the download handle of their results):
        the chunks enqueued or replayed."""
        chunks = []
        host = {}
        if layout:
            meta_dev = self._upload(meta)
            codes = self._dp_codes(pend["codes_flat"])
        for k, (cq, ct, W, mem, size, o) in enumerate(layout):
            chunks.append(mem)
            res = self._run_dp(codes, meta_dev[:, o : o + size], cq, ct, W,
                               size)
            # packed whole (its columns past len(mem) are cut on the host)
            self._to_host({f"ops{k}": res["ops"][: len(mem)],
                           f"packed{k}": res["packed"]}, host)
        handle = self._event(host) if layout else ({}, None)
        self.prof["n_dp_chunks"] += len(chunks)
        return chunks, handle

    def _finish_dp(self, pend):
        """The batch's DP results, replay and emit: its state list or
        record blob. Refreshes rss_peak_gib and last_batch."""
        kind = pend.pop("dp")
        states = pend["states"]
        bid, retry = pend.get("bid", -1), pend.get("retry", 0)
        self.last_batch = bid
        if kind[0] != "none":
            out = self._finish_native_dp(pend, *kind[1:])
        elif self._emit_ctx is not None and pend.get("aux") is not None:
            # no DP, no replay: an emit outside host_replay, uncounted
            with self.tr.span("emit", batch=bid, retry=retry):
                out = self._emit_tail(pend, states, None)
        else:
            out = states
        self.prof["rss_peak_gib"] = memory.peak_rss_gib()
        return out

    def _finish_native_dp(self, pend, gb, chunks, handle, big, ql_all,
                          tl_all):
        tr = self.tr
        states = pend["states"]
        bid, retry = pend.get("bid", -1), pend.get("retry", 0)
        with tr.span("dp_big", "dp_big", batch=bid, retry=retry, n=len(big)):
            for k in big:
                qc, ql, tc, tl = gb.fill_dp(np.array([k], np.int32),
                                            int(ql_all[k]), int(tl_all[k]), 1)
                gb.set_dp_scalar(int(k), self._scalar_dp(qc[0, : ql[0]],
                                                         tc[0, : tl[0]]))
        self.prof["n_dp_big"] += len(big)
        with tr.span("dp_wait", "sync_dp", batch=bid, retry=retry):
            res = self._wait(handle)
            for k, mem in enumerate(chunks):
                # ops carry 3 (= no op) at skipped diagonals
                gb.set_dp_chunk(mem, res[f"ops{k}"],
                                res[f"packed{k}"][:, : len(mem)], True)

        with tr.span("replay", "host_replay", batch=bid, retry=retry):
            res = gb.replay()
            if self._emit_ctx is not None and pend.get("aux") is not None:
                with tr.span("emit", "emit_s"):
                    out = self._emit_tail(pend, states, gb, res)
            else:
                _append_results(states, res, 0, len(res[0]))
                out = states
            gb.free()
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
