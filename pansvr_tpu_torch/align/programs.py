"""The engine's per-batch device programs, and CUDA graphs of them.

Counterpart of the JAX engine's fused per-batch programs
(pansvr_tpu/align/engine.py): `_device_front` + `_chain_body_fused` /
`_collect_fused` (the front, the speculative-K chain and the device
collect as one program dispatched at submit time) and
`_unpack_codes` + `_device_dp_pallas_meta` (a DP chunk's fill, K1 and K2
as one program). Each is a pure function of its inputs here:

  front_program(didx, inputs, shapes) -> {name: tensor}
  dp_program(codes_flat, ref_words, meta, cq, ct, W, size, ...)
                                      -> {"ops": ..., "packed": ...}

Run eagerly they enqueue their torch ops one by one on the CPU (the
plain path, front_program_plain, chain_program_plain, dp_program_plain,
which run on any device); on a card they launch the hand-written
kernels of ops/front_cuda.py (front, chain, collect, the DP's fill and
packing) and K1/K2, and dispatch no ATen op but their outputs'
allocation: that is `fuse_chain=False`. On a CUDA device the engine
runs them through a GraphCache: each static shape set (the JAX
programs' static_argnames) is captured into one CUDA graph once, after
an eager warm-up on a side stream, and replayed after that, so a
batch's front costs one graph launch where it cost dozens of kernel
launches. Every graph of a cache allocates from one shared memory
pool.

A replay writes the same output tensors every time, so what the engine
reads after a later replay of the same graph must be copied out first:
the engine downloads or clones every output right behind its replay
(ProgramCache.run's contract). Inputs are copied into the graph's own
input tensors before each replay; `fixed` tensors (the index, the DP's
read-code buffer) are read in place and must keep their address.

K1 and K2 count their launches in Python (ops/extd2_cuda.py), which a
replay does not run: a graph records the launches made while it was
captured and counts them again at every replay.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..ops import extd2_cuda, front_cuda
from ..ops.chain import chain_batch, chain_extract_batch
from ..ops.collect import select_and_paths
from ..ops.extd2 import Extd2Params, plan
from ..utils.memory import rss_growth
from ..utils.opkinds import OpKinds
from ..utils.trace import Spans
from ..ops.seeding import (
    BUDGET_OVERFLOW,
    DeviceSeeds,
    merge_expand_device3,
    seed_reads_flat,
)

_I32 = torch.int32
_I64 = torch.int64

# the static shape set of a front program (the JAX _device_front +
# _chain_body_fused / _collect_fused static_argnames, n_pad and L)
FRONT_SHAPES = ("L", "n_pad", "S0", "S", "M", "n_ext", "nf_mult", "comp",
                "K", "NC", "NP")
# the DeviceSeeds fields a re-chain reads
ES_FIELDS = ("read_begin", "read_end", "ref_begin", "ref_end", "cov",
             "seed_id", "valid")
# graphs a cache keeps (front and DP together); the least recently used
# goes first
MAX_GRAPHS = 64


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def unpack_codes(words: torch.Tensor, L: int) -> torch.Tensor:
    """(B2, Wr) packed read words -> flat (B2*L,) uint8 codes (row-major,
    fwd rows then rev rows: the glue's codes layout)."""
    j = torch.arange(L, dtype=_I64, device=words.device)
    w = (words.to(_I64) & 0xFFFFFFFF)[:, j >> 4]
    return ((w >> ((15 - (j & 15)) * 2)) & 3).to(torch.uint8).reshape(-1)


def front_stats(didx, words, lens, mask, S0: int, S: int, M: int,
                n_ext: int, nf_mult: int):
    """The uncompacted front: seed_reads_flat + merge_expand_device3, and
    stats3 (3, rows) int32 [overflow, dropped, seed count]."""
    sb = seed_reads_flat(didx, words, lens, mask, S0=S0, n_ext_steps=n_ext,
                         M=M, nf_mult=nf_mult)
    es = merge_expand_device3(sb, didx, S=S)
    return es, torch.stack([sb.n_overflow, es.n_dropped,
                            es.valid.sum(1).to(torch.int32)])


def front_seeds(didx, words, lens2, mask2, S0, S, M, n_ext, nf_mult, comp):
    """Seeding front + merge/expand. Returns es, stats3 (3, rows)
    [overflow, dropped, seed count] in full row space, and the row map
    of a compacted front (None uncompacted)."""
    if not comp:
        return (*front_stats(didx, words, lens2, mask2, S0, S, M, n_ext,
                             nf_mult), None)
    sb, rid, over_budget = seed_reads_flat(
        didx, words, lens2, mask2, S0=S0, n_ext_steps=n_ext, M=M,
        nf_mult=nf_mult, compact_rows=comp)
    es = merge_expand_device3(sb, didx, S=S)
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


def chain_at(es, is_str, K: int):
    """Chain at width K over a front's seeds, then the top-6 extraction:
    (ChainResult, hit_idx, hit_score, hit_final)."""
    cr = chain_batch(
        es.read_begin[:, :K], es.read_end[:, :K], es.ref_begin[:, :K],
        es.ref_end[:, :K], es.cov[:, :K], es.seed_id[:, :K],
        es.valid[:, :K], is_str)
    return (cr, *chain_extract_batch(cr.dist, cr.pre, cr.valid))


def chain_pack(cr, hit_idx, hit_score, hit_final) -> dict:
    """The chain tensors the host collect reads, as int16/int8 where
    they fit; fe rides as fe - fb."""
    return dict(
        p32=cr.ref_begin,
        p16=torch.stack([cr.read_begin, cr.read_end,
                         cr.ref_end - cr.ref_begin]).to(torch.int16),
        p8=cr.pre.to(torch.int8),
        hits8=torch.stack([hit_idx, hit_final]).to(torch.int8),
        hscore=hit_score.to(torch.int16))


def chain_program(es, is_str, rid, active, K: int, n_pad: int, NC: int,
                  NP: int) -> dict:
    """Chain at width K, then the chain extraction (host collect) or
    select_and_paths (device collect, NC > 0): the tensors the host
    reads (the JAX _chain_fuse / _collect_fuse sections). On a card the
    kernels of ops/front_cuda.py, elsewhere chain_program_plain."""
    if es.read_begin.device.type == "cuda":
        return front_cuda.chain_program(es, is_str, rid, active, K, n_pad,
                                        NC, NP)
    return chain_program_plain(es, is_str, rid, active, K, n_pad, NC, NP)


def chain_program_plain(es, is_str, rid, active, K: int, n_pad: int,
                        NC: int, NP: int) -> dict:
    """chain_program as PyTorch ops, on any device: the specification
    of its kernels."""
    cr, hit_idx, hit_score, hit_final = chain_at(es, is_str, K)
    if NC:
        co = select_and_paths(
            cr.read_begin, cr.read_end, cr.ref_begin, cr.ref_end, cr.pre,
            hit_idx, hit_score, hit_final, active, rid, n_pad=n_pad, NC=NC,
            NP=NP)
        return dict(over=co.over, scal=torch.cat([co.n_chains, co.n_nodes]),
                    chain_meta=co.chain_meta, path_a=co.path_a,
                    path_b=co.path_b, path_dfe=co.path_dfe.to(torch.int16))
    out = chain_pack(cr, hit_idx, hit_score, hit_final)
    if rid is not None:
        out["rid"] = rid
    return out


def front_program(didx, inputs: dict, shapes: dict) -> dict:
    """One batch's front, chain at the speculative width K and collect:
    what _dispatch_front enqueues, minus its uploads and downloads. On a
    card the kernels of ops/front_cuda.py, elsewhere front_program_plain.

    inputs: words (B2, Wr) int32, lens2 (B2,) int32, mask2 (B2, S0)
    bool, is_str2 (B2,) bool, act_pad (n_pad,) bool (read when NC > 0).
    shapes: the FRONT_SHAPES (K the chain width; NC, NP the collect lane
    budgets, 0 for the host collect; comp the compacted row budget, 0
    uncompacted).

    Returns a flat dict: "chain/<name>" the tensors the host reads
    (stats3, then the chain pack or the collect lanes; "rid" of a
    compacted host-collect front), "codes" the DP's flat read codes, and
    what a re-chain at full width reads: "es/<field>" (ES_FIELDS),
    "is_str" (per chain row), "rid" and "active" (absent when None)."""
    if inputs["words"].device.type == "cuda":
        return front_cuda.front_program(didx, inputs, shapes)
    return front_program_plain(didx, inputs, shapes)


def front_program_plain(didx, inputs: dict, shapes: dict) -> dict:
    """front_program as PyTorch ops, on any device: the specification of
    its kernels."""
    g = shapes.__getitem__
    words = inputs["words"]
    es, stats3, rid = front_seeds(
        didx, words, inputs["lens2"], inputs["mask2"], g("S0"), g("S"),
        g("M"), g("n_ext"), g("nf_mult"), g("comp"))
    is_str = inputs["is_str2"]
    if rid is not None:
        B_full = words.shape[0]
        is_str = is_str[rid.to(_I64).clamp(0, B_full - 1)] & (rid < B_full)
    active = inputs["act_pad"] if g("NC") else None
    chain = chain_program_plain(es, is_str, rid, active, g("K"), g("n_pad"),
                                g("NC"), g("NP"))
    out = {"chain/stats3": stats3}
    out.update((f"chain/{k}", v) for k, v in chain.items())
    out["codes"] = unpack_codes(words, g("L"))
    out.update((f"es/{f}", getattr(es, f)) for f in ES_FIELDS)
    out["is_str"] = is_str
    if rid is not None:
        out["rid"] = rid
    if active is not None:
        out["active"] = active
    return out


def front_parts(out: dict):
    """(chain tensors, es, is_str, rid, active) of a front_program
    output (es a DeviceSeeds without n_dropped)."""
    chain = {k[6:]: v for k, v in out.items() if k.startswith("chain/")}
    es = DeviceSeeds(*(out[f"es/{f}"] for f in ES_FIELDS), n_dropped=None)
    return chain, es, out["is_str"], out.get("rid"), out.get("active")


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


def dp_program(codes_flat, ref_words, meta, cq: int, ct: int, W: int,
               size: int, params: Extd2Params, tru_len: int) -> dict:
    """One DP chunk: the fill from the resident read codes and the packed
    reference by its (5, size) request metadata [qbase, qlen, ref start,
    tlen, rev], then K1 + K2 (the JAX _device_dp_pallas_meta). Returns
    {"ops": (size, n_diag_pad) int8, "packed": (8, size) int32}. On a
    card the fill and the packing are kernels too (ops/front_cuda.py)."""
    if meta.shape != (5, size):
        raise ValueError(f"DP metadata {tuple(meta.shape)} != (5, {size})")
    if codes_flat.device.type == "cuda":
        return front_cuda.dp_program(codes_flat, ref_words, meta, cq, ct, W,
                                     size, params, tru_len)
    return dp_program_plain(codes_flat, ref_words, meta, cq, ct, W, size,
                            params, tru_len)


def dp_program_plain(codes_flat, ref_words, meta, cq: int, ct: int, W: int,
                     size: int, params: Extd2Params, tru_len: int) -> dict:
    """dp_program's fill and packing as PyTorch ops around K1 and K2 (or
    their plain versions off a card): the specification of its glue
    kernels."""
    qc, ql, tc, tl = dp_fill_meta(codes_flat, ref_words, meta[0], meta[1],
                                  meta[2], meta[3], meta[4], tru_len, cq, ct)
    ops, packed = dp_chunk(qc, ql, tc, tl, params, W)
    return {"ops": ops, "packed": packed}


# ---------------------------------------------------------------------------
# program caches
# ---------------------------------------------------------------------------

class _Program:
    __slots__ = ("inputs", "fixed", "out", "handle", "fn", "launches")


class ProgramCache:
    """Programs keyed by their static shape set: each is prepared once
    (_capture) and run by _replay after that, into the same output
    tensors. run() copies the inputs into the program's own input
    tensors first. The backend (GraphCache: CUDA graphs) supplies
    _capture and _replay. Counts in `prof`: n_graph_capture,
    graph_capture_s (the captures with their warm-ups; graph_warmup_s of
    it the warm-ups), n_graph_replay, graph_replay_s (the host's time in
    the replays), n_graph_evict, n_graph_held_max (the most programs the
    cache held at once). `prof`: that dict, or the engine's span
    recorder (utils.trace.Spans) over it, whose spans graph_capture
    (with its key), graph_warmup and graph_replay then take the batch
    of the engine's span they run in."""

    def __init__(self, device, prof, max_programs: int = MAX_GRAPHS):
        self.device = torch.device(device)
        self.spans = prof if isinstance(prof, Spans) else Spans(prof)
        self.prof = self.spans.prof
        self.max_programs = max_programs
        self._progs: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._progs)

    def run(self, key, fn, inputs: dict, fixed: tuple = ()) -> dict:
        """fn(inputs) -> {name: tensor or None} for the program `key`,
        through its captured program. `inputs`: {name: tensor} copied
        (non-blocking) into the program's input tensors, the same shapes
        and dtypes for a key; `fixed`: the tensors fn reads in place
        (closed over by fn), which must keep their storage for a key.
        The result is the program's output tensors: the next run of the
        same key overwrites them, so read, download or clone what
        outlives it before that."""
        p = self._progs.get(key)
        if p is None:
            p = self._new(key, fn, inputs, fixed)
        else:
            self._progs.move_to_end(key)
            ptrs = tuple(t.data_ptr() for t in fixed)
            if ptrs != p.fixed:
                raise RuntimeError(f"program {key}: a fixed input moved "
                                   "since the capture")
            for k, t in p.inputs.items():
                x = inputs[k]
                if x.shape != t.shape or x.dtype != t.dtype:
                    raise ValueError(
                        f"program {key}: input {k} {tuple(x.shape)} "
                        f"{x.dtype} != {tuple(t.shape)} {t.dtype}")
                t.copy_(x, non_blocking=True)
        with self.spans.span("graph_replay", "graph_replay_s"):
            self._replay(p)
        extd2_cuda.count_launches(p.launches)
        self.prof["n_graph_replay"] += 1
        return p.out

    def _new(self, key, fn, inputs, fixed) -> _Program:
        with self.spans.span("graph_capture", "graph_capture_s",
                             key=str(key)):
            p = _Program()
            p.fn = fn
            p.fixed = tuple(t.data_ptr() for t in fixed)
            p.inputs = {}
            for k, x in inputs.items():
                p.inputs[k] = torch.empty(x.shape, dtype=x.dtype,
                                          device=self.device)
                p.inputs[k].copy_(x, non_blocking=True)
            p.handle, p.out, p.launches = self._capture(fn, p.inputs)
            self._progs[key] = p
            self.prof["n_graph_held_max"] = max(
                self.prof["n_graph_held_max"],
                min(len(self._progs), self.max_programs))
            if len(self._progs) > self.max_programs:
                self._progs.popitem(last=False)
                self.prof["n_graph_evict"] += 1
            self.prof["n_graph_capture"] += 1
        return p

    def _capture(self, fn, inputs: dict):
        """-> (handle, output tensors, launches recorded in them)."""
        raise NotImplementedError

    def _replay(self, p: _Program) -> None:
        raise NotImplementedError


class GraphCache(ProgramCache):
    """ProgramCache of CUDA graphs on one card: warm-up on a side stream
    (kernel build, lazy module loads, the allocator's blocks), then the
    capture on the same stream into the cache's shared memory pool, in
    the "global" capture mode (any call that is unsafe under capture, in
    any thread, fails it), the cached blocks the warm-up left released
    in between; a replay runs on the current stream. A failed capture or
    replay raises. The process's VmRSS growth across the warm-ups and
    across the captures adds to warmup_rss_gib and capture_rss_gib.
    Given `known_ops` (the engine build's op kinds), `warmup_ops`
    records the ATen op kinds the warm-ups dispatch on the card and prof
    n_warmup_new_op_kinds counts those that `known_ops` lacks; without
    it (None) nothing is recorded."""

    def __init__(self, device, prof: dict, max_programs: int = MAX_GRAPHS,
                 known_ops: OpKinds | None = None):
        super().__init__(device, prof, max_programs)
        self.known_ops = known_ops
        self.warmup_ops = None if known_ops is None else OpKinds("cuda")
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.device(self.device):
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def _capture(self, fn, inputs):
        cur = torch.cuda.current_stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        prof = self.prof
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            # the warm-up's launches are set-up, counted nowhere; its
            # VmRSS growth is mostly the modules its ops load on their
            # first use (warmup_rss_gib)
            with rss_growth(prof, "warmup_rss_gib"), \
                    self.spans.span("graph_warmup", "graph_warmup_s"), \
                    extd2_cuda.record_launches(), \
                    contextlib.nullcontext() if self.warmup_ops is None \
                    else self.warmup_ops:
                fn(inputs)
            if self.warmup_ops is not None:
                prof["n_warmup_new_op_kinds"] = float(len(
                    self.warmup_ops.new_since(self.known_ops)))
            # the warm-up's blocks stay cached for the side stream, where
            # only later warm-ups would reuse them: released before the
            # capture, so the pool's temporaries do not come on top of
            # them, and nothing of the warm-up stays reserved after it
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            with rss_growth(prof, "capture_rss_gib"), \
                    extd2_cuda.record_launches() as launches:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="global")
                try:
                    out = fn(inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass     # the capture is invalid already
                    raise
                graph.capture_end()
        cur.wait_stream(side)
        return graph, out, list(launches)

    def _replay(self, p: _Program) -> None:
        # on the current stream of the cache's card, where run() copied
        # the inputs
        with torch.cuda.device(self.device):
            p.handle.replay()
