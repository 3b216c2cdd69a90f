"""The front's hand-written kernels (ops/front_cuda.py) at a batch an
engine ran: held to the plain programs bit for bit, and on a card timed
beside their wrappers, their plain programs and their bytes bound.

    with keep_batch() as kept:
        ...                        # engines run: fc_aln, a benchmark cell
    check_batch(kept)              # kernels == plain programs, or raises
    rows = time_batch(kept)        # one row an entry point (a card only)

keep_batch wraps AlignEngine._run_front and _run_dp while it is entered
and keeps the front with the most padded rows (its host arrays, shape
set and the engine's device index) and the DP chunk with the most
problems in the smallest DP class (its read codes and metadata, copied
on the device before the chunk runs).

The rows (time_batch): "ms" each entry point's wrapper (CUDA events over
`reps` calls), "kernel_ms" its kernels alone (their device time in a
profile of the same calls), "plain_ms" the PyTorch program it stands in
for on the same card, "bound_ms" its bytes at HBM_BYTES_PER_S (no kernel
here does arithmetic worth counting): each input and output byte once,
each scratch byte written once and read once, one SECTOR a step of a
binary search of the probe table (log2 of its k-mers, plus one) and a
SECTOR a unitig or read word an extension compares. The DP glue's row
("pansvr_dp_glue": pansvr_dp_fill, pansvr_dp_start, pansvr_dp_pack)
times the whole chunk in "ms" and "plain_ms", K1 and K2 inside both
("k1_k2_ms" their kernels alone), and only its own kernels in
"kernel_ms" and "bound_ms".
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..ops import front_cuda
from ..ops.collect import select_and_paths
from ..ops.kernel_bounds import HBM_BYTES_PER_S, SECTOR, cuda_ms
from ..ops.seeding import seed_reads_flat
from . import programs
from .engine import AlignEngine


@contextlib.contextmanager
def keep_batch():
    """Within the block every AlignEngine keeps its widest front and its
    largest smallest-class DP chunk in the dict this yields."""
    kept: dict = {}
    run_front, run_dp = AlignEngine._run_front, AlignEngine._run_dp

    def front(self, host, shapes):
        if shapes["n_pad"] > kept.get("shapes", {}).get("n_pad", 0):
            kept.update(didx=self.didx, device=self.device,
                        host={k: np.array(v) for k, v in host.items()},
                        shapes=dict(shapes))
        return run_front(self, host, shapes)

    def dp(self, codes, meta, cq, ct, W, size):
        d = kept.get("dp")
        if d is None or (cq, -size) < (d["cq"], -d["size"]):
            kept["dp"] = dict(codes=codes.clone(), meta=meta.clone(),
                              ref_words=self.didx.ref_words, cq=cq, ct=ct,
                              W=W, size=size, params=self.dp_params,
                              tru_len=self._tru_ref_len)
        return run_dp(self, codes, meta, cq, ct, W, size)

    AlignEngine._run_front, AlignEngine._run_dp = front, dp
    try:
        yield kept
    finally:
        AlignEngine._run_front, AlignEngine._run_dp = run_front, run_dp


def _inputs(kept) -> dict:
    return {k: torch.from_numpy(v).to(kept["device"])
            for k, v in kept["host"].items()}


def _same(what: str, got: dict, want: dict) -> int:
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
    for k in want:
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(a, b):
            raise AssertionError(
                f"{what}: {k} differs from the plain program's "
                f"({a.dtype} {tuple(a.shape)} vs {b.dtype} "
                f"{tuple(b.shape)})")
    return len(want)


def check_batch(kept: dict, lib=None) -> dict:
    """The kept batch through the kernels and through the plain programs,
    every output bit for bit: front_program at its shape set, the
    chain's host-collect pack at its width K, a re-chain at full width
    with its collect, and (on a card) the kept DP chunk. Raises
    AssertionError at the first output that differs; returns the count
    of outputs compared by check. `lib`: front_cuda's kernel library
    (a host build for CPU tensors)."""
    didx, shapes = kept["didx"], kept["shapes"]
    inputs = _inputs(kept)
    g = shapes.__getitem__
    got = front_cuda.front_program(didx, inputs, shapes, lib=lib)
    out = {"front_program": _same(
        "front_program", got,
        programs.front_program_plain(didx, inputs, shapes))}
    # the seeds a re-chain reads (the kernels', equal to the plain ones)
    _, es, is_str, rid, active = programs.front_parts(got)
    out["host_collect"] = _same(
        "chain_program (host collect)",
        front_cuda.chain_program(es, is_str, rid, None, g("K"), g("n_pad"),
                                 0, 0, lib=lib),
        programs.chain_program_plain(es, is_str, rid, None, g("K"),
                                     g("n_pad"), 0, 0))
    K_full = min(g("S"), front_cuda.MAX_K)
    out["rechain"] = _same(
        f"chain_program at full width {K_full}",
        front_cuda.chain_program(es, is_str, rid, active, K_full, g("n_pad"),
                                 g("NC"), g("NP"), lib=lib),
        programs.chain_program_plain(es, is_str, rid, active, K_full,
                                     g("n_pad"), g("NC"), g("NP")))
    d = kept.get("dp")
    if d is not None and d["codes"].device.type == "cuda":
        args = (d["codes"], d["ref_words"], d["meta"], d["cq"], d["ct"],
                d["W"], d["size"], d["params"], d["tru_len"])
        out["dp_program"] = _same("dp_program", front_cuda.dp_program(*args),
                                  programs.dp_program_plain(*args))
    return out


def _alone_ms(fn, reps: int) -> dict:
    """{device kernel name: ms a call} over `reps` calls of fn, from a
    profile of the card."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / reps
    return by


def _row(name, fn, plain, n_bytes, reps, keep=lambda k: True) -> dict:
    alone = _alone_ms(fn, reps)
    return dict(name=name, ms=cuda_ms(fn, reps),
                kernel_ms=sum(v for k, v in alone.items() if keep(k)),
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                plain_ms=cuda_ms(plain, max(3, reps // 4)),
                kernels={k: round(v, 5) for k, v in sorted(alone.items())
                         if keep(k)})


def time_batch(kept: dict, reps: int = 20) -> list[dict]:
    """One row an entry point at the kept batch (module docstring), with
    the batch's shape set and the MEM lanes its front extended."""
    didx, shapes = kept["didx"], kept["shapes"]
    inputs = _inputs(kept)
    g = shapes.__getitem__
    words = inputs["words"]
    B, Wr = words.shape
    S0, S, M, NE, L = g("S0"), g("S"), g("M"), g("n_ext"), g("L")
    K, n_pad, NC, NP, comp = g("K"), g("n_pad"), g("NC"), g("NP"), g("comp")
    lanes = int(seed_reads_flat(
        didx, words, inputs["lens2"], inputs["mask2"], S0=S0,
        n_ext_steps=NE, M=M, nf_mult=g("nf_mult")).valid.sum())
    front_args = (didx, words, inputs["lens2"], inputs["mask2"],
                  inputs["is_str2"], S0, S, M, NE, g("nf_mult"), comp, L)
    es, _, rid, is_str_c, _ = front_cuda.front(*front_args)
    is_str = inputs["is_str2"] if rid is None else is_str_c
    active = inputs["act_pad"] if NC else None
    R = es.read_begin.shape[0]

    def plain_front():
        programs.front_seeds(didx, words, inputs["lens2"], inputs["mask2"],
                             S0, S, M, NE, g("nf_mult"), comp)
        programs.unpack_codes(words, L)

    def plain_chain():
        cr, hi, hs, hf = programs.chain_at(es, is_str, K)
        if not NC:
            programs.chain_pack(cr, hi, hs, hf)

    front_bytes = (B * Wr * 4 + B * 4 + B * S0 + B              # inputs
                   + R * S * (6 * 4 + 1) + 3 * B * 4 + B * L   # outputs
                   + B * S0 * (math.ceil(math.log2(max(didx.n_kmer, 2)))
                               + 1) * SECTOR                   # the probe
                   + lanes * (16 + 4 * NE * SECTOR)            # extension
                   + 2 * (B * S0 * 9 + B * 12 + 9 * 4 * lanes))  # scratch
    chain_bytes = R * K * (6 * 4 + 1) + R + R * K * 5 * 4 + R * 6 * 3 * 4
    rows = [
        _row("pansvr_front", lambda: front_cuda.front(*front_args),
             plain_front, front_bytes, reps),
        _row("pansvr_chain",
             lambda: front_cuda.chain(es, is_str, K, pack=not NC),
             plain_chain, chain_bytes, reps)]
    if NC:
        ch = front_cuda.chain(es, is_str, K, pack=False)
        cr, hi, hs, hf = programs.chain_at(es, is_str, K)
        collect_bytes = (R * K * 5 * 4 + R * 6 * 3 * 4 + n_pad
                         + NC * 3 * 4 + NP * 10 + n_pad * 4
                         + 2 * (n_pad * 50 * 4 + NC * 16))
        rows.append(_row(
            "pansvr_collect",
            lambda: front_cuda.collect(ch, active, rid, n_pad, NC, NP),
            lambda: select_and_paths(
                cr.read_begin, cr.read_end, cr.ref_begin, cr.ref_end,
                cr.pre, hi, hs, hf, active, rid, n_pad=n_pad, NC=NC, NP=NP),
            collect_bytes, reps))
    d = kept.get("dp")
    if d is not None:
        args = (d["codes"], d["ref_words"], d["meta"], d["cq"], d["ct"],
                d["W"], d["size"], d["params"], d["tru_len"])
        size, cq, ct = d["size"], d["cq"], d["ct"]
        glue_bytes = (size * 5 * 4 + size * (cq + ct) * 2 + size * 8
                      + size * 9 * 4 + size * 16 + size * 8 * 4 + size * 8)
        row = _row("pansvr_dp_glue", lambda: front_cuda.dp_program(*args),
                   lambda: programs.dp_program_plain(*args), glue_bytes,
                   reps, keep=lambda k: "extd2" not in k)
        row["k1_k2_ms"] = sum(v for k, v in _alone_ms(
            lambda: front_cuda.dp_program(*args), reps).items()
            if "extd2" in k)
        row["dp_shape"] = [d["cq"], d["ct"], d["W"], size]
        rows.append(row)
    for r in rows:
        r.update(shapes=dict(shapes), lanes=lanes, n_kmer=int(didx.n_kmer))
    return rows
