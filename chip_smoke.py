#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of fc_aln (pansvr_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from csrc/ at first use.
Phases, each timed; any failure raises (exit code != 0, no result line):
  1 card     nvidia-smi name + power limit; torch.cuda must be available
  2 build    nvcc builds pansvr_tpu_torch/csrc/*.cu for sm_90a
  3 kernels  per DP class, ~2,048 seeded problems: extd2 forward and
             traceback kernels vs their plain PyTorch versions on the card
             (bit-exact: 9 fields, direction bytes, ops, final i/j), 64 per
             class vs the scalar NumPy oracle (score, CIGAR); times from
             CUDA events: each kernel alone (raw launches, no wrapper), its
             wrapper, its plain version; beside them the class's band
             cells, the kernel's bound (K1: OPS_PER_CELL ops per band cell,
             two cells per instruction in the packed 16-bit instance, at
             the SM's issue rate, or its bytes; K2: one 32-byte sector per
             diagonal walked plus its ops row) and its share, and K2's
             longest walk (the most steps of one problem: its serial
             floor). Then at the problem counts the engine launches for
             the class (EngineConfig.dp_classes: full and residue chunks),
             on the first problems of the set: K2 bit-exact vs plain, each
             kernel alone, K2's walk and bound
  4 world    the fc_aln benchmark world (seed 123, 250k pairs, ~379k
             signal reads) in a temporary directory
  5 fc_aln   the port's CLI entry point on the whole world at -b 8192 in
             two engine configurations: stream depth 3 with device collect
             (the defaults) and depth 1 with host collect; one warm-up pass
             each, then three timed passes each, taken in turns (each
             printed, the median is the result; phase timers, peak GPU
             memory, kernel launches per pass by DP shape); the two give
             identical BAM records
  6 syncs    one 8,192-read batch per configuration under
             torch.cuda.set_sync_debug_mode("warn"): the stream syncs
             PyTorch reports, beside the engine's own event waits
  7 parity   first 16,384 reads: --device cpu (plain kernels) and cuda in
             both configurations give identical BAM records; first 1,024
             reads: the card engine's alignments equal the NumPy host
             aligner's, field by field
  8 overflow every read on target (world.build_overflow_world, 32,768
             reads): the first batch overflows the default lane pool, the
             engine widens and re-dispatches; final host fallback <= 5%
             of the reads with a hit; cpu and cuda BAM records identical
             on the first 16,384 reads
  9 uniform  reads uniform over a genome (world.build_uniform_world,
             24,576 reads at -b 2048): the compaction budget engages and
             the BAM records equal an uncompacted run's
 10 checks   both kernels launched in every fc_aln path above (counters
             reset just before each path and read just after); host
             fallback <= 5% of the reads with a k-mer hit on the bench
             world; no module of JAX or of the JAX package (pansvr_tpu)
             imported
Prints a {"kernels": [...]} line (per kernel at the main shape: "ms" the
wrapper's time, "kernel_ms" the raw launch's, "bound_ms" from this run's
band cells, "per_pass_ms" the launches of a default fc_aln pass, each at
its DP class and problem count, times the kernel alone there), then the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# (Qmax, Tmax, W, profile, problems, oracle problems): the engine's DP
# classes for the 160 and 256 read classes under the realigner's profile,
# plus the contig profile's shape (fc_sv scoring: real z-drops, and a
# window that slides across a target longer than W)
ALN = dict(match=2, mismatch=-12, q=16, e=1, q2=32, e2=0, w=200, zdrop=400)
SV = dict(match=2, mismatch=-10, q=24, e=2, q2=32, e2=1, w=132, zdrop=132)
DP_SETS = ((48, 64, 64, ALN, 2048, 64), (96, 128, 128, ALN, 2048, 64),
           (176, 256, 256, ALN, 2048, 64), (272, 352, 256, ALN, 2048, 64),
           (576, 704, 192, SV, 256, 16))
MAIN_SHAPE = (48, 64, 64)   # the main path's dominant DP chunk shape
# K1's bound: ops of the recurrence per band cell (the adds, the four-way
# max with its direction code, the four gap flags and the band blends of
# csrc/extd2_fwd.cu), each one 32-bit lane instruction; the packed 16-bit
# instance does two cells per instruction (vadd2 / vmins2 / DPX 16x2)
OPS_PER_CELL = 30
# lane instructions per clock per SM: 4 warp instructions issue per clock,
# and the integer ALU pipe (64 lanes) co-issues with the FMA pipe that runs
# IMAD (64 lanes), so no mix of integer instructions goes faster
ISSUE_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
SECTOR = 32                   # bytes the card moves for one scattered read
BATCH = 8192
N_TIMED = 3          # timed fc_aln passes after the warm-up; median reported
N_BAM_PARITY = 16_384
N_HOST_PARITY = 1024
MAX_FALLBACK = 0.05
# (name, EngineConfig fields) of the timed fc_aln configurations
CONFIGS = (("depth3_device_collect", dict(stream_depth=3, collect="auto")),
           ("depth1_host_collect", dict(stream_depth=1, collect="host")))
N_OVERFLOW = 32_768
N_UNIFORM_PAIRS = 12_288
UNIFORM_BATCH = 2048


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def int_ops_per_s() -> tuple[float, float]:
    """(integer lane instructions/s, max SM clock in MHz): SMs x
    ISSUE_LANES_PER_SM x the maximum SM clock nvidia-smi reads (derived,
    not a published figure)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6, mhz


def make_problems(rng, Q, T, n):
    """Seeded DP problems for a (Q, T) class: length-1 query or target,
    mutated copies (substitutions and indels), unrelated sequences and
    diverging prefixes (z-drop), and extreme length ratios (a band that
    dies before the end when |tlen - qlen| exceeds the band)."""
    import numpy as np

    def rand(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    pairs = []
    for i in range(n):
        kind = i % 8
        if kind == 0:
            q, t = rand(1), rand(int(rng.integers(1, T + 1)))
        elif kind == 1:
            q, t = rand(int(rng.integers(1, Q + 1))), rand(1)
        elif kind in (2, 3, 4):
            t = rand(int(rng.integers(max(2, Q // 4), T + 1)))
            q = list(t[: int(rng.integers(1, min(len(t), Q) + 1))])
            for _ in range(int(rng.integers(0, 6))):
                j = int(rng.integers(0, len(q)))
                q[j] = (q[j] + int(rng.integers(1, 4))) % 4
            for _ in range(int(rng.integers(0, 3))):
                g = int(rng.integers(-12, 13))
                j = int(rng.integers(0, len(q) + 1))
                if g > 0:
                    q[j:j] = list(rand(g))
                elif g < 0:
                    del q[j : j - g]
            q = np.array((q or [0])[:Q], np.uint8)
        elif kind == 5:
            q, t = rand(int(rng.integers(1, Q + 1))), rand(int(rng.integers(1, T + 1)))
        elif kind == 6:
            t = rand(T)
            m = int(rng.integers(1, min(Q, 40) + 1))
            q = np.concatenate([t[:m], rand(Q - m)])
        else:
            if rng.random() < 0.5:
                q, t = rand(int(rng.integers(1, 11))), rand(T)
            else:
                q, t = rand(Q), rand(int(rng.integers(1, 11)))
        pairs.append((q, t))
    return pairs


def band_dies(ql, tl, w):
    """Whether the band empties at some diagonal before the last one."""
    for r in range(ql + tl - 1):
        st0 = max(0, r - ql + 1, (r - w + 1) >> 1)
        en0 = min(tl - 1, r, (r + w) >> 1)
        if st0 > en0:
            return True
    return False


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ptxas_summary(text: str) -> list[str]:
    """'kernel<P,NR>: N registers, S bytes spilled' per kernel of nvcc's
    -Xptxas -v output."""
    import re

    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?(extd2_(?:fwd|tb)_kernel)"
                      r"(?:ILi(\d+)ELi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<P={m.group(2)},NR={m.group(3)}>"
                                 if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes spilled")
            name, spill = None, 0
    return out


def max_abs_diff(x, y) -> int:
    import torch

    if not x.numel():
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


def main_sizes(Q, T):
    """Problem counts the engine launches for a (Q, T) DP class: the full
    and the residue chunk of EngineConfig.dp_classes, for the read class
    of the bench world (160) and the next one (256)."""
    from pansvr_tpu_torch.align.engine import EngineConfig

    cfg = EngineConfig()
    return sorted({n for rc in (160, 256)
                   for q, t, _, full, small in cfg.dp_classes(rc)
                   if (q, t) == (Q, T) for n in (full, small)}, reverse=True)


def kernel_parity(dev):
    """Phase 3. Returns per-set timing/err rows."""
    import numpy as np
    import torch

    from pansvr_tpu_torch.ops import extd2_cuda as ec
    from pansvr_tpu_torch.ops.extd2 import (
        Extd2Params, ops_to_cigar_skip, plan, reference)

    int_rate, mhz = int_ops_per_s()
    log(f"kernel bounds: {card_line()}; integer issue {int_rate / 1e12:.2f} "
        f"T lane-instructions/s (SMs x {ISSUE_LANES_PER_SM} lanes x {mhz:.0f} "
        f"MHz max SM clock), HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    def bound(ops_s, n_bytes):
        """(least ms, what bounds it) of an ops time and a byte count."""
        b_s = n_bytes / HBM_BYTES_PER_S
        return (max(ops_s, b_s) * 1e3,
                "operations" if ops_s >= b_s else "bytes")

    rng = np.random.default_rng(2024)
    rows = []
    for Q, T, W, prof, n_prob, n_oracle in DP_SETS:
        params = Extd2Params(**prof)
        pairs = make_problems(rng, Q, T, n_prob)
        B = len(pairs)
        qc = np.zeros((B, Q), np.int32)
        tc = np.zeros((B, T), np.int32)
        ql = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i, (q, t) in enumerate(pairs):
            qc[i, : len(q)], tc[i, : len(t)] = q, t
            ql[i], tl[i] = len(q), len(t)
        qc, ql, tc, tl = (torch.from_numpy(a).to(dev) for a in (qc, ql, tc, tl))
        _, n_diag_pad, _, _ = plan(Q, T, W)

        got = ec.extd2_fwd(qc, ql, tc, tl, params, W)
        ref, cells = ec.extd2_fwd_plain_cells(qc, ql, tc, tl, params, W)
        torch.cuda.synchronize()
        fwd_err = 0
        for f in got._fields:
            a, b = getattr(got, f), getattr(ref, f)
            if not torch.equal(a, b):
                raise AssertionError(f"extd2_fwd {Q}x{T}: field {f} differs "
                                     "from the plain version")
            fwd_err = max(fwd_err, max_abs_diff(a, b))
        zd = got.zdropped
        i0 = torch.where(~zd, tl - 1, torch.where(got.max_t >= 0, got.max_t, -1)).to(torch.int32)
        j0 = torch.where(~zd, ql - 1, torch.where(got.max_q >= 0, got.max_q, -1)).to(torch.int32)
        ops, i_f, j_f = ec.extd2_traceback(got.dmat, ql, tl, i0, j0, params, W,
                                           n_diag_pad, T)
        ops_p, i_p, j_p = ec.extd2_traceback_plain(got.dmat, ql, tl, i0, j0,
                                                   params, W, n_diag_pad, T)
        torch.cuda.synchronize()
        for name, a, b in (("ops", ops, ops_p), ("i", i_f, i_p), ("j", j_f, j_p)):
            if not torch.equal(a, b):
                raise AssertionError(f"extd2_tb {Q}x{T}: {name} differs from "
                                     "the plain version")
        tb_err = max(max_abs_diff(ops, ops_p), max_abs_diff(i_f, i_p),
                     max_abs_diff(j_f, j_p))

        # scalar NumPy oracle on the first n_oracle problems
        ops_h, i_h, j_h = ops.cpu().numpy(), i_f.cpu().numpy(), j_f.cpu().numpy()
        sc, mx, zdh = got.score.cpu().numpy(), got.max.cpu().numpy(), zd.cpu().numpy()
        i0h, j0h = i0.cpu().numpy(), j0.cpu().numpy()
        for b in range(n_oracle):
            q, t = pairs[b]
            e = reference(q, t, params)
            cig = ops_to_cigar_skip(ops_h[b], int(i_h[b]), int(j_h[b])) \
                if i0h[b] >= 0 and j0h[b] >= 0 else []
            if (bool(zdh[b]) != e.zdropped or int(mx[b]) != e.max
                    or (not e.zdropped and int(sc[b]) != e.score)
                    or cig != e.cigar):
                raise AssertionError(
                    f"{Q}x{T} problem {b} (qlen {len(q)}, tlen {len(t)}) "
                    f"differs from the NumPy oracle: score {int(sc[b])} vs "
                    f"{e.score}, cigar {cig} vs {e.cigar}")

        fwd_ms = cuda_ms(lambda: ec.extd2_fwd(qc, ql, tc, tl, params, W), 5)
        fwd_plain_ms = cuda_ms(
            lambda: ec.extd2_fwd_plain(qc, ql, tc, tl, params, W), 1)
        tb_ms = cuda_ms(lambda: ec.extd2_traceback(
            got.dmat, ql, tl, i0, j0, params, W, n_diag_pad, T), 5)
        tb_plain_ms = cuda_ms(lambda: ec.extd2_traceback_plain(
            got.dmat, ql, tl, i0, j0, params, W, n_diag_pad, T), 1)
        fwd_k_ms = cuda_ms(ec.fwd_raw_launcher(qc, ql, tc, tl, params, W), 20)
        tb_k_ms = cuda_ms(ec.tb_raw_launcher(got.dmat, ql, tl, i0, j0, params,
                                             W, n_diag_pad, T), 20)
        # bounds from this run's inputs: K1 computes `cells` band cells (two
        # per instruction when packed) and writes every direction byte; K2
        # reads one sector per diagonal it walks and writes its ops row
        n_cells = int(cells.sum().item())
        walks = (ops != 3).sum(1)
        steps, longest = int(walks.sum().item()), int(walks.max().item())
        state16 = ec.packed_state(params, W)
        k1 = bound(OPS_PER_CELL * n_cells / (2 if state16 else 1) / int_rate,
                   B * (Q + T + 2 * 4 + 9 * 4) + B * n_diag_pad * W)

        def k2_bound(n, n_steps):
            return bound(0.0, SECTOR * n_steps + n * n_diag_pad
                         + n * (4 * 4 + 2 * 4))

        k2 = k2_bound(B, steps)
        # the engine's chunk sizes of the class, on the first n problems
        by_n = {}
        for n in main_sizes(Q, T):
            sl = slice(0, n)
            tb_args = (got.dmat[sl], ql[sl], tl[sl], i0[sl], j0[sl], params,
                       W, n_diag_pad, T)
            got_n = ec.extd2_traceback(*tb_args)
            want_n = ec.extd2_traceback_plain(*tb_args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got_n, want_n)):
                raise AssertionError(f"extd2_tb {Q}x{T} at {n} problems "
                                     "differs from the plain version")
            w_n = (got_n[0] != 3).sum(1)
            s_n = int(w_n.sum().item())
            by_n[n] = dict(
                fwd_kernel_ms=cuda_ms(ec.fwd_raw_launcher(
                    qc[sl], ql[sl], tc[sl], tl[sl], params, W), 20),
                tb_kernel_ms=cuda_ms(ec.tb_raw_launcher(*tb_args), 20),
                tb_steps=s_n, tb_longest=int(w_n.max().item()),
                tb_bound_ms=k2_bound(n, s_n)[0])
        dead = torch.tensor([band_dies(len(q), len(t), params.w)
                             for q, t in pairs], device=dev)
        n_dead = int(dead.sum().item())
        row = dict(shape=(Q, T, W), n=B, band_dead=n_dead,
                   zdropped=int((zd & ~dead).sum().item()),
                   fwd_err=fwd_err, tb_err=tb_err, cells=n_cells,
                   tb_steps=steps, state16=state16,
                   fwd_ms=fwd_ms, fwd_kernel_ms=fwd_k_ms,
                   fwd_plain_ms=fwd_plain_ms, fwd_bound_ms=k1[0],
                   fwd_bound_by=k1[1], tb_ms=tb_ms, tb_kernel_ms=tb_k_ms,
                   tb_plain_ms=tb_plain_ms, tb_bound_ms=k2[0],
                   tb_bound_by=k2[1], tb_longest=longest, by_n=by_n)
        log(f"kernels {Q}x{T} W={W} w={params.w} B={B}: bit-exact vs plain "
            f"(fwd, tb), {n_oracle} vs NumPy oracle OK; score z-drops "
            f"{row['zdropped']}, band-dead {n_dead}")
        log(f"  K1 ({'int16x2' if row['state16'] else 'int32'} state): "
            f"{n_cells} band cells, bound {k1[0]:.4g} ms ({k1[1]}); kernel "
            f"{fwd_k_ms:.4f} ms = {k1[0] / fwd_k_ms:.1%} of bound; wrapper "
            f"{fwd_ms:.4f} ms; plain {fwd_plain_ms:.1f} ms")
        log(f"  K2: {steps} diagonals walked, longest walk {longest} "
            f"steps, bound {k2[0]:.4g} ms ({k2[1]}); kernel {tb_k_ms:.4f} "
            f"ms = {k2[0] / tb_k_ms:.1%} of bound; wrapper {tb_ms:.4f} ms; "
            f"plain {tb_plain_ms:.1f} ms")
        for n, v in by_n.items():
            log(f"  at {n} problems (an engine chunk): K1 alone "
                f"{v['fwd_kernel_ms']:.4f} ms; K2 bit-exact vs plain, alone "
                f"{v['tb_kernel_ms']:.4f} ms, {v['tb_steps']} diagonals "
                f"walked, longest walk {v['tb_longest']}, bound "
                f"{v['tb_bound_ms']:.4g} ms = "
                f"{v['tb_bound_ms'] / v['tb_kernel_ms']:.1%}")
        rows.append(row)
    if not any(r["zdropped"] for r in rows) or \
            not any(r["band_dead"] for r in rows):
        raise AssertionError("parity problems hit no z-drop or no dead band")
    return rows


def per_pass_ms(rows, shapes):
    """{kernel: ms} of one timed pass: its launches by (Tmax, W, problems)
    over the passes, each times the kernel alone at that class and count
    (phase 3); a size phase 3 did not time is logged and left out."""
    alone = {(r["shape"][1], r["shape"][2], n): v
             for r in rows for n, v in r["by_n"].items()}
    out = {}
    for kernel, field in (("extd2_fwd", "fwd_kernel_ms"),
                          ("extd2_tb", "tb_kernel_ms")):
        ms = 0.0
        for (k, t, W, n), count in shapes.items():
            if k != kernel:
                continue
            if (t, W, n) not in alone:
                log(f"{k}: {count} launches at Tmax={t} W={W} with {n} "
                    "problems, a size phase 3 did not time: left out of "
                    "per-pass ms")
                continue
            ms += count / N_TIMED * alone[(t, W, n)][field]
        out[kernel] = ms
    log("per-pass kernel ms (launches x time alone at the launched size, "
        f"{CONFIGS[0][0]}): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def host_parity(eng, seqs, oris):
    """The card engine vs the NumPy host aligner, field by field."""
    got = eng.align_batch(seqs, oris)
    n_with = 0
    for i, (seq, ori) in enumerate(zip(seqs, oris)):
        exp = eng.host.align_read(seq, ori)
        if len(exp.results) != len(got[i].results):
            raise AssertionError(f"read {i}: {len(got[i].results)} results, "
                                 f"host aligner {len(exp.results)}")
        for k, (a, b) in enumerate(zip(exp.results, got[i].results)):
            for f in ("align_score", "chain_score", "direction", "ref_bg",
                      "sv_id", "mapq", "cigar"):
                if getattr(a, f) != getattr(b, f):
                    raise AssertionError(
                        f"read {i} result {k} {f}: {getattr(b, f)} vs host "
                        f"{getattr(a, f)}")
        n_with += bool(exp.results)
    return n_with


def fc_aln(w, fq, out, device, batch=BATCH, **cfg):
    """The port's fc_aln CLI entry point on a world; returns the engine."""
    from pansvr_tpu_torch.align.engine import EngineConfig
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_aln

    return run_fc_aln(parse_args([
        "fc_aln", w["index"], fq, w["header"], "-o", out, "-r", w["status"],
        "-b", str(batch), "--device", device]), config=EngineConfig(**cfg))


def drop_tuning(w):
    """Remove the engine_tune.json an earlier run left in a world's index."""
    path = os.path.join(w["index"], "engine_tune.json")
    if os.path.exists(path):
        os.remove(path)


# launches by (kernel, Tmax, W) of every counted path, as counted() adds
LAUNCH_SHAPES: dict = {}


def counted(launches, name, fn):
    """Run fn with the kernel launch counters set to 0 just before and
    read just after; the counts add up under launches[name] (and by DP
    shape under LAUNCH_SHAPES[name])."""
    from pansvr_tpu_torch.ops import extd2_cuda as ec

    ec.reset_launches()
    out = fn()
    acc = launches.setdefault(name, dict.fromkeys(ec.LAUNCHES, 0))
    for k, v in ec.LAUNCHES.items():
        acc[k] += v
    by = LAUNCH_SHAPES.setdefault(name, {})
    for k, v in ec.LAUNCHES_BY_SHAPE.items():
        by[k] = by.get(k, 0) + v
    return out


def same_bam(a_path, b_path, what):
    from pansvr_tpu_torch import world

    a, b = world.bam_records(a_path), world.bam_records(b_path)
    if not a or a != b:
        raise AssertionError(f"{what}: BAM records differ ({len(a)} vs "
                             f"{len(b)} records)")
    return len(a)


def bench_passes(w, tmp, dev, launches, n_reads, n_timed=N_TIMED):
    """Phase 5: a warm-up pass per configuration, then n_timed passes of
    each, taken in turns. Returns {config: summary}."""
    import torch

    cuda = dev.type == "cuda"
    for name, cfg in CONFIGS:
        fc_aln(w, w["signal"], os.path.join(tmp, f"warm_{name}.bam"),
               dev.type, **cfg)
    res = {name: dict(walls=[], peak_mib=0.0) for name, _ in CONFIGS}
    for _ in range(n_timed):
        for name, cfg in CONFIGS:
            r = res[name]
            out = os.path.join(tmp, f"{name}.bam")
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            eng = counted(launches, f"bench_{name}",
                          lambda: fc_aln(w, w["signal"], out, dev.type, **cfg))
            if cuda:
                torch.cuda.synchronize()
                r["peak_mib"] = max(r["peak_mib"],
                                    torch.cuda.max_memory_allocated() / 2**20)
            r["walls"].append(time.perf_counter() - t)
            r["prof"] = {k: round(v, 4) for k, v in sorted(eng.prof.items())}
            r["bam"] = out
    n_pr = n_reads // 2 * 2
    for name, r in res.items():
        r["median_s"] = sorted(r["walls"])[len(r["walls"]) // 2]
        r["reads_per_s"] = n_pr / r["median_s"]
        log(f"fc_aln {name}: passes " + ", ".join(
            f"{x:.3f} s = {n_pr / x:.1f} reads/s" for x in r["walls"])
            + f"; median {r['reads_per_s']:.1f} reads/s; peak GPU memory "
            f"{r['peak_mib']:.1f} MiB")
        log(f"engine phases of the last {name} pass (s) and counts: "
            f"{r['prof']}")
        per_pass = {f"{k} Tmax={t} W={W} B={b}": n / n_timed
                    for (k, t, W, b), n
                    in sorted(LAUNCH_SHAPES.get(f"bench_{name}", {}).items())}
        log(f"kernel launches per {name} pass by DP class and problem "
            f"count (target width Tmax: 64 = 48x64, 128 = 96x128, 256/352 = "
            f"the read class's 176x256 / 272x352): {per_pass}")
    (a, ra), (b, rb) = res.items()
    n = same_bam(ra["bam"], rb["bam"], f"fc_aln {a} vs {b}")
    log(f"{a} and {b}: {n} BAM records identical")
    return res


def sync_counts(w, dev, n=BATCH):
    """Phase 6: stream syncs PyTorch reports for one n-read batch per
    configuration (after a warm-up batch), and the engine's event waits."""
    import torch

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig

    seqs, oris = world.read_batch(w["signal"], 2 * n)
    idx = world.load_index(w["index"])
    names = world.header_names(w["header"])
    for name, cfg in CONFIGS:
        eng = AlignEngine(idx, ori_chrom_names=names, device=dev,
                          config=EngineConfig(**cfg))
        eng.align_batch(seqs[:n], oris[:n])
        waits0 = eng.prof["n_event_waits"]
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.align_batch(seqs[n : 2 * n], oris[n : 2 * n])
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
        # (the mode's one-time "prototype feature" notice is not a sync)
        msgs = [str(r.message) for r in rec
                if "called a synchronizing" in str(r.message)]
        waits = int(eng.prof["n_event_waits"] - waits0)
        log(f"syncs {name}: {len(msgs)} synchronizing operations reported "
            f"by torch.cuda.set_sync_debug_mode in one {n}-read batch, "
            f"{waits} event waits"
            + (f"; first: {msgs[0][:160]}" if msgs else ""))


def overflow_phase(w, tmp, dev, launches, n_reads=N_OVERFLOW, batch=BATCH,
                   n_head=N_BAM_PARITY):
    """Phase 8: on-target world; widening + batch retry must fire and the
    final host fallback stay <= MAX_FALLBACK of the reads with a hit."""
    from pansvr_tpu_torch import world

    ov = world.build_overflow_world(w, os.path.join(tmp, "overflow"),
                                    n_reads=n_reads)
    eng = counted(launches, "overflow", lambda: fc_aln(
        ov, ov["signal"], os.path.join(tmp, "ovf.bam"), dev.type, batch))
    p = eng.prof
    hit = max(int(p["n_hit_reads"]), 1)
    row = dict(reads=n_reads, widenings=int(p["n_widen"]),
               retries=int(p["n_retry"]),
               over_before_retry=int(p["n_retry_over"]),
               fallback=int(p["n_fallback"]), hit_reads=hit,
               final=dict(nf_mult=eng.cfg.nf_mult,
                          mem_slots=eng.cfg.mem_slots,
                          collect_mult=eng.cfg.collect_mult))
    log(f"overflow world: {n_reads} on-target reads at -b {batch}: "
        f"{row['widenings']} widenings, {row['retries']} batch retries "
        f"(triggered by {row['over_before_retry']} reads over the budgets, "
        f"{row['over_before_retry'] / max(row['retries'], 1) / batch:.1%} "
        "of a retried batch on average); "
        f"final host fallback {row['fallback']} of {hit} reads with a hit; "
        f"budgets now {row['final']}")
    if not (row["widenings"] and row["retries"]):
        raise AssertionError("overflow world: no widening / batch retry")
    if row["fallback"] > MAX_FALLBACK * hit:
        raise AssertionError(f"overflow world: host fallback "
                             f"{row['fallback']} > {MAX_FALLBACK:.0%} of {hit}")
    head = os.path.join(tmp, "ovf_head.fq")
    world.head_signal(ov["signal"], head, n_head)
    bams = []
    for device in ("cpu", dev.type):
        drop_tuning(ov)
        bams.append(os.path.join(tmp, f"ovf_head_{device}.bam"))
        e = fc_aln(ov, head, bams[-1], device, batch)
        if not e.prof["n_retry"]:
            raise AssertionError(f"overflow head on {device}: no retry")
    row["bam_records"] = same_bam(*bams, f"overflow world, first {n_head} "
                                         "reads, cpu vs cuda")
    log(f"overflow world, first {n_head} reads: {row['bam_records']} BAM "
        "records identical between cpu and cuda (both widened)")


def uniform_phase(w, tmp, dev, launches, n_pairs=N_UNIFORM_PAIRS,
                  batch=UNIFORM_BATCH):
    """Phase 9: uniform reads; compaction must engage and leave the BAM
    records unchanged."""
    from pansvr_tpu_torch import world

    uw = world.build_uniform_world(w, os.path.join(tmp, "uniform"),
                                   n_pairs=n_pairs)
    on = os.path.join(tmp, "uni_on.bam")
    off = os.path.join(tmp, "uni_off.bam")
    eng = counted(launches, "uniform", lambda: fc_aln(
        uw, uw["signal"], on, dev.type, batch))
    drop_tuning(uw)
    fc_aln(uw, uw["signal"], off, dev.type, batch, compact_div=1)
    row = dict(reads=2 * n_pairs, batches=int(eng.prof["n_batches"]),
               compacted_batches=int(eng.prof["n_compacted"]),
               comp_cap=eng._comp_cap,
               hit_reads=int(eng.prof["n_hit_reads"]))
    if not (row["compacted_batches"] and row["comp_cap"]):
        raise AssertionError(f"uniform world: compaction never engaged {row}")
    row["bam_records"] = same_bam(on, off, "uniform world, compacted vs not")
    log(f"uniform world: {row['reads']} reads at -b {batch}, "
        f"{row['hit_reads']} with a hit; {row['compacted_batches']} of "
        f"{row['batches']} batches compacted (budget {row['comp_cap']} rows "
        f"of {2 * batch}); {row['bam_records']} BAM records identical to the "
        "uncompacted run")


def main():
    t_start = time.perf_counter()
    secs = {}
    t = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        f"{torch.cuda.device_count()} device(s)")
    secs["card"] = time.perf_counter() - t

    from pansvr_tpu_torch import _build, world
    from pansvr_tpu_torch.align.engine import AlignEngine
    t = time.perf_counter()
    _build.load_kernels()
    secs["build"] = time.perf_counter() - t
    log(f"kernels built in {_build.build_seconds:.1f} s -> "
        f"{os.path.relpath(_build.library_path(), REPO)}")
    log("ptxas (sm_90a): " + "; ".join(ptxas_summary(_build.build_log)))

    t = time.perf_counter()
    rows = kernel_parity(dev)
    secs["kernel_parity"] = time.perf_counter() - t

    launches = {}
    with tempfile.TemporaryDirectory(prefix="pansvr_smoke_") as tmp:
        t = time.perf_counter()
        w = world.build_bench_world(os.path.join(tmp, "world"))
        n_reads = sum(1 for _ in open(w["signal"])) // 4
        secs["world"] = time.perf_counter() - t
        log(f"world: {n_reads} signal reads, index {w['n_kmers']} k-mers / "
            f"{w['n_unitigs']} unitigs ({secs['world']:.1f} s)")

        t = time.perf_counter()
        bench = bench_passes(w, tmp, dev, launches, n_reads)
        secs["fc_aln"] = time.perf_counter() - t
        main_prof = bench[CONFIGS[0][0]]["prof"]
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log(f"kernel launches per path: {launches}; bench host fallback "
            f"{int(main_prof['n_fallback'])} of {int(main_prof['n_hit_reads'])}"
            f" reads with a k-mer hit (+{int(main_prof['n_oversize'])} "
            f"oversize); peak host RSS {rss_kb / 2**10:.1f} MiB")

        t = time.perf_counter()
        sync_counts(w, dev)
        secs["syncs"] = time.perf_counter() - t

        t = time.perf_counter()
        fq16 = os.path.join(tmp, "head.fq")
        world.head_signal(w["signal"], fq16, N_BAM_PARITY)
        cpu_bam = os.path.join(tmp, "head_cpu.bam")
        fc_aln(w, fq16, cpu_bam, "cpu")
        for name, cfg in CONFIGS:
            gpu_bam = os.path.join(tmp, f"head_{name}.bam")
            fc_aln(w, fq16, gpu_bam, "cuda", **cfg)
            n_rec = same_bam(cpu_bam, gpu_bam, f"first {N_BAM_PARITY} reads, "
                             f"--device cpu vs cuda {name}")
        secs["parity_bam"] = time.perf_counter() - t
        log(f"first {N_BAM_PARITY} reads: {n_rec} BAM records identical "
            f"between the plain CPU path and the card in both configurations "
            f"({secs['parity_bam']:.1f} s)")

        t = time.perf_counter()
        seqs, oris = world.read_batch(w["signal"], N_HOST_PARITY)
        geng = AlignEngine(world.load_index(w["index"]),
                           ori_chrom_names=world.header_names(w["header"]),
                           device="cuda")
        n_with = host_parity(geng, seqs, oris)
        secs["parity_host"] = time.perf_counter() - t
        log(f"first {N_HOST_PARITY} reads: card engine == NumPy host aligner "
            f"({n_with} reads with alignments)")

        t = time.perf_counter()
        overflow_phase(w, tmp, dev, launches)
        secs["overflow"] = time.perf_counter() - t

        t = time.perf_counter()
        uniform_phase(w, tmp, dev, launches)
        secs["uniform"] = time.perf_counter() - t

    # phase 10
    for path, counts in launches.items():
        for k in ("extd2_fwd", "extd2_tb"):
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on path {path}")
    total = {k: sum(c[k] for c in launches.values())
             for k in ("extd2_fwd", "extd2_tb")}
    hit = max(int(main_prof["n_hit_reads"]), 1)
    if main_prof["n_fallback"] > MAX_FALLBACK * hit:
        raise AssertionError(
            f"host fallback {int(main_prof['n_fallback'])} > "
            f"{MAX_FALLBACK:.0%} of {hit} reads with a hit")
    jax_mods = sorted(m for m, mod in list(sys.modules.items())
                      if m.split(".")[0] in ("jax", "pansvr_tpu")
                      and mod is not None)
    if jax_mods:
        raise AssertionError(f"the run imported JAX or the JAX package: "
                             f"{jax_mods[:5]}")
    log("no module of JAX or of the JAX package (pansvr_tpu) was imported")
    secs["total"] = time.perf_counter() - t_start
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in secs.items()}))

    main_row = next(r for r in rows if r["shape"] == MAIN_SHAPE)
    main_launches = launches[f"bench_{CONFIGS[0][0]}"]
    per_pass = per_pass_ms(rows, LAUNCH_SHAPES[f"bench_{CONFIGS[0][0]}"])
    print(json.dumps({"kernels": [
        {"name": "extd2_fwd", "route": "cuda",
         "source": "pansvr_tpu_torch/csrc/extd2_fwd.cu",
         "replaces": "pansvr_tpu/ops/extd2_pallas.py:74",
         "launches": main_launches["extd2_fwd"],
         "max_abs_err": max(r["fwd_err"] for r in rows),
         "ms": main_row["fwd_ms"], "kernel_ms": main_row["fwd_kernel_ms"],
         "plain_ms": main_row["fwd_plain_ms"],
         "bound_ms": main_row["fwd_bound_ms"],
         "bound_by": main_row["fwd_bound_by"], "library_ms": None,
         "per_pass_ms": per_pass["extd2_fwd"]},
        {"name": "extd2_tb", "route": "cuda",
         "source": "pansvr_tpu_torch/csrc/extd2_tb.cu",
         "replaces": "pansvr_tpu/ops/extd2_pallas.py:484",
         "launches": main_launches["extd2_tb"],
         "max_abs_err": max(r["tb_err"] for r in rows),
         "ms": main_row["tb_ms"], "kernel_ms": main_row["tb_kernel_ms"],
         "plain_ms": main_row["tb_plain_ms"],
         "bound_ms": main_row["tb_bound_ms"],
         "bound_by": main_row["tb_bound_by"], "library_ms": None,
         "per_pass_ms": per_pass["extd2_tb"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
