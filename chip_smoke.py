#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (pansvr_tpu_torch): fc_aln,
the on-card self-check, fc_sv, the whole pipeline (`run`), the fc_aln
fan-out, the chromosome-scale world and the genome world (first level 14) on one
card.

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
             the class (EngineConfig.dp_classes: full and residue
             chunks), on the first problems of the set: K1 and K2
             bit-exact vs plain, each kernel alone, K1's bound (from those
             problems' band cells), K2's walk and bound
  4 world    the fc_aln benchmark world (seed 123, 250k pairs, ~379k
             signal reads; genome and anchor FASTA for fc_sv) in a temporary
             directory
  5 fc_aln   the port's CLI entry point on the whole world at -b 8192 in
             three engine configurations: stream depth 3 with device
             collect (the defaults: each batch's front + chain + collect
             and each DP chunk replayed as CUDA graphs), depth 1 with host
             collect, and the first enqueued op by op (fuse_chain=False);
             one warm-up pass each, then N_TIMED timed passes each, taken
             in turns (each printed, the median is the result; the split host
             timers, CUDA graph captures with their seconds and replays,
             peak GPU memory allocated and reserved, kernel launches per
             pass by DP shape); the three give identical BAM records, and
             the first and the op-by-op one the same launch table
  6 syncs    one 8,192-read batch per configuration, after three warm-up
             batches (every graph captured), under
             torch.cuda.set_sync_debug_mode("warn"): the stream syncs
             PyTorch reports, beside the engine's own event waits and the
             batch's graph replays and captures; then a depth-3 pass over
             the first N_PROFILED reads with and without graphs, each with
             torch.profiler started after the engine build: the card's
             busy time and idle share, device kernels and CUDA runtime
             calls a batch
  7 parity   first 16,384 reads: --device cpu (plain kernels) and cuda in
             all three configurations give identical BAM records; first
             1,024 reads: the card engine's alignments equal the NumPy host
             aligner's, field by field
 7b front    the front's kernels (csrc/front.cu through ops/front_cuda.py)
             at the widest batch and the largest 48x64 DP chunk of the
             default configuration's pass of phase 7, kept as they ran
             (align/kernel_table.py): front_program, the host-collect
             pack, a re-chain at full width and the DP chunk bit-exact vs
             the plain programs on the card; each entry point's wrapper
             time, its kernels alone, its bytes bound and the plain
             program's time (pansvr_front, pansvr_chain, pansvr_collect,
             and pansvr_dp_glue: fill, walk start and packing, timed with
             K1 and K2 inside)
  8 overflow every read on target (world.build_overflow_world, 32,768
             reads): the first batch overflows the default lane pool, the
             engine widens and re-dispatches; final host fallback <= 5%
             of the reads with a hit; cpu and cuda (with and without CUDA
             graphs) BAM records identical on the first 16,384 reads
  9 uniform  reads uniform over a genome (world.build_uniform_world,
             24,576 reads at -b 2048): the compaction budget engages and
             the BAM records equal an uncompacted run's and an op-by-op
             run's
 10 onchip   ops.onchip_check.run_onchip_parity on the card: K1 + K2 vs the
             scalar oracle, realigner and contig profiles at 176x256/W256
 11 fc_sv    the port's fc_sv entry point (--device cuda) on the bench
             world's BAM of the last timed depth-3 pass: its VCF records equal
             an fc_sv with the inline native DP on the same inputs, at least
             one PASS; SV regions, DP requests (and those the card does not
             take), chunks, wall of plan / dp.run / finish in both modes, peak
             host RSS and GPU memory; K1 and K2 bit-exact vs plain on the
             pass's first chunk, and alone at each chunk size it launched
 12 run      run_pipeline(device="cuda") on tests/test_pipeline.py's world
             (seed 77, 4 DEL/INS, 1,600 pairs on 200 kbp): result.vcf equals
             a second S5 over its realigned.bam with the inline DP, and at
             least half the planted SVs come back within 40 bp
 13 multi    the fc_aln fan-out on the bench world with one card:
             parallel.aln_shard.run_aln_fanout with two fc_aln worker
             processes sharing the card (-b 8192, engine_tune.json dropped
             first), its merged BAM record-identical to the last depth-3
             pass's, its wall and reads/s beside the depth-3 median and the
             host's CPU count
 14 chrom    the chromosome-scale world (world.build_chrom_world's recipe:
             seed 99, 2,000 DEL/INS/DUP SVs on chr1 60 Mbp + chr2 40 Mbp,
             error 0.01, auto first level) with its pairs cut to
             N_CHROM_PAIRS, built by scale_run's gen, anchor, index and
             signal stages (a process each); fc_aln on the card, host
             fallback <= 5% of the reads with a hit, its split host
             timers and graph counters; the same pass op by op gives
             identical BAM records and keys the same shape sets, with one
             capture a shape set and no graph evicted (captures, replays
             and reserved memory logged); the first 16,384 reads (or all)
             give identical BAM records on the CPU and the card in all
             three configurations; sort + BAI; fc_sv on the card, its VCF
             records equal the inline native DP's
 15 genome   the genome world (world.build_genome_world's recipe: seed
             2024, DEL/INS/DUP SVs on 24 chromosomes of 16 Mbp, error
             0.01, index at the reference's first level 14) cut to
             N_GENOME_SVS SVs and N_GENOME_PAIRS pairs, built by scale_run
             --world genome's gen, anchor, index and signal stages (a
             process each): the full 4^14 bucket table and ~4.7M k-mers;
             fc_aln on the card (reads/s, device index bytes, host
             fallback <= 5% of the reads with a hit, split host timers and
             graph counters; the same pass op by op as in phase 14, then
             phase 6's profiled passes on its reads);
             (a) the first 8,192 reads give identical BAM records on the
             CPU and the card in all three configurations, and phase 7b
             at the default configuration's batch there; (e) the same
             reads on the card over an
             index of the same anchors at the auto first level give them
             too; sort + BAI; fc_sv through the region fan-out with two
             workers on the card, its VCF records equal one fc_sv's on
             the card over every region, PASS counted
 16 checks   both kernels launched in every counted path above (fc_aln
             paths, fc_sv, run, the chromosome and genome worlds' fc_aln
             and fc_sv; counters reset just before each
             path and read just after), and the front's entry points in
             every path that runs fc_aln (pansvr_collect but in the host
             collect's) and in none of fc_sv's; host fallback <= 5% of the reads
             with a k-mer hit on the bench world; no module of JAX or of
             the JAX package (pansvr_tpu) imported
Prints a {"kernels": [...]} line (per kernel at the main shape: "ms" the
wrapper's time, "kernel_ms" the raw launch's, "bound_ms" from this run's
band cells, "per_pass_ms" the launches of a default fc_aln pass, each at
its DP class and problem count, times the kernel alone there;
"fc_sv_launches" those of phase 11's pass, "fc_sv_kernel_ms" the kernel
alone on its first chunk, "chrom_launches" and
"chrom_fc_sv_launches" those of phase 14's fc_aln and fc_sv,
"genome_launches" and "genome_fc_sv_launches" those of phase 15's;
for the front's entry points "ms", "kernel_ms", "bound_ms", "plain_ms"
at the bench world's batch (phase 7b) and "genome_*" at the genome
world's, and their launches in the same paths), then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from pansvr_tpu_torch.ops.kernel_bounds import (  # noqa: E402
    HBM_BYTES_PER_S, ISSUE_LANES_PER_SM, cuda_ms, int_ops_per_s, k1_bound,
    k2_bound)
# -b of fc_aln, the parity read counts, the fallback limit and the timed
# engine configurations: (name, EngineConfig fields); OPS_CONFIG, the last
# of them, is the first enqueued op by op (fuse_chain=False) instead of
# replaying its per-batch CUDA graphs: timed in the same turns as the
# others (phase 5) and held to the same BAM records wherever they are
# compared
from pansvr_tpu_torch.scale_run import (  # noqa: E402
    BATCH, CONFIGS, MAX_FALLBACK, N_BAM_PARITY, N_HOST_PARITY, OPS_CONFIG,
    graph_report, profiled_fc_aln, same_records)

# the configurations with CUDA graphs
GRAPH_CONFIGS = tuple(c for c in CONFIGS if c != OPS_CONFIG)
# reads of the profiled passes (profiler started after the engine build)
N_PROFILED = 65_536
# the engine's host timers and graph counters every fc_aln pass reports
SPLIT = ("prep_wait", "front_enqueue", "host_submit",
         "dp_layout", "dp_enqueue", "dp_dispatch", "sync_chain", "sync_dp",
         "host_collect", "host_replay", "prep_s", "stream_s")

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
# timed fc_aln passes after the warm-up (the median, of two the slower,
# is reported); cut from 3 to keep the script near half its time limit
# since the scale phases run their passes twice
N_TIMED = 2
N_OVERFLOW = 32_768
N_UNIFORM_PAIRS = 12_288
UNIFORM_BATCH = 2048
# phase 12's world: tests/test_pipeline.py's recipe
RUN_WORLD = dict(seed=77, n_sv=4, n_pairs=1600, types=("DEL", "INS"),
                 chrom_lengths={"chr1": 200_000}, err_rate=0.0)
# phase 13: fc_aln worker processes of the fan-out (on the one card)
N_FANOUT = 2
# phase 14: read pairs of the chromosome-scale world (its 100 Mbp genome
# and 2,000 SVs whole), cut so that the phase takes about 2 min
N_CHROM_PAIRS = 80_000
# phase 15: the genome world (24 chromosomes of 16 Mbp, index at first
# level 14) cut to 4,000 SVs and 80,000 pairs (about 2 min); reads of its
# parity checks (a) and (e); fc_sv fan-out workers
N_GENOME_SVS = 4000
N_GENOME_PAIRS = 80_000
N_GENOME_PARITY = 8192
N_GENOME_SV_SHARDS = 2


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


class RssPeak:
    """Resident set size of this process when the block starts and its
    peak while the block runs, sampled from /proc/self/statm every 10 ms
    (bytes)."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _now(self):
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page

    def _loop(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._now())


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
    """Problem counts the engine launches K1 and K2 at for a (Q, T) DP
    class: the full and the residue chunk of EngineConfig.dp_classes, for
    the read class of the bench world (160) and the next one (256)."""
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
        k1 = k1_bound(n_cells, B, Q, T, W, n_diag_pad, state16, int_rate)
        k2 = k2_bound(B, steps, n_diag_pad)
        # the engine's chunk sizes of the class, on the first n problems
        by_n = {}
        for n in main_sizes(Q, T):
            sl = slice(0, n)
            fwd_in = (qc[sl], ql[sl], tc[sl], tl[sl], params, W)
            f_n = ec.extd2_fwd(*fwd_in)
            f_want = ec.extd2_fwd_plain(*fwd_in)
            tb_args = (got.dmat[sl], ql[sl], tl[sl], i0[sl], j0[sl], params,
                       W, n_diag_pad, T)
            got_n = ec.extd2_traceback(*tb_args)
            want_n = ec.extd2_traceback_plain(*tb_args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(f_n, f_want)):
                raise AssertionError(f"extd2_fwd {Q}x{T} at {n} problems "
                                     "differs from the plain version")
            if not all(torch.equal(a, b) for a, b in zip(got_n, want_n)):
                raise AssertionError(f"extd2_tb {Q}x{T} at {n} problems "
                                     "differs from the plain version")
            w_n = (got_n[0] != 3).sum(1)
            s_n = int(w_n.sum().item())
            by_n[n] = dict(
                fwd_kernel_ms=cuda_ms(ec.fwd_raw_launcher(
                    qc[sl], ql[sl], tc[sl], tl[sl], params, W), 20),
                tb_kernel_ms=cuda_ms(ec.tb_raw_launcher(*tb_args), 20),
                fwd_bound_ms=k1_bound(int(cells[sl].sum().item()), n, Q, T,
                                      W, n_diag_pad, state16, int_rate)[0],
                tb_steps=s_n, tb_longest=int(w_n.max().item()),
                tb_bound_ms=k2_bound(n, s_n, n_diag_pad)[0])
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
            log(f"  at {n} problems (an engine chunk): K1 and K2 "
                f"bit-exact vs plain; K1 alone "
                f"{v['fwd_kernel_ms']:.4f} ms, bound {v['fwd_bound_ms']:.4g} "
                f"ms = {v['fwd_bound_ms'] / v['fwd_kernel_ms']:.1%}; K2 alone "
                f"{v['tb_kernel_ms']:.4f} ms, {v['tb_steps']} diagonals "
                f"walked, longest walk {v['tb_longest']}, bound "
                f"{v['tb_bound_ms']:.4g} ms = "
                f"{v['tb_bound_ms'] / v['tb_kernel_ms']:.1%}")
        rows.append(row)
    if not any(r["zdropped"] for r in rows) or \
            not any(r["band_dead"] for r in rows):
        raise AssertionError("parity problems hit no z-drop or no dead band")
    return rows


def per_pass_ms(rows, shapes, n_passes, what):
    """{kernel: ms} of one pass of a counted path: its launches by (Tmax,
    W, problems) over its n_passes passes, each times the kernel alone at
    that class and count (phase 3); a size phase 3 did not time is logged
    and left out."""
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
            ms += count / n_passes * alone[(t, W, n)][field]
        out[kernel] = ms
    log("per-pass kernel ms (launches x time alone at the launched size, "
        f"{what}): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out



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
# phase 7b's rows by world (align/kernel_table.time_batch)
FRONT_ROWS: dict = {}
# the front's entry points (ops/front_cuda.py) as extd2_cuda counts them
FRONT_ENTRIES = ("pansvr_front", "pansvr_chain", "pansvr_collect",
                 "pansvr_dp_fill", "pansvr_dp_start", "pansvr_dp_pack")


def split_line(p) -> str:
    """The engine's split host timers (s) and graph counters of a pass."""
    return (", ".join(f"{k} {p.get(k, 0.0):.3f}" for k in SPLIT)
            + f"; CUDA graphs: {int(p.get('n_graph_capture', 0))} captures "
            f"in {p.get('graph_capture_s', 0.0):.3f} s (warm-ups "
            f"{p.get('graph_warmup_s', 0.0):.3f} s), "
            f"{int(p.get('n_graph_replay', 0))} replays in "
            f"{p.get('graph_replay_s', 0.0):.3f} s, "
            f"{int(p.get('n_graph_evict', 0))} evicted")


def counted(launches, name, fn):
    """Run fn with the kernel launch counters set to 0 just before and
    read just after; the counts (K1, K2 and the front's entry points) add
    up under launches[name] (and by DP shape under LAUNCH_SHAPES[name])."""
    from pansvr_tpu_torch.ops import extd2_cuda as ec

    ec.reset_launches()
    out = fn()
    acc = launches.setdefault(
        name, dict.fromkeys((*ec.LAUNCHES, *FRONT_ENTRIES), 0))
    for k, v in {**ec.LAUNCHES, **ec.FRONT_LAUNCHES}.items():
        acc[k] += v
    by = LAUNCH_SHAPES.setdefault(name, {})
    for k, v in ec.LAUNCHES_BY_SHAPE.items():
        by[k] = by.get(k, 0) + v
    return out


def front_kernel_phase(kept, what):
    """Phase 7b: the front's kernels on the card at the batch and DP
    chunk `kept` (align/kernel_table.keep_batch) from `what`'s fc_aln
    pass: every output bit-exact vs the plain programs, then one row an
    entry point (FRONT_ROWS[what])."""
    from pansvr_tpu_torch.align.kernel_table import check_batch, time_batch

    if "shapes" not in kept or "dp" not in kept:
        raise AssertionError(f"{what}: no front or DP chunk was kept")
    compared = check_batch(kept)
    if "dp_program" not in compared:
        raise AssertionError(f"{what}: the DP chunk was not compared")
    rows = FRONT_ROWS[what] = time_batch(kept)
    sh = rows[0]["shapes"]
    log(f"{what} front kernels (phase 7b) at its widest batch {sh} "
        f"({rows[0]['lanes']} MEM lanes, index of {rows[0]['n_kmer']} "
        f"k-mers) and DP chunk {rows[-1].get('dp_shape')}: outputs "
        f"bit-exact vs the plain programs {compared}; " + "; ".join(
            f"{r['name']} {r['ms']:.4f} ms (kernels alone "
            f"{r['kernel_ms']:.4f}, bound {r['bound_ms']:.6f}, plain "
            f"{r['plain_ms']:.4f}"
            + (f", K1 + K2 {r['k1_k2_ms']:.4f}" if "k1_k2_ms" in r else "")
            + ")" for r in rows))
    log(f"{what} front kernels alone (ms a call): "
        + "; ".join(f"{r['name']} {r['kernels']}" for r in rows))
    return rows


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
    res = {name: dict(walls=[], peak_mib=0.0, reserved_mib=0.0)
           for name, _ in CONFIGS}
    for _ in range(n_timed):
        for name, cfg in CONFIGS:
            r = res[name]
            out = os.path.join(tmp, f"{name}.bam")
            if cuda:
                # the pass's own peaks: earlier engines' graph pools and
                # cached blocks released first
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            eng = counted(launches, f"bench_{name}",
                          lambda: fc_aln(w, w["signal"], out, dev.type, **cfg))
            if cuda:
                torch.cuda.synchronize()
                r["peak_mib"] = max(r["peak_mib"],
                                    torch.cuda.max_memory_allocated() / 2**20)
                r["reserved_mib"] = max(
                    r["reserved_mib"], torch.cuda.max_memory_reserved() / 2**20)
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
            f"{r['peak_mib']:.1f} MiB allocated, {r['reserved_mib']:.1f} MiB "
            "reserved")
        log(f"split host timers of the last {name} pass (s): "
            + split_line(r["prof"]))
        log(f"engine phases of the last {name} pass (s) and counts: "
            f"{r['prof']}")
        per_pass = {f"{k} Tmax={t} W={W} B={b}": n / n_timed
                    for (k, t, W, b), n
                    in sorted(LAUNCH_SHAPES.get(f"bench_{name}", {}).items())}
        log(f"kernel launches per {name} pass by DP class and problem "
            f"count (target width Tmax: 64 = 48x64, 128 = 96x128, 256/352 = "
            f"the read class's 176x256 / 272x352): {per_pass}")
    names = list(res)
    for b in names[1:]:
        n = same_bam(res[names[0]]["bam"], res[b]["bam"],
                     f"fc_aln {names[0]} vs {b}")
    log(f"{', '.join(names)}: {n} BAM records identical")
    graphs, ops = f"bench_{CONFIGS[0][0]}", f"bench_{OPS_CONFIG[0]}"
    if LAUNCH_SHAPES[graphs] != LAUNCH_SHAPES[ops]:
        raise AssertionError(
            f"kernel launches differ with and without CUDA graphs: "
            f"{LAUNCH_SHAPES[graphs]} vs {LAUNCH_SHAPES[ops]}")
    log(f"kernel launch table identical with CUDA graphs ({graphs}) and op "
        f"by op ({ops}): {launches[graphs]} over {n_timed} passes each; "
        f"reads/s graphs / op by op "
        f"{res[CONFIGS[0][0]]['reads_per_s'] / res[OPS_CONFIG[0]]['reads_per_s']:.4f}")
    return res


def profiled_phase(w, tmp, dev, what, n_reads=N_PROFILED,
                   configs=(CONFIGS[0], OPS_CONFIG)):
    """One depth-3 pass over the first n_reads reads of a world per
    CUDA-graph mode (graphs, then op by op), each with torch.profiler
    started after the engine is built: the card's busy time and idle
    share over the stream, its device kernels and the host's CUDA
    runtime calls a batch. Returns {config: summary}."""
    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.align.engine import EngineConfig

    head = os.path.join(tmp, f"prof_{what}.fq")
    n = world.head_signal(w["signal"], head, n_reads)
    out = {}
    for name, cfg in configs:
        drop_tuning(w)
        r = profiled_fc_aln([
            "fc_aln", w["index"], head, w["header"], "-o",
            os.path.join(tmp, f"prof_{what}_{name}.bam"), "-r", w["status"],
            "-b", str(BATCH), "--device", dev.type], EngineConfig(**cfg))
        b = max(r["batches"], 1)
        calls = r["runtime_calls"]
        launch_calls = sum(v[0] for k, v in calls.items()
                           if "Launch" in k or "Memcpy" in k or "Memset" in k)
        log(f"profiled pass ({what}, {name}, {n} reads, {r['batches']} "
            f"batches, profiler started after the engine build): stream "
            f"{r['wall_s']:.3f} s, card busy {r['busy_s']:.3f} s, idle "
            f"share {r['idle_share']:.1%}; {r['kernels']} device kernels = "
            f"{r['kernels'] / b:.0f} a batch; {launch_calls / b:.0f} CUDA "
            f"launch/copy calls a batch; {r['n_graph_capture']} captures, "
            f"{r['n_graph_replay']} replays; runtime calls [count, ms] "
            f"{calls}; host operations by own CPU time [name, count, ms] "
            f"{r['top_host']}")
        out[name] = dict(r, reads=n)
    return out


def sync_counts(w, dev, n=BATCH, configs=GRAPH_CONFIGS) -> dict:
    """Phase 6: stream syncs PyTorch reports for one n-read batch per
    configuration (after three warm-up batches), and the engine's event
    waits. Returns {config: (syncs,
    captures in that batch)}."""
    import torch

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig

    seqs, oris = world.read_batch(w["signal"], 2 * n)
    idx = world.load_index(w["index"])
    names = world.header_names(w["header"])
    out = {}
    for name, cfg in configs:
        eng = AlignEngine(idx, ori_chrom_names=names, device=dev,
                          config=EngineConfig(**cfg))
        for _ in range(3):     # K settles and every shape set is captured
            eng.align_batch(seqs[:n], oris[:n])
        waits0 = eng.prof["n_event_waits"]
        cap0, rep0 = eng.prof["n_graph_capture"], eng.prof["n_graph_replay"]
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
        caps = int(eng.prof["n_graph_capture"] - cap0)
        reps = int(eng.prof["n_graph_replay"] - rep0)
        log(f"syncs {name}: {len(msgs)} synchronizing operations reported "
            f"by torch.cuda.set_sync_debug_mode in one {n}-read batch "
            f"({reps} CUDA graph replays, {caps} captures), {waits} event "
            "waits" + (f"; first: {msgs[0][:160]}" if msgs else ""))
        out[name] = (len(msgs), caps)
    return out


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
    for device, cfg in (("cpu", {}), (dev.type, {}),
                        (dev.type, dict(fuse_chain=False))):
        drop_tuning(ov)
        bams.append(os.path.join(tmp, f"ovf_head_{device}_{len(bams)}.bam"))
        e = fc_aln(ov, head, bams[-1], device, batch, **cfg)
        if not e.prof["n_retry"]:
            raise AssertionError(f"overflow head on {device}: no retry")
    for b in bams[1:]:
        row["bam_records"] = same_bam(bams[0], b, f"overflow world, first "
                                      f"{n_head} reads, cpu vs {b}")
    log(f"overflow world, first {n_head} reads: {row['bam_records']} BAM "
        "records identical between cpu and cuda with and without CUDA "
        "graphs (all widened); the full pass: " + split_line(p))


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
    ops = os.path.join(tmp, "uni_ops.bam")
    drop_tuning(uw)
    fc_aln(uw, uw["signal"], ops, dev.type, batch, fuse_chain=False)
    row = dict(reads=2 * n_pairs, batches=int(eng.prof["n_batches"]),
               compacted_batches=int(eng.prof["n_compacted"]),
               comp_cap=eng._comp_cap,
               hit_reads=int(eng.prof["n_hit_reads"]))
    if not (row["compacted_batches"] and row["comp_cap"]):
        raise AssertionError(f"uniform world: compaction never engaged {row}")
    row["bam_records"] = same_bam(on, off, "uniform world, compacted vs not")
    same_bam(on, ops, "uniform world, CUDA graphs vs op by op")
    log(f"uniform world: {row['reads']} reads at -b {batch}, "
        f"{row['hit_reads']} with a hit; {row['compacted_batches']} of "
        f"{row['batches']} batches compacted (budget {row['comp_cap']} rows "
        f"of {2 * batch}); {row['bam_records']} BAM records identical to the "
        "uncompacted run and to the op-by-op run; " + split_line(eng.prof))


def onchip_phase(dev):
    """Phase 10: the port's self-check on the card."""
    from pansvr_tpu_torch.ops.onchip_check import run_onchip_parity

    out = run_onchip_parity(quick=False, device=dev.type)
    if not (out["extd2_aln"] and out["extd2_sv"]):
        raise AssertionError(f"onchip self-check checked no case: {out}")
    log(f"onchip self-check passed on the card, cases per profile: {out}")
    return out



def fc_sv_phase(w, bam, tmp, dev, launches, int_rate):
    """Phase 11: the port's fc_sv entry point with the contig DP on the
    card, against the inline native DP (ContigDpBatcher(INLINE)) on the
    same inputs; then K1 and K2 on the pass's first
    chunk (bit-exact vs plain) and alone at each chunk size it launched.
    Returns the phase's summary."""
    import torch

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.assembly.sv_call import (
        CONTIG_PARAMS, INLINE, ContigDpBatcher, run_sv_calling)
    from pansvr_tpu_torch.cli.main import fc_sv_inputs, parse_args, run_fc_sv
    from pansvr_tpu_torch.ops import extd2_cuda as ec
    from pansvr_tpu_torch.ops.extd2 import plan

    cuda = dev.type == "cuda"
    out_vcf = os.path.join(tmp, "fc_sv.vcf")
    args = parse_args(["fc_sv", w["anchors"], bam, w["genome"], "-o", out_vcf,
                       "-r", w["status"], "--device", dev.type])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t = time.perf_counter()
        verdicts, dp = counted(launches, "fc_sv", lambda: run_fc_sv(args))
        wall = time.perf_counter() - t
    modes = {"card": dict(
        wall_s=wall, rss_mib=rss.peak / 2**20,
        rss_grow_mib=(rss.peak - rss.start) / 2**20,
        gpu_mib=torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0,
        **dp.prof)}
    inline = ContigDpBatcher(INLINE)
    with RssPeak() as rss:
        t = time.perf_counter()
        verdicts_i, recs_i = run_sv_calling(bam, *fc_sv_inputs(args),
                                            dp=inline)
        wall = time.perf_counter() - t
    modes["inline"] = dict(wall_s=wall, rss_mib=rss.peak / 2**20,
                           rss_grow_mib=(rss.peak - rss.start) / 2**20,
                           **inline.prof)
    got = world.vcf_body(out_vcf)
    n_pass = sum(v.passed for v in verdicts)
    if got != [r.to_line() for r in recs_i] or len(verdicts) != len(verdicts_i):
        raise AssertionError(f"fc_sv: {len(got)} VCF records on the card, "
                             f"{len(recs_i)} with the inline DP; they differ")
    if not n_pass:
        raise AssertionError("fc_sv on the bench world: no PASS record")
    p = dp.prof
    log(f"fc_sv (bench world, {os.path.basename(bam)}): {len(verdicts)} SV "
        f"regions, {n_pass} PASS, {len(got)} VCF records identical to the "
        f"inline native DP's; {p['n_requests']} contig DP requests "
        f"({p['n_requests'] / len(verdicts):.1f} per SV region), "
        f"{p['n_scalar']} longer than Q={dp.Q} / T={dp.T} or empty (scalar "
        f"DP), {p['n_chunks']} chunks of {p['chunks']} problems")
    for name, m in modes.items():
        dp_s = m["run_s"] + (m["scalar_s"] if name == "inline" else 0.0)
        log(f"fc_sv {name}: wall {m['wall_s']:.3f} s = plan {m['plan_s']:.3f}"
            f" + dp.run {m['run_s']:.3f} + finish {m['finish_s']:.3f} (+ the "
            f"VCF write); DP {dp_s:.3f} s = {dp_s / m['wall_s']:.1%} of the "
            f"wall (inline: the scalar DPs inside plan); peak host RSS of "
            f"the process {m['rss_mib']:.1f} MiB (+{m['rss_grow_mib']:.1f} "
            f"MiB over the phase's start)"
            + (f", peak GPU memory {m['gpu_mib']:.1f} MiB; run(): "
               + ", ".join(f"{k} {m[k]:.4f}" for k in (
                   "pack_s", "upload_s", "fwd_s", "tb_s", "readback_s",
                   "cigar_s", "scalar_s")) if name == "card" else ""))

    # the kernels on the pass's own requests
    Q, T, W, params = dp.Q, dp.T, dp.W, CONTIG_PARAMS
    n_diag_pad = plan(Q, T, W)[1]
    q, ql, t, tl = dp.upload(dp.first_chunk)
    got_f = ec.extd2_fwd(q, ql, t, tl, params, W)
    ref_f, cells = ec.extd2_fwd_plain_cells(q, ql, t, tl, params, W)
    zd = got_f.zdropped
    i0 = torch.where(~zd, tl - 1, torch.where(got_f.max_t >= 0, got_f.max_t,
                                              -1)).to(torch.int32)
    j0 = torch.where(~zd, ql - 1, torch.where(got_f.max_q >= 0, got_f.max_q,
                                              -1)).to(torch.int32)
    tb_args = (got_f.dmat, ql, tl, i0, j0, params, W, n_diag_pad, T)
    got_t = ec.extd2_traceback(*tb_args)
    ref_t = ec.extd2_traceback_plain(*tb_args)
    if not (all(torch.equal(a, b) for a, b in zip(got_f, ref_f))
            and all(torch.equal(a, b) for a, b in zip(got_t, ref_t))):
        raise AssertionError("fc_sv chunk: K1 or K2 differs from its plain "
                             "version")
    packed = ec.packed_state(params, W)
    by_n = {}
    for n in sorted(set(p["chunks"]), reverse=True):
        sl = slice(0, n)
        walks = (got_t[0][sl] != 3).sum(1)
        sub = tuple(x[sl] for x in tb_args[:5])
        by_n[n] = v = dict(
            launches=p["chunks"].count(n),
            fwd_bound_ms=k1_bound(int(cells[sl].sum().item()), n, Q, T, W,
                                  n_diag_pad, packed, int_rate)[0],
            tb_bound_ms=k2_bound(n, int(walks.sum().item()), n_diag_pad)[0],
            tb_longest=int(walks.max().item()))
        if not cuda:
            continue
        v["fwd_kernel_ms"] = cuda_ms(ec.fwd_raw_launcher(
            q[sl], ql[sl], t[sl], tl[sl], params, W), 20)
        v["tb_kernel_ms"] = cuda_ms(ec.tb_raw_launcher(*sub, *tb_args[5:]), 20)
        log(f"  fc_sv chunk of {n} problems ({Q}x{T} W={W}, {v['launches']} "
            f"launch(es) a pass): K1 alone {v['fwd_kernel_ms']:.4f} ms, bound "
            f"{v['fwd_bound_ms']:.4g} ms = "
            f"{v['fwd_bound_ms'] / v['fwd_kernel_ms']:.1%}; K2 alone "
            f"{v['tb_kernel_ms']:.4f} ms, bound {v['tb_bound_ms']:.4g} ms = "
            f"{v['tb_bound_ms'] / v['tb_kernel_ms']:.1%}, longest walk "
            f"{v['tb_longest']}; both bit-exact vs plain on the first chunk")
    return dict(regions=len(verdicts), n_pass=n_pass, modes=modes, by_n=by_n,
                first=by_n[max(by_n)])


def run_phase(tmp, dev, launches):
    """Phase 12: the whole pipeline on the card against a second S5 with
    the inline DP; the planted SVs must come back."""
    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.assembly.sv_call import (
        INLINE, ContigDpBatcher, run_sv_calling)
    from pansvr_tpu_torch.cli.main import fc_sv_inputs, parse_args
    from pansvr_tpu_torch.io.fasta import write_fasta
    from pansvr_tpu_torch.io.vcf import VCFReader, VCFWriter, minimal_header
    from pansvr_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from pansvr_tpu_torch.utils.simulate import make_dataset, write_sim_bam

    d = os.path.join(tmp, "run")
    os.makedirs(d)
    ds = make_dataset(**RUN_WORLD)
    genome, vcf, bam = (os.path.join(d, f) for f in
                        ("genome.fa", "svs.vcf", "sim.bam"))
    write_fasta(genome, ds.genome.items(), width=60)
    w = VCFWriter(vcf, minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, bam)
    work = os.path.join(d, "work")
    t = time.perf_counter()
    out = counted(launches, "run", lambda: run_pipeline(
        vcf, genome, bam, work, PipelineConfig(first_level_bases=11),
        device=dev.type))
    wall = time.perf_counter() - t
    contig = {k: n for k, n in LAUNCH_SHAPES["run"].items() if k[1] == 704}
    if dev.type == "cuda" and not contig:
        raise AssertionError("run: S5 launched no contig DP on the card")
    args = parse_args(["fc_sv", os.path.join(work, "anchors.fa"),
                       os.path.join(work, "realigned.bam"), genome,
                       "-r", os.path.join(work, "status.txt")])
    _, recs = run_sv_calling(args.bam, *fc_sv_inputs(args),
                             dp=ContigDpBatcher(INLINE))
    if world.vcf_body(out) != [r.to_line() for r in recs]:
        raise AssertionError("run: result.vcf differs from an inline S5 over "
                             "its realigned.bam")
    with VCFReader(out) as rd:
        calls = list(rd)
    hits = sum(any(c.chrom == sv.chrom and abs(c.pos1 - sv.pos1) <= 40
                   and c.sv_type == sv.sv_type for c in calls)
               for sv in ds.svs)
    if hits < len(ds.svs) * 0.5:
        raise AssertionError(f"run: {hits} of {len(ds.svs)} planted SVs "
                             "recovered")
    log(f"run (seed {RUN_WORLD['seed']}, {RUN_WORLD['n_sv']} DEL/INS, "
        f"{RUN_WORLD['n_pairs']} pairs): {wall:.2f} s, {len(calls)} records "
        f"identical to an inline S5, {hits} of {len(ds.svs)} planted SVs "
        f"recovered; launches {launches['run']}, by (kernel, Tmax, W, "
        f"problems) {LAUNCH_SHAPES['run']}")
    return dict(wall_s=wall, records=len(calls), hits=hits)


def multi_phase(w, tmp, dev, bench, n_reads):
    """Phase 13: the fc_aln fan-out with N_FANOUT workers on the card; its
    BAM must equal the last depth-3 pass's. Returns the phase's
    summary."""
    from pansvr_tpu_torch.parallel.aln_shard import run_aln_fanout

    ref = bench[CONFIGS[0][0]]
    n_pr = n_reads // 2 * 2
    out = dict(depth3_reads_per_s=ref["reads_per_s"], cpus=os.cpu_count())

    drop_tuning(w)
    fan = os.path.join(tmp, "fanout.bam")
    parts = {}
    t = time.perf_counter()
    run_aln_fanout(w["index"], w["signal"], w["header"], fan,
                   n_shards=N_FANOUT, status_file=w["status"], batch=BATCH,
                   device=dev.type, prof=parts)
    out["fanout_s"] = time.perf_counter() - t
    out["fanout_reads_per_s"] = n_pr / out["fanout_s"]
    n_rec = same_bam(ref["bam"], fan, f"fan-out of {N_FANOUT} workers vs "
                     "the depth-3 pass")
    log(f"fan-out: {N_FANOUT} fc_aln workers on the one card, -b {BATCH}: "
        f"wall {out['fanout_s']:.3f} s (split {parts['split_s']:.3f} + "
        f"workers {parts['workers_s']:.3f} + merge {parts['merge_s']:.3f}) = "
        f"{out['fanout_reads_per_s']:.1f} reads/s, against the single "
        f"process's depth-3 median {ref['reads_per_s']:.1f} reads/s in this "
        f"call; {os.cpu_count()} CPUs; {n_rec} BAM records identical to the "
        "depth-3 pass's")
    return out


def build_scale_world(d, name, dev, *opts):
    """scale_run's gen, anchor, index and signal stages of world `name`
    (a process each) into d; returns its report."""
    r = subprocess.run(
        [sys.executable, "-m", "pansvr_tpu_torch.scale_run", "--out", d,
         "--world", name, "--device", dev.type, *opts,
         "--stages", "gen,anchor,index,signal"],
        capture_output=True, text=True, cwd=REPO)
    if r.returncode:
        raise AssertionError(f"{name} world: scale_run rc={r.returncode}"
                             f"\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    with open(os.path.join(d, "report.json")) as fh:
        return json.load(fh)


def graphs_vs_ops(w, d, dev, launches, what, eng, aln):
    """Phases 14-15: the world's whole fc_aln pass op by op (OPS_CONFIG,
    from the default lane budgets, counted as path `what`_ops) beside its
    pass with CUDA graphs (the engine `eng`, which wrote `aln`): identical
    BAM records, the same shape sets keyed, one capture a shape set and
    no graph evicted. Returns both passes' graph counters and the op-by-op
    pass's wall and reserved GPU memory."""
    import torch

    cuda = dev.type == "cuda"
    g = graph_report(eng)
    if cuda and not (g["n_graph_capture"] and g["n_graph_replay"]):
        raise AssertionError(f"{what}: the pass replayed no CUDA graph")
    if g["n_graph_evict"]:
        raise AssertionError(f"{what}: {g['n_graph_evict']:.0f} CUDA graphs "
                             f"evicted ({g['n_front_shape_sets']:.0f} front "
                             f"and {g['n_dp_shape_sets']:.0f} DP shape sets)")
    if cuda and g["n_graph_capture"] != (g["n_front_shape_sets"]
                                         + g["n_dp_shape_sets"]):
        raise AssertionError(f"{what}: {g['n_graph_capture']:.0f} captures "
                             "for other than one a shape set")
    ops_bam = os.path.join(d, "aln_ops.bam")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    drop_tuning(w)
    t = time.perf_counter()
    eng_ops = counted(launches, f"{what}_ops", lambda: fc_aln(
        w, w["signal"], ops_bam, dev.type, **OPS_CONFIG[1]))
    if cuda:
        torch.cuda.synchronize()
    ops_s = time.perf_counter() - t
    go = graph_report(eng_ops)
    n = same_records(aln, ops_bam, f"{what}: fc_aln with CUDA graphs vs op "
                     "by op")
    if (go["n_front_shape_sets"], go["n_dp_shape_sets"]) != (
            g["n_front_shape_sets"], g["n_dp_shape_sets"]):
        raise AssertionError(f"{what}: shape sets differ with and without "
                             f"graphs: {g} vs {go}")
    out = dict(ops_s=ops_s,
               ops_reads_per_s=int(eng_ops.prof["n_reads"]) / ops_s,
               ops_reserved_mib=torch.cuda.max_memory_reserved() / 2**20
               if cuda else 0.0, records=n,
               graphs={k: v for k, v in g.items() if k != "shape_set_keys"})
    log(f"{what} fc_aln op by op: {int(eng_ops.prof['n_reads'])} reads in "
        f"{ops_s:.3f} s = {out['ops_reads_per_s']:.1f} reads/s, "
        f"{out['ops_reserved_mib']:.1f} MiB reserved; {n} BAM records "
        f"identical to the pass with CUDA graphs: "
        f"{g['n_graph_capture']:.0f} captures in "
        f"{g['graph_capture_s']:.3f} s (warm-ups "
        f"{g['graph_warmup_s']:.3f} s), {g['n_graph_replay']:.0f} replays in "
        f"{g['graph_replay_s']:.3f} s, {g['n_graph_evict']:.0f} evicted, at "
        f"most {g['n_graph_held_max']:.0f} held; shape sets front "
        f"{g['n_front_shape_sets']:.0f}, DP {g['n_dp_shape_sets']:.0f} "
        "(the same op by op)")
    return out


def chrom_phase(tmp, dev, launches):
    """Phase 14: the chromosome-scale world (world.build_chrom_world's
    recipe whole, N_CHROM_PAIRS read pairs) through scale_run's gen,
    anchor, index and signal stages (a process each), then fc_aln on the
    card (host fallback <= MAX_FALLBACK of the reads with a hit), (a) the
    first N_BAM_PARITY reads on the CPU and the card in both
    configurations give identical BAM records, sort + BAI, fc_sv on the
    card and (c) its VCF records equal the inline native DP's. Returns
    the phase's summary."""
    import torch

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.assembly.sv_call import (
        INLINE, ContigDpBatcher, run_sv_calling)
    from pansvr_tpu_torch.cli.main import fc_sv_inputs, parse_args, run_fc_sv
    from pansvr_tpu_torch.io.bai import build_bai, sort_bam

    d = os.path.join(tmp, "chrom")
    t = time.perf_counter()
    rep = build_scale_world(d, "chrom", dev, "--pairs", str(N_CHROM_PAIRS))
    out = dict(build_s=time.perf_counter() - t, pairs=N_CHROM_PAIRS,
               reads=rep["signal_reads"],
               stages={k: {f: round(v[f], 3)
                           for f in ("wall_s", "peak_rss_gib")}
                       for k, v in rep["stages"].items()})
    w = world.chrom_paths(d)
    log(f"chromosome world ({N_CHROM_PAIRS} pairs, 2,000 SVs on chr1 + chr2):"
        f" {out['reads']} signal reads in {out['build_s']:.1f} s; stage wall "
        f"s and peak RSS GiB {out['stages']}")

    cuda = dev.type == "cuda"
    aln = os.path.join(d, "aln.bam")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = counted(launches, "chrom", lambda: fc_aln(w, w["signal"], aln,
                                                    dev.type))
    if cuda:
        torch.cuda.synchronize()
    out["aln_s"] = time.perf_counter() - t
    p = eng.prof
    hit = max(int(p["n_hit_reads"]), 1)
    out.update(aln_reads_per_s=int(p["n_reads"]) / out["aln_s"],
               hit_reads=hit, fallback=int(p["n_fallback"]),
               widenings=int(p["n_widen"]), retries=int(p["n_retry"]),
               gpu_mib=torch.cuda.max_memory_allocated() / 2**20 if cuda
               else 0.0,
               gpu_reserved_mib=torch.cuda.max_memory_reserved() / 2**20
               if cuda else 0.0)
    log(f"chromosome world fc_aln on the card: {int(p['n_reads'])} reads in "
        f"{out['aln_s']:.3f} s = {out['aln_reads_per_s']:.1f} reads/s; "
        f"{hit} with a k-mer hit, host fallback {out['fallback']} "
        f"({out['fallback'] / hit:.3%}); {out['widenings']} widenings, "
        f"{out['retries']} batch retries, budgets now nf_mult "
        f"{eng.cfg.nf_mult} mem_slots {eng.cfg.mem_slots}; peak GPU memory "
        f"{out['gpu_mib']:.1f} MiB ({out['gpu_reserved_mib']:.1f} MiB "
        f"reserved); launches by (kernel, Tmax, W, problems) "
        f"{LAUNCH_SHAPES['chrom']}")
    out["prof"] = {k: round(v, 4) for k, v in sorted(p.items())}
    log("chromosome world fc_aln split host timers (s): " + split_line(p))
    out["ops"] = graphs_vs_ops(w, d, dev, launches, "chrom", eng, aln)
    if out["fallback"] > MAX_FALLBACK * hit:
        raise AssertionError(f"chromosome world: host fallback "
                             f"{out['fallback']} > {MAX_FALLBACK:.0%} of {hit}")

    head = os.path.join(d, "head.fq")
    n_head = world.head_signal(w["signal"], head, N_BAM_PARITY)
    bams = []
    for device, name, cfg in [("cpu", "default", {})] + [
            (dev.type, name, cfg) for name, cfg in CONFIGS]:
        drop_tuning(w)
        bams.append(os.path.join(d, f"head_{device}_{name}.bam"))
        fc_aln(w, head, bams[-1], device, **cfg)
    for b in bams[1:]:
        out["parity_records"] = same_bam(bams[0], b, f"chromosome world, "
                                         f"first {n_head} reads, cpu vs {b}")
    log(f"chromosome world, first {n_head} reads: {out['parity_records']} "
        "BAM records identical between the plain CPU path and the card in "
        f"{', '.join(n for n, _ in CONFIGS)}")

    srt = os.path.join(d, "aln.sorted.bam")
    sort_bam(aln, srt)
    build_bai(srt)
    vcf = os.path.join(d, "result.vcf")
    args = parse_args(["fc_sv", w["anchors"], srt, w["genome"], "-o", vcf,
                       "-r", w["status"], "--device", dev.type])
    t = time.perf_counter()
    verdicts, dp = counted(launches, "chrom_fc_sv", lambda: run_fc_sv(args))
    out["fc_sv_s"] = time.perf_counter() - t
    inline = ContigDpBatcher(INLINE)
    t = time.perf_counter()
    _, recs = run_sv_calling(srt, *fc_sv_inputs(args), dp=inline)
    out["fc_sv_inline_s"] = time.perf_counter() - t
    got = world.vcf_body(vcf)
    if got != [rec.to_line() for rec in recs]:
        raise AssertionError(f"chromosome world fc_sv: {len(got)} VCF records "
                             f"on the card, {len(recs)} inline; they differ")
    out.update(regions=len(verdicts), n_pass=sum(v.passed for v in verdicts),
               records=len(got), requests=dp.prof["n_requests"],
               chunks=dp.prof["chunks"])
    log(f"chromosome world fc_sv: {out['regions']} SV regions, "
        f"{out['n_pass']} PASS, {out['records']} VCF records identical to "
        f"the inline native DP's; {out['requests']} contig DP requests in "
        f"chunks {out['chunks']}; wall {out['fc_sv_s']:.3f} s on the card "
        f"(plan {dp.prof['plan_s']:.3f}, dp.run {dp.prof['run_s']:.3f}, "
        f"finish {dp.prof['finish_s']:.3f}), {out['fc_sv_inline_s']:.3f} s "
        "inline")
    return out


def genome_phase(tmp, dev, launches):
    """Phase 15: the genome world (world.build_genome_world's recipe on
    its 24 chromosomes, cut to N_GENOME_SVS SVs and N_GENOME_PAIRS read
    pairs, index at first level 14) through scale_run --world genome's
    gen, anchor, index and signal stages (a process each), then fc_aln on
    the card (host fallback <= MAX_FALLBACK of the reads with a hit), (a)
    the first N_GENOME_PARITY reads on the CPU and the card in both
    configurations give identical BAM records, (e) the same reads on the
    card over an index of the same anchors at the auto first level give
    them too, sort + BAI, fc_sv through the region fan-out
    (N_GENOME_SV_SHARDS workers, each with its contig DP on the card),
    whose VCF records equal one fc_sv on the card over every region.
    Returns the phase's summary."""
    import torch

    from pansvr_tpu_torch import world
    from pansvr_tpu_torch.align.kernel_table import keep_batch
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_sv
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.index.store import save_index
    from pansvr_tpu_torch.io.bai import build_bai, sort_bam
    from pansvr_tpu_torch.io.fasta import read_fasta
    from pansvr_tpu_torch.parallel.fanout import run_sv_fanout
    from pansvr_tpu_torch.scale_run import index_tensor_bytes

    d = os.path.join(tmp, "genome")
    t = time.perf_counter()
    rep = build_scale_world(d, "genome", dev, "--svs", str(N_GENOME_SVS),
                            "--pairs", str(N_GENOME_PAIRS))
    ix = rep["stages"]["index"]
    out = dict(build_s=time.perf_counter() - t, pairs=N_GENOME_PAIRS,
               svs=N_GENOME_SVS, reads=rep["signal_reads"],
               first_level=ix["first_level"], n_kmers=ix["n_kmers"],
               stages={k: {f: round(v[f], 3)
                           for f in ("wall_s", "peak_rss_gib")}
                       for k, v in rep["stages"].items()})
    if out["first_level"] != 14:
        raise AssertionError(f"genome world: index at first level "
                             f"{out['first_level']}, not 14")
    w = world.chrom_paths(d)
    log(f"genome world ({N_GENOME_SVS} SVs on 24 chromosomes of 16 Mbp, "
        f"{N_GENOME_PAIRS} pairs): {out['reads']} signal reads, index at "
        f"first level {out['first_level']} with {out['n_kmers']} k-mers, "
        f"built in {out['build_s']:.1f} s; stage wall s and peak RSS GiB "
        f"{out['stages']}")

    cuda = dev.type == "cuda"
    aln = os.path.join(d, "aln.bam")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = counted(launches, "genome", lambda: fc_aln(w, w["signal"], aln,
                                                     dev.type))
    if cuda:
        torch.cuda.synchronize()
    out["aln_s"] = time.perf_counter() - t
    p = eng.prof
    hit = max(int(p["n_hit_reads"]), 1)
    by_tensor = index_tensor_bytes(eng.didx)
    out.update(aln_reads_per_s=int(p["n_reads"]) / out["aln_s"],
               stream_reads_per_s=int(p["n_reads"]) / (
                   out["aln_s"] - p["index_upload"]),
               hit_reads=hit, fallback=int(p["n_fallback"]),
               widenings=int(p["n_widen"]),
               device_index_bytes=sum(by_tensor.values()),
               gpu_mib=torch.cuda.max_memory_allocated() / 2**20 if cuda
               else 0.0,
               gpu_reserved_mib=torch.cuda.max_memory_reserved() / 2**20
               if cuda else 0.0)
    log(f"genome world fc_aln on the card: {int(p['n_reads'])} reads in "
        f"{out['aln_s']:.3f} s = {out['aln_reads_per_s']:.1f} reads/s "
        f"({out['stream_reads_per_s']:.1f} after the index upload's "
        f"{p['index_upload']:.3f} s); {hit} with a k-mer hit, host "
        f"fallback {out['fallback']} ({out['fallback'] / hit:.3%}); "
        f"{out['widenings']} widenings; device index "
        f"{out['device_index_bytes']} bytes ({by_tensor}); peak GPU memory "
        f"{out['gpu_mib']:.1f} MiB ({out['gpu_reserved_mib']:.1f} MiB "
        f"reserved); launches by (kernel, Tmax, W, problems) "
        f"{LAUNCH_SHAPES['genome']}")
    out["prof"] = {k: round(v, 4) for k, v in sorted(p.items())}
    log("genome world fc_aln split host timers (s): " + split_line(p))
    out["ops"] = graphs_vs_ops(w, d, dev, launches, "genome", eng, aln)
    if cuda:
        out["profiled"] = profiled_phase(w, d, dev, "genome")
    if out["fallback"] > MAX_FALLBACK * hit:
        raise AssertionError(f"genome world: host fallback {out['fallback']}"
                             f" > {MAX_FALLBACK:.0%} of {hit}")

    head = os.path.join(d, "head.fq")
    n_head = world.head_signal(w["signal"], head, N_GENOME_PARITY)
    bams = []
    genome_kept = None
    for device, name, cfg in [("cpu", "default", {})] + [
            (dev.type, name, cfg) for name, cfg in CONFIGS]:
        drop_tuning(w)
        bams.append(os.path.join(d, f"head_{device}_{name}.bam"))
        with keep_batch() as kept:
            fc_aln(w, head, bams[-1], device, **cfg)
        if device == "cuda":
            genome_kept = genome_kept or kept
    for b in bams[1:]:
        out["a_records"] = same_bam(bams[0], b, f"genome world (a), first "
                                    f"{n_head} reads, cpu vs {b}")
    if cuda:
        front_kernel_phase(genome_kept, "genome")
        genome_kept = None
    auto = dict(w, index=os.path.join(d, "rdbg_auto"))
    aidx = build_index(list(read_fasta(w["anchors"]).items()),
                       first_level_bases="auto")
    save_index(aidx, auto["index"])
    e_bam = os.path.join(d, "head_auto_level.bam")
    fc_aln(auto, head, e_bam, dev.type, **CONFIGS[0][1])
    out["e_records"] = same_bam(bams[1], e_bam, f"genome world (e), first "
                                f"{n_head} reads, first level 14 vs "
                                f"{aidx.first_level_bases}")
    out["e_levels"] = [14, aidx.first_level_bases]
    log(f"genome world, first {n_head} reads: (a) {out['a_records']} BAM "
        f"records identical between the plain CPU path and the card in "
        f"{', '.join(n for n, _ in CONFIGS)}; (e) {out['e_records']} "
        "identical on the card at "
        f"first levels 14 and {aidx.first_level_bases}")

    srt = os.path.join(d, "aln.sorted.bam")
    sort_bam(aln, srt)
    build_bai(srt)
    fan = os.path.join(d, "result_fanout.vcf")
    t = time.perf_counter()
    run_sv_fanout(w["anchors"], srt, w["genome"], fan, N_GENOME_SV_SHARDS,
                  status_file=w["status"], device=dev.type)
    out["fanout_s"] = time.perf_counter() - t
    vcf = os.path.join(d, "result.vcf")
    args = parse_args(["fc_sv", w["anchors"], srt, w["genome"], "-o", vcf,
                       "-r", w["status"], "--device", dev.type])
    t = time.perf_counter()
    verdicts, dp = counted(launches, "genome_fc_sv", lambda: run_fc_sv(args))
    out["fc_sv_s"] = time.perf_counter() - t
    got = world.vcf_body(fan)
    if got != world.vcf_body(vcf):
        raise AssertionError(f"genome world fc_sv: the fan-out's {len(got)} "
                             f"VCF records differ from one fc_sv's")
    out.update(regions=len(verdicts), n_pass=sum(v.passed for v in verdicts),
               records=len(got),
               fanout_pass=sum(x.split("\t")[6] == "PASS" for x in got))
    log(f"genome world fc_sv: {out['regions']} SV regions, the fan-out "
        f"({N_GENOME_SV_SHARDS} workers, contig DP on the card) "
        f"{out['fanout_pass']} PASS in {out['fanout_s']:.3f} s, its "
        f"{out['records']} VCF records identical to one fc_sv on the card "
        f"({out['n_pass']} PASS, {out['fc_sv_s']:.3f} s: plan "
        f"{dp.prof['plan_s']:.3f}, dp.run {dp.prof['run_s']:.3f}, finish "
        f"{dp.prof['finish_s']:.3f}; chunks {dp.prof['chunks']})")
    return out


def front_kernel_rows(launches) -> list[dict]:
    """The kernels line's rows of the front's entry points: phase 7b's
    times at the bench world's batch and, as genome_*, the genome
    world's; their launches in a default fc_aln pass and in the
    chromosome and genome worlds' passes (pansvr_dp_glue: those of
    pansvr_dp_fill, one a DP chunk as are the walk start and packing)."""
    genome = {r["name"]: r for r in FRONT_ROWS.get("genome", [])}
    out = []
    for r in FRONT_ROWS["bench"]:
        name = r["name"]
        key = "pansvr_dp_fill" if name == "pansvr_dp_glue" else name
        g = genome.get(name, {})
        out.append(dict(
            name=name, route="cuda", source="pansvr_tpu_torch/csrc/front.cu",
            replaces=None, launches=launches[f"bench_{CONFIGS[0][0]}"][key],
            max_abs_err=0, ms=r["ms"], kernel_ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None,
            chrom_launches=launches["chrom"][key],
            genome_launches=launches["genome"][key],
            genome_ms=g.get("ms"), genome_kernel_ms=g.get("kernel_ms"),
            genome_plain_ms=g.get("plain_ms"),
            genome_bound_ms=g.get("bound_ms"),
            **({"k1_k2_ms": r["k1_k2_ms"],
                "genome_k1_k2_ms": g.get("k1_k2_ms")}
               if "k1_k2_ms" in r else {})))
    return out


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
    from pansvr_tpu_torch.align.kernel_table import keep_batch
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
        profiled_phase(w, tmp, dev, "bench")
        secs["profiled"] = time.perf_counter() - t

        t = time.perf_counter()
        fq16 = os.path.join(tmp, "head.fq")
        world.head_signal(w["signal"], fq16, N_BAM_PARITY)
        cpu_bam = os.path.join(tmp, "head_cpu.bam")
        fc_aln(w, fq16, cpu_bam, "cpu")
        bench_kept = None
        for name, cfg in CONFIGS:
            gpu_bam = os.path.join(tmp, f"head_{name}.bam")
            with keep_batch() as kept:
                fc_aln(w, fq16, gpu_bam, "cuda", **cfg)
            bench_kept = bench_kept or kept
            n_rec = same_bam(cpu_bam, gpu_bam, f"first {N_BAM_PARITY} reads, "
                             f"--device cpu vs cuda {name}")
        secs["parity_bam"] = time.perf_counter() - t
        log(f"first {N_BAM_PARITY} reads: {n_rec} BAM records identical "
            f"between the plain CPU path and the card in "
            f"{', '.join(n for n, _ in CONFIGS)} "
            f"({secs['parity_bam']:.1f} s)")

        t = time.perf_counter()
        front_kernel_phase(bench_kept, "bench")
        bench_kept = None
        secs["front_kernels"] = time.perf_counter() - t

        t = time.perf_counter()
        seqs, oris = world.read_batch(w["signal"], N_HOST_PARITY)
        geng = AlignEngine(world.load_index(w["index"]),
                           ori_chrom_names=world.header_names(w["header"]),
                           device="cuda")
        n_with = world.host_parity(geng, seqs, oris)
        secs["parity_host"] = time.perf_counter() - t
        log(f"first {N_HOST_PARITY} reads: card engine == NumPy host aligner "
            f"({n_with} reads with alignments)")

        t = time.perf_counter()
        overflow_phase(w, tmp, dev, launches)
        secs["overflow"] = time.perf_counter() - t

        t = time.perf_counter()
        uniform_phase(w, tmp, dev, launches)
        secs["uniform"] = time.perf_counter() - t

        t = time.perf_counter()
        onchip_phase(dev)
        secs["onchip"] = time.perf_counter() - t

        t = time.perf_counter()
        sv = fc_sv_phase(w, bench[CONFIGS[0][0]]["bam"], tmp, dev, launches,
                         int_ops_per_s()[0])
        secs["fc_sv"] = time.perf_counter() - t

        t = time.perf_counter()
        run_phase(tmp, dev, launches)
        secs["run"] = time.perf_counter() - t

        t = time.perf_counter()
        multi_phase(w, tmp, dev, bench, n_reads)
        secs["multi"] = time.perf_counter() - t

        t = time.perf_counter()
        chrom_phase(tmp, dev, launches)
        secs["chrom"] = time.perf_counter() - t

        t = time.perf_counter()
        genome_phase(tmp, dev, launches)
        secs["genome"] = time.perf_counter() - t

    # phase 16
    for path, counts in launches.items():
        for k in ("extd2_fwd", "extd2_tb"):
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on path {path}")
    host_collect = f"bench_{CONFIGS[1][0]}"
    for path, counts in launches.items():
        fc_sv_only = path == "fc_sv" or path.endswith("_fc_sv")
        for k in FRONT_ENTRIES:
            if fc_sv_only and counts[k]:
                raise AssertionError(f"{k} was launched on path {path}")
            if not fc_sv_only and counts[k] <= 0 and not (
                    k == "pansvr_collect" and path == host_collect):
                raise AssertionError(f"{k} was not launched on path {path}")
    total = {k: sum(c[k] for c in launches.values())
             for k in ("extd2_fwd", "extd2_tb", *FRONT_ENTRIES)}
    log(f"kernel launches per counted path: {launches}; in all {total}")
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
    per_pass = per_pass_ms(rows, LAUNCH_SHAPES[f"bench_{CONFIGS[0][0]}"],
                           N_TIMED, CONFIGS[0][0])
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
         "per_pass_ms": per_pass["extd2_fwd"],
         "fc_sv_launches": launches["fc_sv"]["extd2_fwd"],
         "chrom_launches": launches["chrom"]["extd2_fwd"],
         "chrom_fc_sv_launches": launches["chrom_fc_sv"]["extd2_fwd"],
         "genome_launches": launches["genome"]["extd2_fwd"],
         "genome_fc_sv_launches": launches["genome_fc_sv"]["extd2_fwd"],
         "fc_sv_kernel_ms": sv["first"]["fwd_kernel_ms"]},
        {"name": "extd2_tb", "route": "cuda",
         "source": "pansvr_tpu_torch/csrc/extd2_tb.cu",
         "replaces": "pansvr_tpu/ops/extd2_pallas.py:484",
         "launches": main_launches["extd2_tb"],
         "max_abs_err": max(r["tb_err"] for r in rows),
         "ms": main_row["tb_ms"], "kernel_ms": main_row["tb_kernel_ms"],
         "plain_ms": main_row["tb_plain_ms"],
         "bound_ms": main_row["tb_bound_ms"],
         "bound_by": main_row["tb_bound_by"], "library_ms": None,
         "per_pass_ms": per_pass["extd2_tb"],
         "fc_sv_launches": launches["fc_sv"]["extd2_tb"],
         "chrom_launches": launches["chrom"]["extd2_tb"],
         "chrom_fc_sv_launches": launches["chrom_fc_sv"]["extd2_tb"],
         "genome_launches": launches["genome"]["extd2_tb"],
         "genome_fc_sv_launches": launches["genome_fc_sv"]["extd2_tb"],
         "fc_sv_kernel_ms": sv["first"]["tb_kernel_ms"]},
        *front_kernel_rows(launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
